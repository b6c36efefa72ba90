"""How far a tiled orthographic render parts from an untiled one, and how
long the contour tracer takes, with the port alone.

Run from the repository root (on the card by default; ``--device cpu``
runs it on the CPU):

    python3 tools/ortho_tiles.py [--device cuda] [--n 200] [--res 0.0057]
                                 [--max-pixels 256] [--contours 2500]

``ortho_pix2face`` places each tile's pinhole 40 tile extents above the
tile's own centre, so a surface point's image moves between a tiled and
an untiled render.  The script renders a grid mesh of ``--n`` vertices a
side over 4 m (the bench mesh's height field ``0.1 sin 3x cos 3y``) at
``--res`` m a pixel, untiled and in tiles of at most ``--max-pixels``,
and prints the share of equal pixels and the pixels a face.  It then
times ``utils/contours.py`` ``find_contours`` on a ``--contours``-pixel
square mask of smoothed seeded noise, cut at its median.  One JSON line
each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
from scipy import ndimage

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from geograypher_tpu_torch.meshes.mesh import TexturedMesh  # noqa: E402
from geograypher_tpu_torch.ops.rasterize import RasterConfig  # noqa: E402
from geograypher_tpu_torch.utils.contours import find_contours  # noqa: E402
from geograypher_tpu_torch.utils.device import resolve_device  # noqa: E402
from geograypher_tpu_torch.utils.fixtures import make_grid_mesh  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=200)
    parser.add_argument("--res", type=float, default=0.0057)
    parser.add_argument("--max-pixels", type=int, default=256)
    parser.add_argument("--contours", type=int, default=2500)
    args = parser.parse_args()

    verts, faces = make_grid_mesh(
        n=args.n, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y))
    mesh = TexturedMesh((verts, faces), raster_config=RasterConfig(caps=(4096, 1024, 512, 512)),
                        device=resolve_device(args.device, "ortho_tiles"))
    t0 = time.perf_counter()
    untiled, _, _ = mesh.ortho_pix2face(resolution_m=args.res)
    untiled_s = time.perf_counter() - t0
    tiled, _, _ = mesh.ortho_pix2face(resolution_m=args.res, max_pixels=args.max_pixels)
    seen = untiled >= 0
    print(json.dumps({
        "shape": list(untiled.shape), "max_pixels": args.max_pixels,
        "faces": int(len(faces)), "untiled_s": round(untiled_s, 3),
        "px_per_face": round(float(seen.sum()) / len(np.unique(untiled[seen])), 3),
        "equal": float((tiled == untiled).mean()),
        "face_vs_background": int(((tiled != untiled) & ((tiled < 0) | (untiled < 0))).sum()),
    }), flush=True)

    size = args.contours
    field = ndimage.gaussian_filter(np.random.default_rng(1).random((size, size)),
                                    size / 125)
    mask = field > np.median(field)
    t0 = time.perf_counter()
    contours, _ = find_contours(mask)
    print(json.dumps({"mask": [size, size], "contours": len(contours),
                      "find_contours_s": round(time.perf_counter() - t0, 3)}), flush=True)


if __name__ == "__main__":
    main()
