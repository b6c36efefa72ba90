"""Louvain's resolution on chip_smoke.py phase 8's triangulation graph.

Builds phase 8's detections (the bench grid mesh, phase 7's 20 views of
the suite, seeded objects above the surface, their pinhole projections as
square regions), casts and clips their rays against the covering meshes,
builds the ray-intersection graph once, and runs the communities at each
resolution.  For each it prints one JSON line: the communities, those
holding rays of more than one object, objects with two or more rays in
no pure community of their own, the farthest community point from every
object and the Louvain seconds.

    python3 tools/detection_louvain.py [--device cuda] [--objects 300]
        [--resolutions 1 2 5 10] [--step 5000]

Run from the repository root; the card by default, ``--device cpu`` for
the CPU (with a smaller ``--step`` the graph's blocks stay small).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from geograypher_tpu_torch.ops import triangulate  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--objects", type=int, default=cs.DETECTION_OBJECTS)
    parser.add_argument("--resolutions", type=float, nargs="+",
                        default=[1.0, 2.0, 5.0, cs.DETECTION_RESOLUTION])
    parser.add_argument("--step", type=int, default=5000)
    args = parser.parse_args()

    verts, faces = cs.make_grid_mesh(
        n=708, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y))
    n_views = cs.PIPELINE_VIEWS
    sensors = {2 * d + j: {"f": fl, "cx": 0.0, "cy": 0.0, "image_width": cs.W,
                           "image_height": cs.H}
               for d in (0, 1) for j, fl in enumerate((2000.0, 2600.0))}
    cams = cs.CameraSet(cs._suite_cameras(n_views=n_views), sensors,
                        sensor_IDs=cs._suite_sensor_ids(n_views),
                        image_filenames=[f"view_{k:02d}.png" for k in range(n_views)])
    objects = cs._detection_objects(verts, faces, args.objects)
    mesh = cs.TexturedMesh((verts, faces), device=args.device)
    top, bottom = mesh.export_covering_meshes(N=50, z_buffer=cs.DETECTION_Z_BUFFER)
    with tempfile.TemporaryDirectory() as folder:
        _, regions, _, det_obj, _ = cs._write_detections(
            folder, cams, objects, cs.W, cs.H, cs.DETECTION_BOX_PX, args.device)
        rays = cams.calc_line_segments(cs.RegionDetectionSegmentor(regions),
                                       ray_length_local=200.0, device=args.device)
    starts, ends, kept = cs.clip_line_segments(
        rays["ray_starts"], rays["ray_ends"], top[0][top[1]], bottom[0][bottom[1]],
        device=args.device)
    starts, ends, ids, obj = (starts[kept], ends[kept], rays["ray_IDs"][kept],
                              det_obj[kept])
    edges = triangulate.calc_graph_weights(starts, ends, ids, cs.DETECTION_THRESHOLD_M,
                                           step=args.step, device=args.device)
    crossing = sum(obj[i] != obj[j] for i, j, _ in edges)
    full_weight = sum(obj[i] != obj[j] and w["weight"] >= 5e5 for i, j, w in edges)
    print(json.dumps(dict(objects=args.objects, rays=int(len(starts)), edges=len(edges),
                          edges_between_objects=int(crossing),
                          of_them_within_2e_6_m=int(full_weight),
                          threshold_m=cs.DETECTION_THRESHOLD_M)), flush=True)
    seen2 = np.bincount(obj, minlength=args.objects) >= 2
    for resolution in args.resolutions:
        t0 = time.perf_counter()
        res = triangulate.calc_communities(starts, ends, edges,
                                           louvain_resolution=resolution,
                                           device=args.device)
        seconds = time.perf_counter() - t0
        points, community = res["community_points"], res["ray_IDs"]
        mixed, pure_of = 0, set()
        for c in range(len(points)):
            members = set(obj[community == c].tolist())
            if len(members) > 1:
                mixed += 1
            else:
                pure_of |= members
        lost = int(sum(1 for k in np.nonzero(seen2)[0] if k not in pure_of))
        d = np.linalg.norm(points[:, None, :] - objects[None], axis=2)
        print(json.dumps(dict(
            resolution=resolution, communities=int(len(points)),
            mixed_communities=mixed, objects_without_their_own=lost,
            max_community_to_object_m=float(d.min(axis=1).max()),
            seconds=round(seconds, 4))), flush=True)


if __name__ == "__main__":
    main()
