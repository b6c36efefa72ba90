"""Time the port's PNG decoder (``geograypher_tpu_torch/utils/io.py``
``decode_png``) by filter type on a 2160 x 3840 uint8 label image and a
2048 x 2048 RGB chip.

Each image is encoded three ways: as the port writes it (every row filter
type 0), as PIL writes it when PIL is installed (its own choice of filter
type a row), and with rows of filter types 3 (Average) and 4 (Paeth) in
turn (``chip_smoke.encode_png_filtered``).  Prints one JSON line of median
milliseconds a decode.  Run from the repository root:

    python3 tools/png_decode_times.py [--runs 5]
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import encode_png_filtered  # noqa: E402
from geograypher_tpu_torch.utils import io as png_io  # noqa: E402


def images(seed=0):
    """A label image of 64 px class patches over a background of 255, and
    an RGB chip of smooth colours with a little noise."""
    rng = np.random.default_rng(seed)
    patches = rng.integers(0, 12, (34, 60)).astype(np.uint8)
    patches[patches >= 10] = 255
    label = np.repeat(np.repeat(patches, 64, 0), 64, 1)[:2160, :3840]
    i, j = np.mgrid[:2048, :2048]
    rgb = np.stack([128 + 100 * np.sin(i / (40 + 9 * k)) * np.cos(j / 31)
                    for k in range(3)], -1) + rng.integers(0, 6, (2048, 2048, 3))
    return {"label_2160x3840": label, "rgb_2048x2048": rgb.astype(np.uint8)}


def encodings(image):
    out = {"filters_0": png_io.encode_png(image),
           "filters_3_4": encode_png_filtered(image, 3 + np.arange(image.shape[0]) % 2)}
    try:
        from PIL import Image
    except ImportError:
        return out
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    out["pil"] = buf.getvalue()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    result = {}
    for name, image in images().items():
        result[name] = {}
        for kind, data in encodings(image).items():
            if not np.array_equal(png_io.decode_png(data), image):
                raise SystemExit(f"{name} ({kind}) decodes to other pixels")
            times = []
            for _ in range(args.runs):
                t0 = time.perf_counter()
                png_io.decode_png(data)
                times.append((time.perf_counter() - t0) * 1e3)
            result[name][kind] = round(statistics.median(times), 3)
    print(json.dumps({"decode_ms": result}))


if __name__ == "__main__":
    main()
