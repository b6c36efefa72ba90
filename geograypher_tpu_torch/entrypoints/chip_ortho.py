"""chip_ortho: thin CLI over ``predictors/ortho.py`` ``write_chips``
(port of ``geograypher_tpu/entrypoints/chip_ortho.py``, the same argument
surface)."""

from __future__ import annotations

import argparse

from geograypher_tpu_torch.predictors.ortho import write_chips

chip_ortho = write_chips


def parse_args():
    parser = argparse.ArgumentParser(
        description=write_chips.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--raster-file", required=True)
    parser.add_argument("--output-folder", required=True)
    parser.add_argument("--chip-size", type=int, default=2048)
    parser.add_argument("--chip-stride", type=int, default=2048)
    parser.add_argument("--label-vector-file", default=None)
    parser.add_argument("--label-column", default=None)
    parser.add_argument("--background-ind", type=int, default=255)
    return parser.parse_args()


if __name__ == "__main__":
    write_chips(**vars(parse_args()))
