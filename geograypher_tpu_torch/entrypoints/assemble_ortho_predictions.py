"""assemble_ortho_predictions: thin CLI over ``predictors/ortho.py``
``assemble_tiled_predictions`` (port of
``geograypher_tpu/entrypoints/assemble_ortho_predictions.py``, the same
argument surface with its defaults read through ``inspect.signature``,
plus ``--device``)."""

from __future__ import annotations

import argparse
import inspect
from pathlib import Path

from geograypher_tpu_torch.predictors.ortho import assemble_tiled_predictions


def assemble_ortho_predictions(pred_folder, **kwargs) -> None:
    """:func:`assemble_tiled_predictions` over every file of
    ``pred_folder``, in sorted order."""
    assemble_tiled_predictions(pred_files=sorted(Path(pred_folder).glob("*")), **kwargs)


def parse_args():
    sig = inspect.signature(assemble_tiled_predictions)
    parser = argparse.ArgumentParser(
        description=assemble_tiled_predictions.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--raster-file", required=True)
    parser.add_argument("--pred-folder", required=True,
                        help="Folder of per-chip prediction files")
    parser.add_argument("--num-classes", type=int, required=True)
    parser.add_argument("--class-savefile", required=True)
    for name in ("counts_savefile",):
        parser.add_argument(f"--{name.replace('_', '-')}", default=None)
    for name in ("downweight_edge_frac",):
        parser.add_argument(
            f"--{name.replace('_', '-')}",
            type=float,
            default=sig.parameters[name].default,
        )
    parser.add_argument(
        "--nodataval", type=int, default=sig.parameters["nodataval"].default
    )
    parser.add_argument("--device", default=sig.parameters["device"].default)
    return parser.parse_args()


if __name__ == "__main__":
    assemble_ortho_predictions(**vars(parse_args()))
