"""Filesystem helpers: the port's own copies of ``ensure_folder`` and
``ensure_containing_folder`` from ``geograypher_tpu/utils/files.py``."""

from pathlib import Path

from geograypher_tpu_torch.constants import PATH_TYPE


def ensure_folder(folder: PATH_TYPE) -> Path:
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    return folder


def ensure_containing_folder(filename: PATH_TYPE) -> Path:
    filename = Path(filename)
    ensure_folder(filename.parent)
    return filename
