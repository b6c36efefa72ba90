"""Filesystem helpers: the port's own copy of ``ensure_containing_folder``
from ``geograypher_tpu/utils/files.py``."""

from pathlib import Path

from geograypher_tpu_torch.constants import PATH_TYPE


def ensure_containing_folder(filename: PATH_TYPE) -> Path:
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    return filename
