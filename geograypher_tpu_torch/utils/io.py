"""Image / array reading: the port's own copy of ``read_image_or_numpy``
from ``geograypher_tpu/utils/io.py``."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE


def read_image_or_numpy(filename: PATH_TYPE) -> np.ndarray:
    """Read an image file or .npy array (reference io.py)."""
    filename = Path(filename)
    if filename.suffix.lower() == ".npy":
        return np.load(filename)
    import imageio.v3 as iio

    return np.asarray(iio.imread(filename))
