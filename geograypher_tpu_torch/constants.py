"""Constants the port's main path reads (values of
``geograypher_tpu/constants.py``, kept here so the path needs nothing of
the JAX package)."""

from pathlib import Path
from typing import Union

PATH_TYPE = Union[str, Path]

LAT_LON_EPSG = 4326
EARTH_CENTERED_EARTH_FIXED_EPSG = 4978

EXAMPLE_INTRINSICS = {
    "f": 1000.0,
    "cx": 0.0,
    "cy": 0.0,
    "image_width": 800,
    "image_height": 600,
}
