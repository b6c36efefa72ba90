"""COLMAP text-export parser -> the port's :class:`CameraSet`.

Port of ``geograypher_tpu/cameras/colmap.py`` with a text parser of its
own in place of pandas.  The lines read are the ones the JAX class's
``pandas.read_csv`` calls read:

* ``cameras.txt``: every line after the first three (COLMAP's header),
  blank lines skipped;
* ``images.txt``: lines 0-3 (the header) and every odd line (the POINTS2D
  rows, never parsed) are skipped by their raw line number, then blank
  lines; so an image with no points, whose POINTS2D line COLMAP writes
  empty, maps as the JAX class maps it.

Fields are split on single spaces and the first ten of an image line are
read.  Only ``SIMPLE_RADIAL`` is supported (any other model raises
``NotImplementedError``): cx and cy are measured from the image centre
(``PARAMS_CX - WIDTH / 2``) and the radial term goes into the
Brown-Conrady ``k1`` slot.  The world -> camera quaternion and translation
are inverted in float64.  Floats are parsed correctly rounded (Python's
``float``); pandas' parser is off by one ulp on some 17-digit values, so
poses agree with the JAX class to 1e-12, not bit for bit.
"""

from __future__ import annotations

import typing
from pathlib import Path

import numpy as np

from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.numeric import quaternion_wxyz_to_matrix

CAMERAS_HEADER_LINES = 3
IMAGES_HEADER_LINES = 4
IMAGE_FIELDS = 10  # IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME


def _raw_lines(path: PATH_TYPE) -> typing.List[str]:
    """The file's lines by raw line number (``\\n`` or ``\\r\\n`` ends)."""
    return [ln[:-1] if ln.endswith("\r") else ln
            for ln in Path(path).read_text().split("\n")]


def read_cameras_txt(path: PATH_TYPE) -> typing.Dict[int, dict]:
    """``cameras.txt`` -> {camera id: the sensor dict of a CameraSet}."""
    sensors = {}
    for line in _raw_lines(path)[CAMERAS_HEADER_LINES:]:
        if not line:
            continue
        fields = line.split(" ")
        if len(fields) < 2 or fields[1] != "SIMPLE_RADIAL":
            raise NotImplementedError("Not a supported camera model")
        cam_id, _, width, height, f, cx, cy, radial = fields[:8]
        width, height = int(width), int(height)
        sensors[int(cam_id)] = {
            "image_width": width,
            "image_height": height,
            "f": float(f),
            "cx": float(cx) - width / 2,
            "cy": float(cy) - height / 2,
            "distortion_params": {"k1": float(radial)},
        }
    return sensors


def read_images_txt(path: PATH_TYPE):
    """``images.txt`` -> (cam-to-world 4x4s, camera ids, image names)."""
    cam_to_world, camera_ids, names = [], [], []
    for number, line in enumerate(_raw_lines(path)):
        if number < IMAGES_HEADER_LINES or number % 2 or not line:
            continue
        fields = line.split(" ")
        if len(fields) < IMAGE_FIELDS:
            raise ValueError(f"{path}:{number + 1}: {len(fields)} fields, an image "
                             f"line has {IMAGE_FIELDS}")
        qw, qx, qy, qz, tx, ty, tz = (float(v) for v in fields[1:8])
        world_to_cam = np.eye(4)
        world_to_cam[:3, :3] = quaternion_wxyz_to_matrix((qw, qx, qy, qz))
        world_to_cam[:3, 3] = (tx, ty, tz)
        cam_to_world.append(np.linalg.inv(world_to_cam))
        camera_ids.append(int(fields[8]))
        names.append(fields[9])
    return cam_to_world, camera_ids, names


class COLMAPCameraSet(CameraSet):
    def __init__(
        self,
        cameras_file: PATH_TYPE,
        images_file: PATH_TYPE,
        image_folder: typing.Union[None, PATH_TYPE] = None,
        validate_images: bool = False,
    ):
        sensors = read_cameras_txt(cameras_file)
        cam_to_world, camera_ids, names = read_images_txt(images_file)
        super().__init__(
            cam_to_world_transforms=cam_to_world,
            intrinsic_params_per_sensor_type=sensors,
            image_filenames=[
                Path(image_folder, name) if image_folder is not None else None
                for name in names
            ],
            sensor_IDs=camera_ids,
            image_folder=image_folder,
            validate_images=validate_images,
        )
