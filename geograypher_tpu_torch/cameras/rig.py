"""Synthetic perspective-camera rigs from equirectangular captures.

Port of ``geograypher_tpu/cameras/rig.py``: each 360 capture's pose from
a Metashape export is fanned out over a rig of perspective cameras by
roll / pitch / yaw rotations composed on the camera side; a member's
image is the station's image stem, the rig member's suffix from the
format string, and ``.png`` (what ``utils/image.py``
``perspective_from_equirectangular`` writes per member).  The
local -> ECEF transform of the export is carried over.
"""

from __future__ import annotations

import typing
from pathlib import Path

import numpy as np

from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.numeric import rotation_rpy_to_matrix


def create_rig_cameras_from_equirectangular(
    camera_file: PATH_TYPE,
    original_images: PATH_TYPE,
    perspective_images: PATH_TYPE,
    rig_camera: typing.Dict[str, float],
    rig_orientations: typing.List[typing.Dict[str, float]],
    perspective_filename_format_str: str,
) -> CameraSet:
    """The rig camera set of a Metashape export of 360 stations.

    Args:
        camera_file: the Metashape XML of the equirectangular captures.
        original_images: the folder the XML's image labels lie in.
        perspective_images: the folder of the perspective images.
        rig_camera: the one sensor of every member (``f``, ``cx``, ``cy``,
            ``image_width``, ``image_height``).
        rig_orientations: one dict of ``roll_deg``, ``pitch_deg`` and
            ``yaw_deg`` a member.
        perspective_filename_format_str: formatted with a member's dict,
            the suffix of its image's stem.

    Returns a set of stations x members cameras, station-major.
    """
    initial = MetashapeCameraSet(
        camera_file=camera_file,
        image_folder=perspective_images,
        original_image_folder=original_images,
        default_sensor_params={"f": 1.0, "cx": 0.0, "cy": 0.0},
    )
    rig_transforms, suffixes = [], []
    for orientation in rig_orientations:
        t = np.eye(4)
        t[:3, :3] = rotation_rpy_to_matrix(
            orientation["roll_deg"], orientation["pitch_deg"], orientation["yaw_deg"]
        )
        rig_transforms.append(t)
        suffixes.append(perspective_filename_format_str.format(**orientation))
    return CameraSet(
        cam_to_world_transforms=[
            c2w @ rig_t
            for c2w in initial.cam_to_world_transforms
            for rig_t in rig_transforms
        ],
        intrinsic_params_per_sensor_type={0: dict(rig_camera)},
        image_filenames=[
            Path(fname.parent, fname.stem + suffix + ".png")
            for fname in initial.image_filenames
            for suffix in suffixes
        ],
        sensor_IDs=[0] * len(initial) * len(suffixes),
        local_to_epsg_4978_transform=initial.get_local_to_epsg_4978_transform(),
    )
