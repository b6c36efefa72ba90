"""Metashape camera-export parser -> the port's :class:`CameraSet`.

Port of ``geograypher_tpu/cameras/metashape.py``: parses the camera XML
(sensors, per-camera and grouped transforms, chunk -> ECEF transform),
rebases image paths, and derives per-camera lon/lat from the optimized
poses.  The XML parsing is the JAX package's numpy code, reused.
"""

from __future__ import annotations

import typing
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from geograypher_tpu.utils import crs as crs_utils
from geograypher_tpu.utils.parsing import parse_sensors, parse_transform_metashape
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.cameras.core import CameraSet


class MetashapeCameraSet(CameraSet):
    def __init__(
        self,
        camera_file: PATH_TYPE,
        image_folder: PATH_TYPE,
        original_image_folder: typing.Optional[PATH_TYPE] = None,
        validate_images: bool = False,
        default_sensor_params: typing.Optional[dict] = None,
    ):
        chunk = ET.parse(camera_file).getroot().find("chunk")
        sensors_dict = parse_sensors(
            chunk.find("sensors"),
            default_sensor_dict=(
                {"cx": 0.0, "cy": 0.0} if default_sensor_params is None
                else default_sensor_params
            ),
        )

        image_filenames, cam_to_world_transforms, sensor_IDs = [], [], []
        for cam_or_group in chunk.find("cameras"):
            members = cam_or_group if cam_or_group.tag == "group" else [cam_or_group]
            for cam in members:
                transform = cam.find("transform")
                if transform is None:  # unaligned camera
                    continue
                cam_to_world_transforms.append(
                    np.fromstring(transform.text, sep=" ").reshape(4, 4)
                )
                image_filename = Path(cam.get("label"))
                if original_image_folder is not None:
                    image_filename = image_filename.relative_to(
                        original_image_folder
                    )
                image_filenames.append(Path(image_folder, image_filename))
                sensor_IDs.append(int(cam.get("sensor_id")))

        chunk_to_epsg4978 = parse_transform_metashape(camera_file=camera_file)
        lon_lats = None
        if chunk_to_epsg4978 is not None and cam_to_world_transforms:
            locs = np.stack([t[:, 3] for t in cam_to_world_transforms], axis=0)
            ecef = (chunk_to_epsg4978 @ locs.T).T[:, :3]
            lat, lon, _ = crs_utils.ecef_to_lla(ecef[:, 0], ecef[:, 1], ecef[:, 2])
            lon_lats = list(zip(lon, lat))

        super().__init__(
            cam_to_world_transforms=cam_to_world_transforms,
            intrinsic_params_per_sensor_type=sensors_dict,
            image_filenames=image_filenames,
            lon_lats=lon_lats,
            image_folder=image_folder,
            sensor_IDs=sensor_IDs,
            validate_images=validate_images,
            local_to_epsg_4978_transform=chunk_to_epsg4978,
        )
