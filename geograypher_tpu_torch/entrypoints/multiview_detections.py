"""multiview_detections: triangulate per-image detections into 3D object
locations.

Port of ``geograypher_tpu/entrypoints/multiview_detections.py``
(reference multiview_detections.py:183-321), same argument surface plus
``device``: covering meshes from the scene mesh -> detection rays per
camera -> ray clipping between them (``ops/raycast.py``) ->
pairwise-intersection graph (``ops/triangulate.py``) -> the port's seeded
Louvain (``utils/louvain.py``) -> per-community 3D points, exported as
geospatial points with an ``altitude`` column.
"""

from __future__ import annotations

import argparse
import typing

import numpy as np

from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.predictors.segmentors import RegionDetectionSegmentor
from geograypher_tpu_torch.utils.device import resolve_device
from geograypher_tpu_torch.utils.vector import VectorData


def multiview_detections(
    mesh_file: PATH_TYPE,
    cameras_file: PATH_TYPE,
    image_folder: PATH_TYPE,
    detections_folder: PATH_TYPE,
    mesh_CRS: typing.Optional[int] = None,
    original_image_folder: typing.Optional[PATH_TYPE] = None,
    ray_length_meters: float = 200.0,
    limit_ray_length_meters: typing.Optional[float] = None,
    limit_angle_from_vert: typing.Optional[float] = None,
    similarity_threshold_meters: float = 0.5,
    louvain_resolution: float = 1.0,
    covering_mesh_N: int = 50,
    covering_z_buffer: tuple = (5.0, -5.0),
    out_dir: typing.Optional[PATH_TYPE] = None,
    triangulated_points_savefile: typing.Optional[PATH_TYPE] = None,
    vis: bool = False,
    device="cuda",
    stats: typing.Optional[dict] = None,
) -> np.ndarray:
    """Triangulate detections across views -> (M, 3) lat/lon/alt points
    (reference multiview_detections.py:183-303).

    Arguments as in ``geograypher_tpu.entrypoints.multiview_detections``.
    ``device`` is where the rays, the clip and the pairwise blocks run
    (the card by default; raises without one).  ``stats``, when given,
    gets each stage's seconds (``CameraSet.triangulate_detections``).
    """
    del vis
    device = resolve_device(device, "multiview_detections")
    camera_set = MetashapeCameraSet(
        cameras_file,
        image_folder,
        original_image_folder=original_image_folder,
        validate_images=False,
    )
    mesh = TexturedMesh(
        mesh_file, CRS=mesh_CRS, transform_filename=cameras_file, device=device
    )
    # covering meshes in the cameras' local frame (reference :256-262)
    top, bottom = mesh.export_covering_meshes(
        N=covering_mesh_N,
        z_buffer=covering_z_buffer,
        frame_transform=camera_set.get_local_to_epsg_4978_transform(),
    )
    detector = RegionDetectionSegmentor(detections_folder, image_folder)

    points = camera_set.triangulate_detections(
        detector,
        ray_length_meters=ray_length_meters,
        boundaries=(top, bottom),
        limit_ray_length_meters=limit_ray_length_meters,
        limit_angle_from_vert=limit_angle_from_vert,
        similarity_threshold_meters=similarity_threshold_meters,
        louvain_resolution=louvain_resolution,
        out_dir=out_dir,
        device=device,
        stats=stats,
    )

    if triangulated_points_savefile is not None and len(points):
        # points are (lat, lon, alt); GeoJSON expects (lon, lat)
        vd = VectorData(
            [np.array([p[1], p[0]]) for p in points],
            {"altitude": [float(p[2]) for p in points]},
            epsg=4326,
        )
        vd.to_file(triangulated_points_savefile)
    return points


def parse_args():
    parser = argparse.ArgumentParser(
        description=multiview_detections.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--cameras-file", required=True)
    parser.add_argument("--image-folder", required=True)
    parser.add_argument("--detections-folder", required=True)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--ray-length-meters", type=float, default=200.0)
    parser.add_argument("--similarity-threshold-meters", type=float, default=0.5)
    parser.add_argument("--louvain-resolution", type=float, default=1.0)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--triangulated-points-savefile", default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    multiview_detections(**vars(parse_args()))
