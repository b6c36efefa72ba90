"""project_detections: per-image detection boxes -> per-face instance
counts -> geospatial polygons.

Port of ``geograypher_tpu/entrypoints/project_detections.py`` (reference
project_detections.py:21-230), same argument surface plus ``device`` and
``raster_config``: the detections of a folder of CSV tables painted as
per-detection rectangles (``TabularRectangleSegmentor``), every view's
pix2face, counts and ``nonzero`` on ``device``
(``meshes/sparse.py``), the sparse (faces x detections) counts saved as
an ``.npz`` CSR, and each face's most-seen detection exported as exact
polygons with a ``detection_label`` column.
"""

from __future__ import annotations

import argparse
import time
import typing

import scipy.sparse

from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.meshes.mesh import DEFAULT_RASTER_CONFIG, TexturedMesh
from geograypher_tpu_torch.meshes.sparse import (
    aggregate_index_predictions,
    sparse_argmax,
)
from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.predictors.segmentors import TabularRectangleSegmentor
from geograypher_tpu_torch.utils.files import ensure_containing_folder


def project_detections(
    mesh_file: PATH_TYPE,
    cameras_file: PATH_TYPE,
    image_folder: PATH_TYPE,
    detections_folder: PATH_TYPE,
    mesh_CRS: typing.Optional[int] = None,
    original_image_folder: typing.Optional[PATH_TYPE] = None,
    project_to_mesh: bool = True,
    projections_to_mesh_savefile: typing.Optional[PATH_TYPE] = None,
    convert_to_geospatial: bool = True,
    projections_to_geospatial_savefile: typing.Optional[PATH_TYPE] = None,
    default_focal_length_pixels: typing.Optional[float] = None,
    image_shape: typing.Tuple[int, int] = (4008, 6016),
    aggregate_image_scale: float = 0.25,
    mesh_downsample: float = 1.0,
    vis_mesh: bool = False,
    raster_config: typing.Optional[RasterConfig] = None,
    device="cuda",
    stats: typing.Optional[dict] = None,
):
    """Project tabular detections onto the mesh as sparse per-face instance
    counts, then export per-detection polygons (reference
    project_detections.py:21-191).

    Arguments as in ``geograypher_tpu.entrypoints.project_detections``.
    ``device`` is where the per-view work runs (the card by default;
    raises without one).  ``raster_config`` replaces the mesh's default
    tile-list capacities.  ``stats``, when given, gets the seconds of
    loading (``load_s``), of the views (``aggregate_s``, and under
    ``views`` one dict of stage seconds a view, ``meshes/sparse.py``), of
    the per-face argmax and the exact polygons (``export_s``) and of the
    files (``write_s``).  Returns (counts CSR or None, the polygons'
    VectorData or None).
    """
    del vis_mesh
    # the per-view stages synchronise the device only when asked for
    view_stats = None if stats is None else []
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    sensor_defaults = {"cx": 0.0, "cy": 0.0}
    if default_focal_length_pixels is not None:
        # forwarded as a sensor default for cameras files lacking
        # calibration, as the reference does
        sensor_defaults["f"] = float(default_focal_length_pixels)
    camera_set = MetashapeCameraSet(
        cameras_file,
        image_folder,
        original_image_folder=original_image_folder,
        validate_images=False,
        default_sensor_params=sensor_defaults,
    )
    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=cameras_file,
        raster_config=raster_config or DEFAULT_RASTER_CONFIG,
        device=device,
    )
    detector = TabularRectangleSegmentor(
        detections_folder, image_folder, image_shape=image_shape
    )
    seg_cameras = SegmentorCameraSet(camera_set, detector)
    t1 = time.perf_counter()
    stats.update(load_s=t1 - t0, views=view_stats)

    counts = None
    if project_to_mesh:
        counts, _faces_seen = aggregate_index_predictions(
            mesh,
            seg_cameras,
            n_classes=detector.num_classes,
            aggregate_img_scale=aggregate_image_scale,
            stats=view_stats,
        )
        t1 = time.perf_counter()
        stats["aggregate_s"] = t1 - t0 - stats["load_s"]
        if projections_to_mesh_savefile is not None:
            ensure_containing_folder(projections_to_mesh_savefile)
            scipy.sparse.save_npz(
                projections_to_mesh_savefile, counts.tocoo().tocsr()
            )

    if convert_to_geospatial and counts is not None:
        t2 = time.perf_counter()
        face_det = sparse_argmax(counts)
        vd = mesh.export_face_labels_vector(face_det)
        t3 = time.perf_counter()
        # detection metadata by detection index
        det_meta = detector.df
        names = []
        for cid in vd["class_ID"]:
            if 0 <= cid < len(det_meta):
                names.append(str(det_meta.iloc[int(cid)].get("label", cid)))
            else:
                names.append(str(cid))
        vd.attributes["detection_label"] = names
        if projections_to_geospatial_savefile is not None:
            vd.to_file(projections_to_geospatial_savefile)
        stats.update(export_s=t3 - t2,
                     write_s=time.perf_counter() - t3 + t2 - t1)
        return counts, vd
    return counts, None


def parse_args():
    parser = argparse.ArgumentParser(
        description=project_detections.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--cameras-file", required=True)
    parser.add_argument("--image-folder", required=True)
    parser.add_argument("--detections-folder", required=True)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--projections-to-mesh-savefile", default=None)
    parser.add_argument("--projections-to-geospatial-savefile", default=None)
    parser.add_argument("--aggregate-image-scale", type=float, default=0.25)
    parser.add_argument("--mesh-downsample", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    project_detections(**vars(parse_args()))
