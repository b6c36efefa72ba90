"""aggregate_images: project per-image predictions onto the mesh.

Port of ``geograypher_tpu/entrypoints/aggregate_images.py``:
MetashapeCameraSet (+ subsetting) -> LookUpSegmentor-wrapped cameras ->
one of three routes, as in the JAX package -> per-face argmax, NaN for
faces no view saw.  The routes: camera clusters, one buffered sub-mesh
each (``meshes/chunked.py``), when ``n_aggregation_clusters`` or
``n_cameras_per_aggregation_cluster`` is given; else, on a CUDA device of
a machine with more than one card, the survey pipeline over every card
(``parallel/pipeline.py``); else ``TexturedMesh.aggregate_projected_images``
on ``device`` (the planned route for large one-hot surveys).  The
predicted classes export as exact per-class polygons.  With a DTM, faces
whose vertices lie less than ``height_above_ground_threshold`` above it
are relabelled to a ground class (``TexturedMesh.label_ground_class``).
"""

from __future__ import annotations

import argparse
import json
import typing

import numpy as np
import torch

from geograypher_tpu_torch.predictors.segmentors import LookUpSegmentor
from geograypher_tpu_torch.utils.files import ensure_containing_folder
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.meshes.chunked import aggregate_images_chunked
from geograypher_tpu_torch.meshes.mesh import DEFAULT_RASTER_CONFIG, TexturedMesh
from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value
from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.parallel.pipeline import aggregate_class_images_distributed


def aggregate_images(
    mesh_file: PATH_TYPE,
    cameras_file: PATH_TYPE,
    image_folder: PATH_TYPE,
    label_folder: PATH_TYPE,
    mesh_CRS: typing.Optional[int] = None,
    original_image_folder: typing.Optional[PATH_TYPE] = None,
    subset_images_folder: typing.Optional[PATH_TYPE] = None,
    filename_regex: typing.Optional[str] = None,
    take_every_nth_camera: typing.Optional[int] = 100,
    DTM_file: typing.Optional[PATH_TYPE] = None,
    height_above_ground_threshold: float = 2.0,
    ROI: typing.Optional[PATH_TYPE] = None,
    ROI_buffer_radius_meters: float = 50,
    IDs_to_labels: typing.Union[dict, str, None] = None,
    mesh_downsample: float = 1.0,
    n_classes: typing.Optional[int] = None,
    n_aggregation_clusters: typing.Optional[int] = None,
    n_cameras_per_aggregation_cluster: typing.Optional[int] = None,
    aggregate_image_scale: float = 1.0,
    aggregated_face_values_savefile: typing.Optional[PATH_TYPE] = None,
    predicted_face_classes_savefile: typing.Optional[PATH_TYPE] = None,
    top_down_vector_projection_savefile: typing.Optional[PATH_TYPE] = None,
    vis: bool = False,
    raster_config: typing.Optional[RasterConfig] = None,
    device="cuda",
):
    """Aggregate per-image labels from multiple viewpoints onto the mesh.

    Arguments as in ``geograypher_tpu.entrypoints.aggregate_images``;
    ``device`` is where the per-view work runs; the route is chosen as the
    module docstring says.  On the mesh's route a survey of one-hot label
    images past ``TexturedMesh._PLANNED_MIN_PIXELS`` takes the planned
    route (``parallel/planner.py``), which sizes each view's tile-list
    caps from a census and re-runs a view that overflows them.  The
    optional ``raster_config`` gives the binning geometry, and the caps of
    a streaming run (a smaller survey, or other images), where a view that
    overflows raises after the last view.  Returns (predicted_face_classes
    (F,), average_projections (F, C)).
    """
    del vis
    if isinstance(IDs_to_labels, str):
        with open(IDs_to_labels) as fh:
            IDs_to_labels = {int(k): v for k, v in json.load(fh).items()}

    camera_set = MetashapeCameraSet(
        cameras_file,
        image_folder,
        original_image_folder=original_image_folder,
        validate_images=True,
    )
    if subset_images_folder is not None:
        camera_set = camera_set.get_subset_by_folder(subset_images_folder)
    if filename_regex is not None:
        camera_set = camera_set.get_subset_by_regex(filename_regex)
    if take_every_nth_camera is not None:
        camera_set = camera_set.get_subset_every_nth(take_every_nth_camera)
    if ROI is not None:
        camera_set = camera_set.get_subset_ROI(ROI, ROI_buffer_radius_meters)

    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=cameras_file,
        ROI=ROI,
        ROI_buffer_meters=ROI_buffer_radius_meters,
        IDs_to_labels=IDs_to_labels,
        raster_config=raster_config or DEFAULT_RASTER_CONFIG,
        device=device,
    )
    if n_classes is None:
        n_classes = len(IDs_to_labels) if IDs_to_labels else 10
    segmentor = LookUpSegmentor(
        base_folder=image_folder,
        lookup_folder=label_folder,
        num_classes=n_classes,
    )
    seg_cameras = SegmentorCameraSet(camera_set, segmentor)
    if n_aggregation_clusters is None and n_cameras_per_aggregation_cluster:
        n_aggregation_clusters = max(
            len(camera_set) // n_cameras_per_aggregation_cluster, 1
        )
    if (n_aggregation_clusters is None and mesh.device.type == "cuda"
            and torch.cuda.device_count() > 1):
        # more than one card: views dealt over all of them, loading and
        # uploads overlapped with the kernels
        frac_sums, views = aggregate_class_images_distributed(
            mesh, seg_cameras, n_classes=n_classes,
            aggregate_img_scale=aggregate_image_scale,
        )
        with np.errstate(invalid="ignore", divide="ignore"):
            average_projections = frac_sums / views[:, None]
        average_projections[views == 0] = np.nan
        info = {"projection_counts": views, "summed_projections": frac_sums}
    elif n_aggregation_clusters is not None:
        average_projections, info = aggregate_images_chunked(
            mesh, seg_cameras, n_clusters=n_aggregation_clusters,
            aggregate_img_scale=aggregate_image_scale,
        )
    else:
        average_projections, info = mesh.aggregate_projected_images(
            seg_cameras, aggregate_img_scale=aggregate_image_scale
        )

    if aggregated_face_values_savefile is not None:
        ensure_containing_folder(aggregated_face_values_savefile)
        np.save(aggregated_face_values_savefile, average_projections)

    predicted_face_classes = find_argmax_nonzero_value(
        torch.as_tensor(np.nan_to_num(average_projections), dtype=torch.float32)
    ).numpy()
    # faces never observed stay NaN
    predicted_face_classes[info["projection_counts"] == 0] = np.nan

    if DTM_file is not None:
        # faces -> vertices, near-ground vertices to the ground class (the
        # next id after the named classes, NaN without names), back to faces
        mesh.set_texture(predicted_face_classes, is_vertex=False)
        mesh.set_texture(mesh.get_texture(request_vertex_texture=True),
                         is_vertex=True)
        mesh.label_ground_class(
            DTM_file,
            height_above_ground_threshold=height_above_ground_threshold,
            ground_ID=np.nan if IDs_to_labels is None else len(IDs_to_labels),
        )
        predicted_face_classes = mesh.vert_to_face_texture()[:, 0]

    if predicted_face_classes_savefile is not None:
        ensure_containing_folder(predicted_face_classes_savefile)
        np.save(predicted_face_classes_savefile, predicted_face_classes)
    if top_down_vector_projection_savefile is not None:
        mesh.export_face_labels_vector(
            predicted_face_classes,
            export_file=top_down_vector_projection_savefile,
        )
    return predicted_face_classes, average_projections


def parse_args():
    parser = argparse.ArgumentParser(
        description=aggregate_images.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--cameras-file", required=True)
    parser.add_argument("--image-folder", required=True)
    parser.add_argument("--label-folder", required=True)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--original-image-folder", default=None)
    parser.add_argument("--subset-images-folder", default=None)
    parser.add_argument("--filename-regex", default=None)
    parser.add_argument("--take-every-nth-camera", type=int, default=100)
    parser.add_argument("--DTM-file", default=None)
    parser.add_argument("--height-above-ground-threshold", type=float, default=2.0)
    parser.add_argument("--ROI", default=None)
    parser.add_argument("--ROI-buffer-radius-meters", type=float, default=50)
    parser.add_argument("--IDs-to-labels", default=None)
    parser.add_argument("--mesh-downsample", type=float, default=1.0)
    parser.add_argument("--n-classes", type=int, default=None)
    parser.add_argument("--n-aggregation-clusters", type=int, default=None)
    parser.add_argument("--n-cameras-per-aggregation-cluster", type=int,
                        default=None)
    parser.add_argument("--aggregate-image-scale", type=float, default=1.0)
    parser.add_argument("--aggregated-face-values-savefile", default=None)
    parser.add_argument("--predicted-face-classes-savefile", default=None)
    parser.add_argument("--top-down-vector-projection-savefile", default=None)
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    aggregate_images(**vars(parse_args()))
