"""aggregate_images: project per-image predictions onto the mesh.

Port of the single-device path of
``geograypher_tpu/entrypoints/aggregate_images.py``:
MetashapeCameraSet (+ subsetting) -> LookUpSegmentor-wrapped cameras ->
TexturedMesh.aggregate_projected_images on ``device`` -> per-face argmax,
NaN for faces no view saw.  Clustered aggregation, ROI cropping, the DTM
ground relabel and the vector export raise ``NotImplementedError`` naming
their ROADMAP items.
"""

from __future__ import annotations

import argparse
import json
import typing

import numpy as np
import torch

from geograypher_tpu.predictors.segmentors import LookUpSegmentor
from geograypher_tpu.utils.files import ensure_containing_folder
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value


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
    device="cuda",
):
    """Aggregate per-image labels from multiple viewpoints onto the mesh.

    Arguments as in ``geograypher_tpu.entrypoints.aggregate_images``;
    ``device`` is where the per-view work runs.  Returns
    (predicted_face_classes (F,), average_projections (F, C)).
    """
    if n_aggregation_clusters is not None or n_cameras_per_aggregation_cluster:
        raise NotImplementedError(
            "clustered (chunked) aggregation is not ported yet (ROADMAP A11)"
        )
    if ROI is not None:
        raise NotImplementedError("ROI cropping is not ported yet (ROADMAP A6)")
    if DTM_file is not None:
        raise NotImplementedError(
            "the DTM ground relabel is not ported yet (ROADMAP A6)"
        )
    if top_down_vector_projection_savefile is not None:
        raise NotImplementedError(
            "the top-down vector export is not ported yet (ROADMAP A6)"
        )
    del height_above_ground_threshold, ROI_buffer_radius_meters, vis
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

    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=cameras_file,
        IDs_to_labels=IDs_to_labels,
        device=device,
    )
    if n_classes is None:
        n_classes = len(IDs_to_labels) if IDs_to_labels else 10
    segmentor = LookUpSegmentor(
        base_folder=image_folder,
        lookup_folder=label_folder,
        num_classes=n_classes,
    )
    average_projections, info = mesh.aggregate_projected_images(
        SegmentorCameraSet(camera_set, segmentor),
        aggregate_img_scale=aggregate_image_scale,
    )

    if aggregated_face_values_savefile is not None:
        ensure_containing_folder(aggregated_face_values_savefile)
        np.save(aggregated_face_values_savefile, average_projections)

    predicted_face_classes = find_argmax_nonzero_value(
        torch.as_tensor(np.nan_to_num(average_projections), dtype=torch.float32)
    ).numpy()
    # faces never observed stay NaN
    predicted_face_classes[info["projection_counts"] == 0] = np.nan

    if predicted_face_classes_savefile is not None:
        ensure_containing_folder(predicted_face_classes_savefile)
        np.save(predicted_face_classes_savefile, predicted_face_classes)
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
    parser.add_argument("--aggregate-image-scale", type=float, default=1.0)
    parser.add_argument("--aggregated-face-values-savefile", default=None)
    parser.add_argument("--predicted-face-classes-savefile", default=None)
    parser.add_argument("--top-down-vector-projection-savefile", default=None)
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    aggregate_images(**vars(parse_args()))
