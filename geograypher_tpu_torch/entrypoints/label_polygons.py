"""label_polygons: assign classes to geospatial polygons from aggregated
per-face values.

Port of ``geograypher_tpu/entrypoints/label_polygons.py``, same argument
surface plus ``device``: per-face classes (the argmax of an aggregated
(F, C) array, NaN for faces no view saw, or a (F,) array of classes as
it is), ground faces down-weighted in the vote when a DTM is given (a
face is ground when the mean of its vertices' below-threshold flags
exceeds 0.5), then ``label_polygons_chunked``: each spatial cluster of
polygons labelled by the area-weighted vote of the faces under it, from
an orthographic render of the mesh on ``device``.  The labels are
written as the ``predicted_labels`` column of the polygons' file.
"""

from __future__ import annotations

import argparse
import typing

import numpy as np
import torch

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.meshes.chunked import label_polygons_chunked
from geograypher_tpu_torch.meshes.mesh import DEFAULT_RASTER_CONFIG, TexturedMesh
from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value, vert_to_face_mean
from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.utils.vector import VectorData


def label_polygons(
    mesh_file: PATH_TYPE,
    mesh_CRS: typing.Optional[int],
    aggregated_face_values_file: PATH_TYPE,
    geospatial_polygons_to_label: PATH_TYPE,
    geospatial_polygons_labeled_savefile: PATH_TYPE,
    transform_filename: typing.Optional[PATH_TYPE] = None,
    DTM_file: typing.Optional[PATH_TYPE] = None,
    height_above_ground_threshold: float = 2.0,
    ground_voting_weight: float = 0.01,
    ROI: typing.Optional[PATH_TYPE] = None,
    ROI_buffer_radius_meters: float = 50,
    IDs_to_labels: typing.Optional[dict] = None,
    mesh_downsample: float = 1.0,
    n_polygons_per_cluster: int = 1000,
    vis_mesh: bool = False,
    raster_config: typing.Optional[RasterConfig] = None,
    device="cuda",
    **label_kwargs,
):
    """Label polygons by area-weighted vote over aggregated face values,
    down-weighting ground faces.  Arguments as in
    ``geograypher_tpu.entrypoints.label_polygons``; ``device`` is where
    the orthographic render runs (the card by default) and
    ``raster_config`` its tile-list capacities (an overflow raises;
    ``TexturedMesh.ortho_raster_census`` sizes them); ``label_kwargs`` go
    to ``TexturedMesh.label_polygons`` (``mode``, ``resolution_m``,
    ``stats``).  Returns the labels in the polygons' order."""
    del vis_mesh
    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=transform_filename,
        ROI=ROI,
        ROI_buffer_meters=ROI_buffer_radius_meters,
        IDs_to_labels=IDs_to_labels,
        raster_config=raster_config or DEFAULT_RASTER_CONFIG,
        device=device,
    )
    aggregated = np.load(aggregated_face_values_file)
    if aggregated.ndim == 2:
        face_labels = find_argmax_nonzero_value(
            torch.as_tensor(np.nan_to_num(aggregated), dtype=torch.float32)
        ).numpy()
        face_labels[~np.isfinite(aggregated).any(axis=1)] = np.nan
    else:
        face_labels = aggregated

    face_weighting = None
    if DTM_file is not None:
        ground_verts = mesh.get_height_above_ground(
            DTM_file, threshold=height_above_ground_threshold
        )
        ground_face = vert_to_face_mean(
            torch.as_tensor(mesh.faces, dtype=torch.int64, device=mesh.device),
            torch.as_tensor(ground_verts.astype(np.float32), device=mesh.device),
        ).cpu().numpy()[:, 0]
        face_weighting = np.where(ground_face > 0.5, ground_voting_weight, 1.0)

    polygons = VectorData.read_file(geospatial_polygons_to_label)
    labels = label_polygons_chunked(
        mesh,
        face_labels,
        polygons,
        polygons_per_cluster=n_polygons_per_cluster,
        face_weighting=face_weighting,
        **label_kwargs,
    )
    polygons.attributes["predicted_labels"] = labels
    polygons.to_file(geospatial_polygons_labeled_savefile)
    return labels


def parse_args():
    parser = argparse.ArgumentParser(
        description=label_polygons.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--aggregated-face-values-file", required=True)
    parser.add_argument("--geospatial-polygons-to-label", required=True)
    parser.add_argument("--geospatial-polygons-labeled-savefile", required=True)
    parser.add_argument("--transform-filename", default=None)
    parser.add_argument("--DTM-file", default=None)
    parser.add_argument("--height-above-ground-threshold", type=float, default=2.0)
    parser.add_argument("--ground-voting-weight", type=float, default=0.01)
    parser.add_argument("--ROI", default=None)
    parser.add_argument("--ROI-buffer-radius-meters", type=float, default=50)
    parser.add_argument("--mesh-downsample", type=float, default=1.0)
    parser.add_argument("--n-polygons-per-cluster", type=int, default=1000)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    label_polygons(**vars(parse_args()))
