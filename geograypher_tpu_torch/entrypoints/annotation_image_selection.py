"""determine_minimum_overlapping_images: pick a small image subset that
covers the mesh, by a greedy set cover over the faces x images visibility.

Port of ``geograypher_tpu/entrypoints/annotation_image_selection.py``
(reference annotation_image_selection.py:17-240), same argument surface
plus ``device``, ``raster_config`` and ``stats``.  The visibility comes
from ``meshes/sparse.py`` ``aggregate_index_predictions`` with an
``ImageIDSegmentor``: every view's pix2face and per-face counts at (F, 1)
on ``device``, the raster and counts kernels once a view.  The JAX code
densifies it into F x N bools (1 GB at 1M faces and 1,000 images); here
it stays a sparse matrix, and the greedy cover runs on ``device`` over
its two compressed forms (:func:`greedy_set_cover_sparse`), pick for
pick what :func:`greedy_set_cover` (the JAX loop on a dense matrix, kept
as the plain version) picks.

Without a ``raster_config`` the tile-list caps are sized by a census of
the views it rasterizes (``TexturedMesh.view_raster_census``, margined
by the planner's ``census_caps``): at the default scale 0.05 a 1M-face
mesh puts thousands of faces in one tile's list, past the default caps.  An explicit ``raster_config`` that overflows
raises; the JAX package drops that overflow silently.
"""

from __future__ import annotations

import argparse
import shutil
import time
import typing

import numpy as np
import scipy.sparse
import torch

from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.meshes.mesh import DEFAULT_RASTER_CONFIG, TexturedMesh
from geograypher_tpu_torch.meshes.sparse import aggregate_index_predictions
from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.parallel.planner import census_caps
from geograypher_tpu_torch.predictors.segmentors import ImageIDSegmentor
from geograypher_tpu_torch.utils.device import resolve_device
from geograypher_tpu_torch.utils.files import ensure_folder


def greedy_set_cover(matrix: np.ndarray) -> typing.List[int]:
    """Greedy set cover: matrix is (n_elements, n_sets) boolean; returns
    set indices covering every coverable element.  The JAX package's loop
    on a dense matrix, the plain version of
    :func:`greedy_set_cover_sparse`."""
    matrix = np.asarray(matrix, dtype=bool)
    coverable = matrix.any(axis=1)
    uncovered = coverable.copy()
    chosen = []
    while uncovered.any():
        gains = matrix[uncovered].sum(axis=0)
        best = int(np.argmax(gains))
        if gains[best] == 0:
            break
        chosen.append(best)
        uncovered &= ~matrix[:, best]
    return chosen


def greedy_set_cover_sparse(visibility, device="cuda") -> typing.List[int]:
    """:func:`greedy_set_cover` of a sparse (n_elements, n_sets) boolean
    matrix on ``device``, without densifying it.

    Each set's gain (its elements not covered yet) is kept as an int64
    count.  A pick covers its uncovered elements, and every set holding
    one of them loses one of gain for it (the matrix's rows, in CSR, list
    those sets).  ``torch.argmax`` returns the first maximum, as
    ``np.argmax`` does, so the picks are the plain version's, and the
    loop stops when no gain is left."""
    device = resolve_device(device, "greedy_set_cover_sparse")
    vis = scipy.sparse.csr_array(visibility, dtype=bool)
    vis.eliminate_zeros()
    n_sets = vis.shape[1]
    csc = vis.tocsc()

    def on(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    row_ptr, row_sets = on(vis.indptr), on(vis.indices)
    col_ptr_host = csc.indptr.astype(np.int64)
    col_elems = on(csc.indices)
    gains = on(np.diff(col_ptr_host))
    covered = torch.zeros(vis.shape[0], dtype=torch.bool, device=device)
    chosen = []
    while n_sets:
        best = torch.argmax(gains)
        best_i, gain = (int(v) for v in torch.stack([best, gains[best]]).cpu())
        if gain == 0:
            break
        chosen.append(best_i)
        elems = col_elems[col_ptr_host[best_i]:col_ptr_host[best_i + 1]]
        new = elems[~covered[elems]]
        covered[new] = True
        starts = row_ptr[new]
        lens = row_ptr[new + 1] - starts
        first = torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens), lens)
        sets = row_sets[first + torch.arange(first.numel(), device=device)]
        gains -= torch.bincount(sets, minlength=n_sets)
    return chosen


def visibility_matrix(counts, min_observations: int) -> scipy.sparse.csr_array:
    """The (faces, images) boolean CSR of ``counts >= min_observations``
    (``min_observations`` >= 1: a face no pixel of an image sees is never
    visible in it)."""
    if min_observations < 1:
        raise ValueError(f"min_observations {min_observations}: at least 1 pixel")
    vis = scipy.sparse.csr_array(scipy.sparse.csr_array(counts) >= min_observations)
    vis.eliminate_zeros()
    return vis


def determine_minimum_overlapping_images(
    mesh_file: PATH_TYPE,
    cameras_file: PATH_TYPE,
    image_folder: PATH_TYPE,
    mesh_CRS: typing.Optional[int] = None,
    original_image_folder: typing.Optional[PATH_TYPE] = None,
    take_every_nth_camera: int = 1,
    aggregate_image_scale: float = 0.05,
    mesh_downsample: float = 1.0,
    min_observations: int = 1,
    selected_images_savefolder: typing.Optional[PATH_TYPE] = None,
    selected_images_mask_savefile: typing.Optional[PATH_TYPE] = None,
    raster_config: typing.Optional[RasterConfig] = None,
    device="cuda",
    stats: typing.Optional[dict] = None,
) -> typing.List[int]:
    """Select a small image set seeing every visible face (reference
    annotation_image_selection.py:17-202).

    Arguments as in the JAX package's function.  ``device`` is where the
    per-view work and the greedy cover run (the card by default; raises
    without one); ``raster_config`` replaces the mesh's default tile-list
    capacities (without it, a census of the views sizes them).
    ``stats``, when given, gets the seconds of loading (``load_s``, the
    census included), of the views (``aggregate_s``, and under ``views``
    one dict of stage seconds a view) and of the cover (``greedy_s``), the
    caps the run used (``caps``), the count of seen faces
    (``seen_faces``) and the (faces, images) visibility CSR
    (``visibility``).  Returns the chosen camera indices.
    """
    view_stats = None if stats is None else []
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    camera_set = MetashapeCameraSet(
        cameras_file,
        image_folder,
        original_image_folder=original_image_folder,
        validate_images=False,
    )
    if take_every_nth_camera > 1:
        camera_set = camera_set.get_subset_every_nth(take_every_nth_camera)
    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=cameras_file,
        raster_config=raster_config or DEFAULT_RASTER_CONFIG,
        device=device,
    )
    sensor = camera_set.sensors[camera_set.sensor_IDs[0]]
    segmentor = ImageIDSegmentor(
        image_shape=(sensor["image_height"], sensor["image_width"]),
        num_images=len(camera_set),
    )
    seg_cameras = SegmentorCameraSet(camera_set, segmentor)
    if raster_config is None:
        mesh.raster_config = census_caps(
            mesh.view_raster_census(camera_set, aggregate_image_scale),
            mesh.raster_config)
    t1 = time.perf_counter()
    # faces x images visibility counts (reference :100-117)
    counts, _ = aggregate_index_predictions(
        mesh,
        seg_cameras,
        n_classes=len(camera_set),
        aggregate_img_scale=aggregate_image_scale,
        check_null_image=False,
        stats=view_stats,
    )
    visibility = visibility_matrix(counts, min_observations)
    t2 = time.perf_counter()
    chosen = greedy_set_cover_sparse(visibility, device=mesh.device)
    t3 = time.perf_counter()
    stats.update(load_s=t1 - t0, aggregate_s=t2 - t1, greedy_s=t3 - t2,
                 caps=tuple(mesh.raster_config.caps),
                 views=view_stats, visibility=visibility,
                 seen_faces=int((np.diff(visibility.indptr) > 0).sum()))

    if selected_images_mask_savefile is not None:
        mask = np.zeros(len(camera_set), dtype=bool)
        mask[chosen] = True
        np.save(selected_images_mask_savefile, mask)
    if selected_images_savefolder is not None:
        ensure_folder(selected_images_savefolder)
        for i in chosen:
            src = camera_set.get_image_filename(i)
            if src is not None and src.exists():
                shutil.copy(src, selected_images_savefolder)
    return chosen


def parse_args():
    parser = argparse.ArgumentParser(
        description=determine_minimum_overlapping_images.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--cameras-file", required=True)
    parser.add_argument("--image-folder", required=True)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--take-every-nth-camera", type=int, default=1)
    parser.add_argument("--aggregate-image-scale", type=float, default=0.05)
    parser.add_argument("--mesh-downsample", type=float, default=1.0)
    parser.add_argument("--min-observations", type=int, default=1)
    parser.add_argument("--selected-images-savefolder", default=None)
    parser.add_argument("--selected-images-mask-savefile", default=None)
    parser.add_argument("--original-image-folder", default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    determine_minimum_overlapping_images(**vars(parse_args()))
