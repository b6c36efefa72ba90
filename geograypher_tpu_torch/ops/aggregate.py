"""Gather/scatter ops: render textures into views, project views onto faces.

Port of ``geograypher_tpu/ops/aggregate.py``.  A face's per-view value is
the mean over all its covering pixels; cross-view aggregation averages
the per-view values over the views that saw the face (NaN where none
did), like the reference's nansum / count.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from geograypher_tpu_torch.ops.face_counts import face_class_counts
from geograypher_tpu_torch.ops.face_sums import face_sums
from geograypher_tpu_torch.utils.device import resolve_device


def render_texture(
    pix2face: torch.Tensor,
    face_texture: torch.Tensor,
    background: float = float("nan"),
) -> torch.Tensor:
    """Gather (F, C) per-face texture into an (..., H, W, C) image."""
    tex = face_texture[pix2face.clamp(min=0).long()]
    fill = torch.full((), background, dtype=tex.dtype, device=tex.device)
    return torch.where((pix2face >= 0)[..., None], tex, fill)


def project_image_to_faces(
    pix2face: torch.Tensor,
    image: torch.Tensor,
    n_faces: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one view's pixels onto mesh faces.

    Args:
        pix2face: (H, W) int32.
        image: (H, W) or (H, W, C) pixel values; NaNs are ignored.

    Returns (sums, counts), each (n_faces, C) float32: the sum and the
    number of finite pixel values per face.  The sums run in a fixed order
    (:func:`~geograypher_tpu_torch.ops.face_sums.face_sums` with the
    image's shape, the ``face_sums`` kernels on the card): a face's pixels
    within each 32 x 32 tile in row-major order, then its per-tile partial
    sums in row-major tile order.  So they are the same bits on every run
    and on every device.
    """
    if image.ndim == 2:
        image = image[..., None]
    c = image.shape[-1]
    flat_img = image.reshape(-1, c).to(torch.float32).contiguous()
    sums, counts = face_sums(pix2face.reshape(-1), flat_img, n_faces,
                             shape=tuple(pix2face.shape) if pix2face.ndim == 2 else None)
    return sums, counts.to(torch.float32)


def project_image_class_counts(
    pix2face: torch.Tensor,
    class_image: torch.Tensor,
    n_faces: int,
    n_classes: int,
) -> torch.Tensor:
    """(n_faces, n_classes) float32 per-face per-class pixel counts of a
    discrete label image; pixels with class < 0 or face -1 are ignored.
    Runs the counts kernel on CUDA tensors."""
    if n_faces * n_classes + 1 >= 2**31:
        # kept for parity with the JAX package, whose flattened
        # (face, class) ids ride int32
        raise ValueError(
            f"n_faces * n_classes = {n_faces * n_classes} overflows the "
            "int32 flattened segment index — aggregate class subsets in "
            "chunks"
        )
    counts = face_class_counts(
        pix2face.to(torch.int32).contiguous(),
        class_image.to(torch.int32).contiguous(),
        n_faces,
        n_classes,
    )
    return counts.to(torch.float32)


class AggregationState(NamedTuple):
    """Running cross-view accumulators."""

    value_sum: torch.Tensor  # (F, C) sum over views of per-view means
    view_count: torch.Tensor  # (F,) number of views that saw each face


def init_aggregation(
    n_faces: int, n_channels: int, device="cuda"
) -> AggregationState:
    """Zeroed accumulators on ``device``: the card by default (raises
    without one); pass ``device="cpu"`` for CPU work."""
    device = resolve_device(device, "init_aggregation")
    return AggregationState(
        value_sum=torch.zeros((n_faces, n_channels), dtype=torch.float32,
                              device=device),
        view_count=torch.zeros((n_faces,), dtype=torch.float32, device=device),
    )


def accumulate_view(
    state: AggregationState, sums: torch.Tensor, counts: torch.Tensor
) -> AggregationState:
    """Fold one view's per-face (sums, counts) into the running state."""
    seen = (counts > 0).any(dim=1)
    mean = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), 0.0)
    return AggregationState(
        value_sum=state.value_sum + mean,
        view_count=state.view_count + seen.to(torch.float32),
    )


def finalize_aggregation(state: AggregationState) -> torch.Tensor:
    """(F, C) average projection per face; NaN where no view saw it."""
    seen = state.view_count > 0
    avg = state.value_sum / torch.clamp(state.view_count, min=1.0)[:, None]
    return torch.where(seen[:, None], avg, float("nan"))


def find_argmax_nonzero_value(
    array: torch.Tensor, keepdims: bool = False, axis: int = 1
) -> torch.Tensor:
    """Argmax with NaN rows for zero-sum or non-finite rows."""
    argmax = torch.argmax(array, dim=axis, keepdim=keepdims).to(torch.float32)
    zero_sum = array.sum(dim=axis) == 0
    non_finite = (~torch.isfinite(array)).any(dim=axis)
    bad = zero_sum | non_finite
    if keepdims:
        bad = bad.unsqueeze(axis)
    return torch.where(bad, float("nan"), argmax)


# ---------------------------------------------------------------------------
# Vertex <-> face texture conversion (votes)
# ---------------------------------------------------------------------------


def vert_to_face_discrete(
    faces: torch.Tensor, vert_labels: torch.Tensor, n_classes: int
) -> torch.Tensor:
    """Per-face mode of its 3 vertices' integer labels.

    NaN vertex labels don't vote; ties break toward the LOWEST class id.
    Returns float32 with NaN where no vertex voted.
    """
    tri_labels = vert_labels[faces.long()]  # (F, 3)
    votes = torch.stack(
        [(tri_labels == c).sum(dim=1) for c in range(n_classes)], dim=1
    ).to(torch.float32)
    has_vote = votes.sum(dim=1) > 0
    # argmax returns the first of equal maxima: the lowest class id
    winner = torch.argmax(votes, dim=1).to(torch.float32)
    return torch.where(has_vote, winner, float("nan"))


def vert_to_face_mean(faces: torch.Tensor, vert_values: torch.Tensor) -> torch.Tensor:
    """Per-face nan-mean of its 3 vertices' continuous values."""
    tri = vert_values[faces.long()]  # (F, 3, C) or (F, 3)
    if tri.ndim == 2:
        tri = tri[..., None]
    finite = torch.isfinite(tri)
    vals = torch.where(finite, tri, 0.0)
    s = vals[:, 0] + vals[:, 1] + vals[:, 2]
    n = finite.sum(dim=1)
    return torch.where(n > 0, s / torch.clamp(n, min=1), float("nan"))


def face_to_vert_texture(
    faces: torch.Tensor, face_values: torch.Tensor, n_verts: int
) -> torch.Tensor:
    """Mean of adjacent faces' values per vertex; a face whose row holds a
    non-finite value does not vote.

    The float32 sums run in a fixed order
    (:func:`~geograypher_tpu_torch.ops.face_sums.face_sums` over the (3F,)
    vertex keys): a vertex's adjacent faces in ascending face id within
    each run of 1024 keys (341 faces and a third), then the runs' partial
    sums in run order.  So two runs give the same bits, on the card as on
    the CPU.
    """
    if face_values.ndim == 1:
        face_values = face_values[:, None]
    vid = faces.reshape(-1)
    vals = face_values.to(torch.float32).repeat_interleave(3, dim=0)
    finite = torch.isfinite(vals).all(dim=-1, keepdim=True)
    vals = torch.where(finite, vals, float("nan")).contiguous()
    sums, counts = face_sums(vid, vals, n_verts)
    counts = counts[:, :1].to(torch.float32)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       float("nan"))
