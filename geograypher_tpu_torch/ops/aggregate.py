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
    number of finite pixel values per face.
    """
    if image.ndim == 2:
        image = image[..., None]
    c = image.shape[-1]
    flat_face = pix2face.reshape(-1).long()
    flat_img = image.reshape(-1, c).to(torch.float32)
    finite = torch.isfinite(flat_img)
    hit = (flat_face >= 0)[:, None] & finite
    vals = torch.where(hit, flat_img, 0.0)
    # background pixels go to segment n_faces, which is dropped
    seg = torch.where(flat_face >= 0, flat_face, n_faces)
    zeros = torch.zeros((n_faces + 1, c), dtype=torch.float32,
                        device=image.device)
    sums = zeros.index_add(0, seg, vals)[:-1]
    counts = zeros.index_add(0, seg, hit.to(torch.float32))[:-1]
    return sums, counts


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
