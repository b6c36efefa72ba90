"""Per-face per-class pixel counts: the counts kernel's wrapper and its
plain version.

:func:`face_class_counts` turns one view's pix2face and class image into
dense int32 (F, C) counts.  On a CUDA tensor it launches the hand-written
kernel ``csrc/face_class_counts.cu``; on a CPU tensor it runs
:func:`face_class_counts_plain`, a ``torch.bincount`` over the flattened
(face, class) id.

Kernel source note.  Replaces the TPU face-block folds
``geograypher_tpu/ops/agg_tiled.py`` ``face_counts_from_tiles`` (B3) and
``_face_counts_units`` (B2), whose tile entries, windows and digit planes
work around slow TPU scatters (``agg_tiled.py:5-10``).  On the H100 the
counts are int32 atomics into the (F, C) table, exact and identical from
run to run, merged before they are issued: a warp takes an 8 x 4 pixel
patch, groups the lanes of equal ``f * C + c`` with ``__match_any_sync``
and adds each group's size once.  It is bound by bytes (the table's zero
fill here, 8 bytes a pixel read, the table written back) and, on labels
that differ from pixel to pixel, by the L2's atomic rate.
"""

from __future__ import annotations

import torch

from geograypher_tpu_torch.kernels import build

# kernel launches since the last reset (the main path's proof of use)
launches = 0


def face_class_counts_plain(
    pix2face: torch.Tensor,
    class_image: torch.Tensor,
    n_faces: int,
    n_classes: int,
) -> torch.Tensor:
    """Plain PyTorch counts: bincount of ``face * n_classes + class``."""
    f = pix2face.reshape(-1).long()
    c = class_image.reshape(-1).long()
    ok = (f >= 0) & (f < n_faces) & (c >= 0) & (c < n_classes)
    flat = torch.bincount((f * n_classes + c)[ok], minlength=n_faces * n_classes)
    return flat.to(torch.int32).reshape(n_faces, n_classes)


def face_class_counts(
    pix2face: torch.Tensor,
    class_image: torch.Tensor,
    n_faces: int,
    n_classes: int,
) -> torch.Tensor:
    """(n_faces, n_classes) int32 pixel counts of one view.

    Args:
        pix2face: (H, W) int32 face ids, -1 for background.
        class_image: (H, W) int32 class ids; pixels with a class outside
            ``[0, n_classes)`` are ignored.

    A CUDA tensor launches the CUDA kernel (or raises); only a CPU tensor
    runs the plain version.
    """
    global launches
    for name, t in (("pix2face", pix2face), ("class_image", class_image)):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be int32 (H, W), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if class_image.shape != pix2face.shape:
        raise ValueError(f"class_image {tuple(class_image.shape)} != pix2face "
                         f"{tuple(pix2face.shape)}")
    if class_image.device != pix2face.device:
        raise ValueError(f"class_image is on {class_image.device}, pix2face "
                         f"on {pix2face.device}")
    if n_faces < 0 or n_classes < 1:
        raise ValueError(f"need n_faces >= 0 and n_classes >= 1, got "
                         f"{n_faces}, {n_classes}")
    if pix2face.device.type == "cpu":
        return face_class_counts_plain(pix2face, class_image, n_faces,
                                       n_classes)
    if pix2face.device.type != "cuda":
        raise ValueError(f"face_class_counts: unsupported device "
                         f"{pix2face.device}")
    counts = torch.zeros((n_faces, n_classes), dtype=torch.int32,
                         device=pix2face.device)
    lib = build.load()
    # launched under the tensor's device, whose stream it is given
    with torch.cuda.device(pix2face.device):
        err = lib.gg_face_class_counts(
            pix2face.data_ptr(), class_image.data_ptr(), counts.data_ptr(),
            pix2face.shape[0], pix2face.shape[1], n_faces, n_classes,
            build.stream_ptr(pix2face.device),
        )
    build.check(err, "gg_face_class_counts")
    launches += 1
    return counts
