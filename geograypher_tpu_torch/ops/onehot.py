"""One-hot label scan: a segmentor's (H, W, C) image to an int32 class
image, with the count of pixels that break the one-hot rule.

:func:`onehot_to_class` computes what ``TexturedMesh._as_class_image``
computes in numpy on the host, where the image already lies on its way to
the counts kernel.  Per pixel: all ``C`` values non-finite -> class -1
(unlabeled); all finite, every value 0 or 1 (``-0.0`` passes) and exactly
one 1 -> its index; anything else -> class -1 and one violation.  The
image is an exact one-hot stack iff ``violations == 0``, which is when
``_as_class_image`` returns an array, and then the class images are equal.

On a CUDA tensor it launches the hand-written kernel
``csrc/onehot_class.cu``; on a CPU tensor it runs
:func:`onehot_to_class_plain`.

Kernel source note.  Replaces no TPU kernel: both packages ran the scan
on the host (``geograypher_tpu/meshes/mesh.py:1015``), about ten numpy
passes over the 332 MB float32 one-hot stack of a 4K view.  On the H100 it
is bound by bytes (every value read once, 4 bytes a pixel written): a
warp copies the contiguous values of 32 pixels into shared memory with
16-byte loads, then each lane scans its pixel's ``C`` values there.
"""

from __future__ import annotations

from typing import Tuple

import torch

from geograypher_tpu_torch.kernels import build

# kernel launches since the last reset (the main path's proof of use)
launches = 0

# a warp's 32 pixels must fit the shared memory one block can have
MAX_WARP_TILE_BYTES = 232448


def onehot_to_class_plain(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(class_image (H, W) int32, violations ()
    int32)`` of an (H, W, C) floating image."""
    n_classes = image.shape[-1]
    n_finite = torch.isfinite(image).sum(dim=-1)
    ones = image == 1
    onehot = ((n_finite == n_classes) & (ones | (image == 0)).all(dim=-1)
              & (ones.sum(dim=-1) == 1))
    at = ones.to(torch.uint8).argmax(dim=-1)
    cls = torch.where(onehot, at, -1).to(torch.int32)
    violations = (~onehot & (n_finite != 0)).sum().to(torch.int32)
    return cls, violations


def onehot_to_class(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(class_image (H, W) int32, violations () int32)`` of one image.

    Args:
        image: (H, W, C) float32 or float64, contiguous, ``C >= 2``.

    ``violations`` counts the pixels that are neither an exact one-hot row
    nor an all-non-finite (unlabeled) row; their class is -1.  A CUDA
    tensor launches the CUDA kernel (or raises); only a CPU tensor runs
    the plain version.
    """
    global launches
    if image.dtype not in (torch.float32, torch.float64) or image.ndim != 3:
        raise ValueError(f"image must be float32 or float64 (H, W, C), got "
                         f"{image.dtype} {tuple(image.shape)}")
    n_classes = image.shape[-1]
    if n_classes < 2:
        raise ValueError(f"a one-hot image has C >= 2 channels, got {n_classes}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    if image.device.type == "cpu":
        return onehot_to_class_plain(image)
    if image.device.type != "cuda":
        raise ValueError(f"onehot_to_class: unsupported device {image.device}")
    if 32 * n_classes * image.element_size() > MAX_WARP_TILE_BYTES:
        raise ValueError(
            f"{n_classes} channels of {image.dtype}: 32 pixels exceed a "
            f"block's shared memory ({MAX_WARP_TILE_BYTES} bytes)")
    cls = torch.empty(image.shape[:2], dtype=torch.int32, device=image.device)
    # zeroed by the C entry on the stream before its kernel
    violations = torch.empty((), dtype=torch.int32, device=image.device)
    lib = build.load()
    # launched under the tensor's device, whose stream it is given
    with torch.cuda.device(image.device):
        err = lib.gg_onehot_class(
            image.data_ptr(), cls.data_ptr(), violations.data_ptr(),
            cls.numel(), n_classes, int(image.dtype == torch.float64),
            build.stream_ptr(image.device),
        )
    build.check(err, "gg_onehot_class")
    launches += 1
    return cls, violations
