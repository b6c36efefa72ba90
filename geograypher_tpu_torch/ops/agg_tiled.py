"""Per-face class counts from a finished pix2face.

Port of ``geograypher_tpu/ops/agg_tiled.py``
``project_image_class_counts_tiled``: the unfused path that counts a
cached or separately rendered pix2face against a class image.  On the
TPU it runs the stage-1 kernel ``tile_class_counts`` (per-tile (class,
slot) counts) and then the face-block folds, a scatter-free route around
slow TPU scatters.  On the H100 the counts kernel
(``csrc/face_class_counts.cu``, int32 atomics) computes the same
(F, C) counts from the pix2face in one launch.
"""

from __future__ import annotations

import torch

from geograypher_tpu_torch.ops.aggregate import project_image_class_counts


def project_image_class_counts_tiled(
    p2f: torch.Tensor,
    class_image: torch.Tensor,
    binned,
    config,
    image_h: int,
    image_w: int,
    n_faces: int,
    n_classes: int,
):
    """((n_faces, n_classes) float32 counts, () int32 overflow).

    Args:
        p2f: (image_h, image_w) int32 pix2face, -1 for background.
        class_image: (image_h, image_w) class ids; pixels with a class
            outside ``[0, n_classes)`` are not counted.
        binned, config: the binning the pix2face was rasterized from, as
            the JAX function takes them.  The counts here read only the
            pix2face, and they have no fold window that could drop an
            entry, so ``overflow`` is always 0.

    The counts are :func:`project_image_class_counts`'s: a CUDA tensor
    launches the counts kernel; a CPU tensor runs its plain version.
    """
    del binned, config
    if tuple(p2f.shape) != (image_h, image_w):
        raise ValueError(f"p2f {tuple(p2f.shape)} != image {(image_h, image_w)}")
    counts = project_image_class_counts(
        p2f, class_image.to(p2f.device), n_faces, n_classes)
    return counts, torch.zeros((), dtype=torch.int32, device=p2f.device)
