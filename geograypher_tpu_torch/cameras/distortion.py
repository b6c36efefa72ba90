"""Brown-Conrady lens distortion (port of
``geograypher_tpu/cameras/distortion.py`` ``distort_normalized``).

The rasterizer warps triangle vertices into a sensor's distorted pixel
space with it (see ``ops/rasterize.setup_from_soa``).  The inverse maps,
the image remap and the distortion engine come with the render path.
"""

from __future__ import annotations

from typing import Tuple

import torch


def distort_normalized(
    x: torch.Tensor, y: torch.Tensor, dist: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply Brown-Conrady distortion to normalized camera coords.

    Args:
        x, y: normalized coordinates ((pix - center) / f), any shape.
        dist: (8,) [k1, k2, k3, k4, p1, p2, b1, b2].

    Returns distorted normalized (xd, yd), before the affinity terms
    b1/b2, which apply at the pixel stage.
    """
    k1, k2, k3, k4, p1, p2 = (dist[i] for i in range(6))
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = x * radial + (p1 * (r2 + 2 * x * x) + 2 * p2 * x * y)
    yd = y * radial + (p2 * (r2 + 2 * y * y) + 2 * p1 * x * y)
    return xd, yd
