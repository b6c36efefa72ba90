"""Ray/triangle intersection for clipping detection rays between covering
meshes, in PyTorch.

Port of ``geograypher_tpu/ops/raycast.py``: a dense Moller-Trumbore over
every (ray, triangle) pair, both windings, float32 on a device.  The
rays are cast only against covering meshes (an N x N grid, 2 (N - 1)^2
triangles: 4,802 at the default N = 50), never against the scene mesh,
so the dense form stays; it runs in chunks of rays so that its (R, F, 3)
intermediates stay bounded, and the result does not depend on the chunk.
The JAX package computes it outside any Pallas kernel, so here it is
plain PyTorch on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from geograypher_tpu_torch.ops.triangulate import _cross, _dot
from geograypher_tpu_torch.utils.device import resolve_device

EPS = 1e-9  # near-zero determinant / ray-parameter guard
# barycentric slack must be f32-scale: 1e-9 is below the f32 ulp at ~1,
# so rays grazing shared grid edges would miss BOTH adjacent triangles;
# 1e-6 admits the shared edge on at least one side
BARY_EPS = 1e-6
# (ray, triangle) pairs a chunk of rays may hold: ~10 float32 (R, F, 3)
# intermediates of 2^24 pairs are ~2 GB
MAX_PAIRS = 1 << 24


def _first_hits(origins, directions, v0, e1, e2):
    d = directions[:, None, :]  # (R, 1, 3)
    h = _cross(d, e2[None, :, :])  # (R, F, 3)
    a = _dot(e1[None], h)  # (R, F)
    parallel = a.abs() < EPS
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = origins[:, None, :] - v0[None]  # (R, F, 3)
    u = f * _dot(s, h)
    q = _cross(s, e1[None, :, :])
    v = f * _dot(d, q)
    t = f * _dot(e2[None], q)
    hit = (
        ~parallel
        & (u >= -BARY_EPS)
        & (v >= -BARY_EPS)
        & (u + v <= 1.0 + BARY_EPS)
        & (t > EPS)
    )
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    t_hit = t.amin(dim=1)
    # the lowest face id among equal t, as argmin gives it
    first = torch.argmin(t, dim=1)
    face = torch.where(torch.isfinite(t_hit), first.to(torch.int32),
                       torch.full_like(first, -1, dtype=torch.int32))
    return t_hit, face


def ray_triangle_intersect(
    origins: torch.Tensor,
    directions: torch.Tensor,
    tri_verts: torch.Tensor,
    max_pairs: int = MAX_PAIRS,
):
    """First-hit parametric distance of rays against a triangle soup.

    Args:
        origins: (R, 3) float32 ray origins on a device.
        directions: (R, 3) ray directions (not necessarily unit).
        tri_verts: (F, 3, 3) triangles on the same device.
        max_pairs: (ray, triangle) pairs of one chunk of rays.

    Returns:
        t_hit: (R,) smallest positive ray parameter, +inf if no hit.
        face: (R,) int32 face id of the first hit (the lowest id among
            equal parameters), -1 if none.
    """
    v0 = tri_verts[:, 0]  # (F, 3)
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    n_rays, n_tris = origins.shape[0], max(tri_verts.shape[0], 1)
    chunk = max(1, int(max_pairs) // n_tris)
    if tri_verts.shape[0] == 0 or n_rays == 0:
        return (torch.full((n_rays,), float("inf"), dtype=origins.dtype,
                           device=origins.device),
                torch.full((n_rays,), -1, dtype=torch.int32, device=origins.device))
    parts = [_first_hits(origins[k:k + chunk], directions[k:k + chunk], v0, e1, e2)
             for k in range(0, n_rays, chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def clip_line_segments(
    starts,
    ends,
    ceiling_tris,
    floor_tris,
    device="cuda",
):
    """Clip segments to the volume between ceiling and floor surfaces.

    Port of the reference's Embree-based ``clip_line_segments``
    (utils/geometric.py:144-254): each ray starts where it crosses the
    ceiling and ends where it crosses the floor; a ray is kept when it
    hits both and the floor lies beyond the ceiling.  Runs on ``device``
    (the card by default; raises without one).

    Returns (clipped_starts, clipped_ends, valid_mask) as numpy arrays.
    """
    device = resolve_device(device, "clip_line_segments")

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device)

    starts, ends = dev(starts), dev(ends)
    dirs = ends - starts
    t_ceil, _ = ray_triangle_intersect(starts, dirs, dev(ceiling_tris))
    t_floor, _ = ray_triangle_intersect(starts, dirs, dev(floor_tris))
    valid = torch.isfinite(t_ceil) & torch.isfinite(t_floor) & (t_floor > t_ceil)
    new_starts = starts + t_ceil[:, None] * dirs
    new_ends = starts + t_floor[:, None] * dirs
    return new_starts.cpu().numpy(), new_ends.cpu().numpy(), valid.cpu().numpy()
