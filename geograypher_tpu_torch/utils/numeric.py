"""Host-side numeric helpers: the port's own copy of
``geograypher_tpu/utils/numeric.py`` (numpy only).

Ramped weighting, quaternions, RPY rotations, chunk iteration and graph
formatting for the triangulation graph, a Hilbert-curve order, triangle
areas and a seeded mode.  :func:`intersection_average` runs the pairwise
segment math of the port's :mod:`geograypher_tpu_torch.ops.triangulate`.
"""

from __future__ import annotations

import typing
from itertools import product

import numpy as np


def create_ramped_weighting(
    rectangle_shape: typing.Tuple[int, int], ramp_dist_frac: float
) -> np.ndarray:
    """Weight mask rising linearly from 0 at each edge to 1 at
    ``ramp_dist_frac`` of the axis length in; used to blend overlapping
    orthomosaic tiles (same weighting as reference numeric.py:14-36).

    Formulated as normalized distance-to-nearest-edge per axis, combined
    with a min (so corners ramp along both axes).
    """

    def edge_ramp(n: int) -> np.ndarray:
        idx = np.arange(n, dtype=np.float64)
        dist = np.minimum(idx, (n - 1) - idx)  # pixels to the closer edge
        ramp_len = ramp_dist_frac * (n - 1)
        if ramp_len <= 0:
            return np.ones(n)
        return np.minimum(dist / ramp_len, 1.0)

    rows, cols = rectangle_shape
    return np.minimum(edge_ramp(rows)[:, None], edge_ramp(cols)[None, :])


def quaternion_wxyz_to_matrix(q) -> np.ndarray:
    """Rotation matrix from a (w, x, y, z) quaternion (replaces
    scipy.spatial.transform.Rotation in the COLMAP parser,
    reference derived_cameras.py:290-295)."""
    w, x, y, z = (float(v) for v in q)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotation_rpy_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Camera-frame roll/pitch/yaw rotation, degrees.

    Matches the reference's ``rotate_by_roll_pitch_yaw``
    (utils/image.py:29-70): RPY is defined in the aeronautics frame
    (X forward, Z down) and conjugated into the camera frame (x right,
    y down, z forward) by the permutation X_rpy = Z_cam, Y_rpy = X_cam,
    Z_rpy = -Y_cam.  Net effect: +yaw pans the view toward +x (image
    right), +pitch tilts toward +y (image down), roll spins about the
    optical axis.
    """
    r, p, y = np.deg2rad([roll, pitch, yaw])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    # intrinsic ZYX (yaw, pitch, roll) in the RPY frame
    r_zyx = rz @ ry @ rx
    perm = np.array([[0, 0, 1], [1, 0, 0], [0, -1, 0]], dtype=float)
    return perm.T @ r_zyx @ perm


def chunk_slices(
    N: int, step: int
) -> typing.Iterator[typing.Tuple[slice, slice, bool]]:
    """Upper-triangular (step, step) block iteration over an (N, N) matrix
    (reference numeric.py:350-377); memory guard for pairwise math."""
    ranges = range(0, N, step)
    for i, j in product(ranges, repeat=2):
        if j >= i:
            yield (
                slice(i, min(i + step, N)),
                slice(j, min(j + step, N)),
                i == j,
            )


def format_graph_edges(
    islice: slice,
    jslice: slice,
    dist: np.ndarray,
    ray_IDs: np.ndarray,
) -> typing.List[typing.Tuple[int, int, typing.Dict[str, float]]]:
    """Graph edges (i, j, {"weight": 1/dist}) from a finite-distance block,
    keeping i<j and dropping same-image ray pairs (reference
    numeric.py:379-426)."""
    i_inds, j_inds = np.where(np.isfinite(dist))
    # exactly-intersecting rays (dist 0) would weigh infinite and poison
    # downstream weight sums; clamp to a tight positive floor
    with np.errstate(divide="ignore"):
        weights = 1.0 / np.maximum(dist, 1e-9)
    return [
        (
            int(i) + islice.start,
            int(j) + jslice.start,
            {"weight": float(weights[i, j])},
        )
        for i, j in zip(i_inds, j_inds)
        if (i + islice.start < j + jslice.start)
        and (ray_IDs[i + islice.start] != ray_IDs[j + jslice.start])
    ]


def hilbert_argsort_2d(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Order that sorts 2D points along a Hilbert curve.

    Spatially coherent orderings make every raster tile's candidate face
    ids a narrow band, which the scatter-free aggregation
    (ops/agg_tiled.py) and the rasterizer's windowed folds exploit.  The
    Hilbert curve bounds the id band of a w x h query box by O(w * h)
    with a small constant — unlike raw row-major order (band ~ h * row
    stride) or Morton order (band ~ enclosing power-of-two square).

    Args:
        points: (N, 2) float coordinates (any units).
        bits: quantization bits per axis.

    Returns (N,) int64 argsort permutation.
    """
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-12)
    side = (1 << bits) - 1
    q = ((points - lo) / span * side).astype(np.uint64)
    x, y = q[:, 0].copy(), q[:, 1].copy()
    d = np.zeros(len(points), np.uint64)
    s = np.uint64(1) << np.uint64(bits - 1)
    one = np.uint64(1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate quadrant so the curve stays continuous
        flip = (ry == 0) & (rx == 1)
        x = np.where(flip, s - one - x, x)
        y = np.where(flip, s - one - y, y)
        swap = ry == 0
        x, y = np.where(swap, y, x), np.where(swap, x, y)
        s >>= one
    return np.argsort(d, kind="stable")


def compute_3D_triangle_area_vectorized(
    corners: np.ndarray, return_z_proj_area: bool = True
):
    """Triangle areas (and z-projected areas) from (3, F, 3) corners
    (reference numeric.py:271-303)."""
    A, B, C = corners
    u = B - A
    v = C - A
    u0v1_min_u1v0 = u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]
    area = 0.5 * np.sqrt(
        (u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1]) ** 2
        + (u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2]) ** 2
        + u0v1_min_u1v0**2
    )
    if return_z_proj_area:
        return area, np.abs(u0v1_min_u1v0) / 2
    return area


compute_3D_triangle_area = compute_3D_triangle_area_vectorized


def fair_mode_non_nan(
    values: np.ndarray, seed: typing.Optional[int] = 0
) -> np.ndarray:
    """Per-row mode of integer/nan values with RANDOM (but seeded,
    reproducible) tie-breaking.

    Matches the reference's vote kernel (numeric.py:622-659) except the
    tie-break randomness is seeded for determinism (SURVEY.md §5 flags the
    reference's unseeded np.random as a reproducibility gap).  Pass
    ``seed=None`` for reference-style unseeded behavior.
    """
    values = np.asarray(values, dtype=float)
    out = np.full(values.shape[0], np.nan)
    countable = np.isfinite(values) & (values >= 0)
    if not countable.any():
        return out
    n_bins = int(values[countable].max()) + 1

    # per-row histogram in one pass (no per-class scan)
    hist = np.zeros((values.shape[0], n_bins))
    rows, cols = np.nonzero(countable)
    np.add.at(hist, (rows, values[rows, cols].astype(np.intp)), 1.0)

    voted = hist.any(axis=1)
    # sub-unit random jitter promotes a uniformly random winner among tied
    # top counts without ever crossing count levels
    rng = np.random.default_rng(seed) if seed is not None else np.random
    winner = np.argmax(hist + 0.5 * rng.random(hist.shape), axis=1)
    out[voted] = winner[voted]
    return out


def intersection_average(
    starts: np.ndarray, ends: np.ndarray, device="cuda"
) -> np.ndarray:
    """Mean of closest points between all pairs of segments
    (reference numeric.py:330-347); the pairwise math runs in the port's
    ``ops/triangulate.py`` on ``device``."""
    from geograypher_tpu_torch.ops.triangulate import (
        pairwise_segment_closest_points,
    )

    pA, pB, _ = pairwise_segment_closest_points(
        starts, ends, starts, ends, clamp=True, device=device
    )
    pA, pB = np.asarray(pA), np.asarray(pB)
    mask = ~np.eye(starts.shape[0], dtype=bool)
    return np.mean(np.vstack([pA[mask], pB[mask]]), axis=0)
