"""Pairwise segment closest-point math, the intersection graph and its
communities: the detection workflow's triangulation, in PyTorch.

Port of ``geograypher_tpu/ops/triangulate.py``.  For N segments a0->a1
against M segments b0->b1, :func:`pairwise_segment_closest_points` gives
the (N, M) closest points on each and their distances, with optional
clamping to the segment ends and the three parallel cases, by the JAX
package's branchless formulas in float32 on a device.  The JAX package
computes them outside any Pallas kernel (plain ``jax.jit``), so here they
are plain PyTorch on the device.

Every dot product is a sum of elementwise products: no matmul, so no
TF32 on the card (the JAX package runs its einsums at full float32).

:func:`calc_graph_weights` cuts each upper-triangular block on the device
and downloads only the entries that pass; the edge list, its order and
its float64 weights are those of the JAX package's host formulation.
:func:`calc_communities` runs the port's seeded Louvain
(:mod:`geograypher_tpu_torch.utils.louvain`, networkx's partitions).
"""

from __future__ import annotations

import json
import time
import typing
from pathlib import Path

import numpy as np
import torch

from geograypher_tpu_torch.constants import (
    EARTH_CENTERED_EARTH_FIXED_EPSG,
    LAT_LON_EPSG,
)
from geograypher_tpu_torch.utils.device import resolve_device


def _dot(x, y):
    """Sum over the last axis (size 3) of x * y, in index order."""
    return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1] + x[..., 2] * y[..., 2]


def _cross(x, y):
    return torch.stack([
        x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
        x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
        x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0],
    ], dim=-1)


def _norm(x):
    return torch.sqrt(_dot(x, x))


def pairwise_closest(a0, a1, b0, b1, clamp: bool):
    """(pA, pB, dist): (N, M, 3), (N, M, 3), (N, M) tensors on the inputs'
    device, float32, by the formulas of the JAX package's
    ``_pairwise_closest``."""
    A = a1 - a0  # (N, 3)
    B = b1 - b0  # (M, 3)
    magA = _norm(A)
    magB = _norm(B)
    uA = A / magA[:, None]
    uB = B / magB[:, None]

    a0e = a0[:, None, :]
    b0e = b0[None, :, :]
    uAe = uA[:, None, :]
    uBe = uB[None, :, :]

    cross = _cross(uAe, uBe)  # (N, M, 3)
    denom = _dot(cross, cross)  # (N, M)
    parallel = denom == 0
    safe_denom = torch.where(parallel, torch.ones_like(denom), denom)

    t = b0e - a0e
    detA = _dot(_cross(t, uBe), cross)
    detB = _dot(_cross(t, uAe), cross)
    t0 = detA / safe_denom
    t1 = detB / safe_denom
    # (N, 1) . (1, M) products of the parallel cases: uA . b - uA . a0
    uA_a0 = _dot(uA, a0)[:, None]
    d0 = _dot(uAe, b0[None, :, :]) - uA_a0

    if clamp:
        zero = torch.zeros((), dtype=t0.dtype, device=t0.device)
        magA_c = magA[:, None]
        magB_r = magB[None, :]
        t0c = torch.minimum(torch.maximum(t0, zero), magA_c)
        t1c = torch.minimum(torch.maximum(t1, zero), magB_r)
        pA = a0e + t0c[..., None] * uAe
        pB = b0e + t1c[..., None] * uBe
        oob_A = (t0 < 0) | (t0 > magA_c)
        oob_B = (t1 < 0) | (t1 > magB_r)
        # reproject the clamped A point onto B (where A was clamped)...
        dotB = torch.minimum(torch.maximum(_dot(pA - b0e, uBe), zero), magB_r)
        pB = torch.where(oob_A[..., None], b0e + dotB[..., None] * uBe, pB)
        # ...then the (possibly updated) B point onto A (where B was clamped)
        dotA = torch.minimum(torch.maximum(_dot(pB - a0e, uAe), zero), magA_c)
        pA = torch.where(oob_B[..., None], a0e + dotA[..., None] * uAe, pA)

        # parallel segments: before / after / overlapping-middle cases
        d1 = _dot(uAe, b1[None, :, :]) - uA_a0
        before = (d0 <= 0) & (d1 <= 0) & parallel
        after = (d0 >= magA_c) & (d1 >= magA_c) & parallel
        middle = parallel & ~(before | after)

        b_near = torch.where((d0.abs() < d1.abs())[..., None], b0e,
                             b1[None, :, :])
        pA = torch.where(before[..., None], a0e, pA)
        pB = torch.where(before[..., None], b_near, pB)
        pA = torch.where(after[..., None], a1[:, None, :], pA)
        pB = torch.where(after[..., None], b_near, pB)
        t_mid = torch.minimum(torch.maximum(d0, zero), magA_c)
        pA_mid = a0e + t_mid[..., None] * uAe
        a2b = b0e - pA_mid
        along = _dot(a2b, uAe)[..., None] * uAe
        pB_mid = pA_mid + (a2b - along)
        pA = torch.where(middle[..., None], pA_mid, pA)
        pB = torch.where(middle[..., None], pB_mid, pB)
    else:
        pA = a0e + t0[..., None] * uAe
        pB = b0e + t1[..., None] * uBe
        # parallel: arbitrarily b0 and its projection onto A
        pA_par = a0e + d0[..., None] * uAe
        pA = torch.where(parallel[..., None], pA_par, pA)
        pB = torch.where(parallel[..., None], b0e.expand_as(pB), pB)

    dist = _norm(pA - pB)
    return pA, pB, dist


def _as_device(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device)


def pairwise_segment_closest_points(
    a0, a1, b0, b1, clamp: bool = False, device="cuda"
):
    """Closest points + distances between all segment pairs, as numpy.

    Same signature and semantics as the JAX package's (and the
    reference's ``compute_approximate_ray_intersections``,
    numeric.py:39), float32 on ``device`` (the card by default; raises
    without one, ``device="cpu"`` for the CPU).
    """
    device = resolve_device(device, "pairwise_segment_closest_points")
    pA, pB, dist = pairwise_closest(
        _as_device(a0, device), _as_device(a1, device),
        _as_device(b0, device), _as_device(b1, device), clamp=clamp,
    )
    return pA.cpu().numpy(), pB.cpu().numpy(), dist.cpu().numpy()


# Alias matching the reference's name for ported call sites
compute_approximate_ray_intersections = pairwise_segment_closest_points


def _block_entries(a0, a1, b0, b1, i0, j0, ray_IDs, threshold):
    """One block's entries that survive the JAX package's cut, found on
    the device: (rows, cols, float64 distances) in row-major order, with
    ``i0 + row < j0 + col`` and different ray IDs.  The cut compares the
    float64 distance with the float64 threshold, as the host does."""
    _, _, dist = pairwise_closest(a0, a1, b0, b1, clamp=True)
    d64 = dist.double()
    keep = torch.isfinite(d64) & ~(d64 > threshold)
    rows = torch.arange(d64.shape[0], device=d64.device)[:, None] + i0
    cols = torch.arange(d64.shape[1], device=d64.device)[None, :] + j0
    keep &= rows < cols
    # (the diagonal, NaN on the host, never satisfies rows < cols)
    keep &= ray_IDs[i0:i0 + d64.shape[0], None] != ray_IDs[None, j0:j0 + d64.shape[1]]
    r, c = torch.nonzero(keep, as_tuple=True)
    return r, c, d64[r, c]


def calc_graph_weights(
    starts: np.ndarray,
    ends: np.ndarray,
    ray_IDs: np.ndarray,
    similarity_threshold: float,
    out_dir=None,
    min_dist: float = 1e-6,
    step: int = 5000,
    transform: typing.Optional[typing.Callable] = None,
    device="cuda",
    stats: typing.Optional[dict] = None,
):
    """Graph edges between intersecting rays, weighted by inverse distance
    (reference numeric.py:428-507): ``[(i, j, {"weight": w}), ...]``, or
    the path of ``edge_weights.json`` in ``out_dir`` when given.

    Upper-triangular blocks of ``step`` rays run on ``device``.  Without
    a ``transform`` the cut (the diagonal, ``> similarity_threshold``,
    ``i < j``, different images) runs there too and only the surviving
    entries come to the host, where the ``min_dist`` floor and ``1 /
    dist`` are the host formulation's float64 operations; a ``transform``
    receives the whole float64 numpy block, as in the JAX package.
    ``stats``, when given, gets the seconds of the device blocks
    (``blocks_device_s``: compute, cut and download, ended by a
    synchronise) and of the host's edge formatting (``format_s``).
    """
    from geograypher_tpu_torch.utils.numeric import chunk_slices, format_graph_edges

    device = resolve_device(device, "calc_graph_weights")
    starts_d = _as_device(starts, device)
    ends_d = _as_device(ends, device)
    ids_d = torch.as_tensor(np.asarray(ray_IDs).astype(np.int64)).to(device)
    ids_host = np.asarray(ray_IDs)
    edge_weights = []
    t_dev = t_fmt = 0.0
    for islice, jslice, diagonal in chunk_slices(N=len(starts), step=step):
        t0 = time.perf_counter()
        if transform is None:
            r, c, d = _block_entries(
                starts_d[islice], ends_d[islice], starts_d[jslice], ends_d[jslice],
                islice.start, jslice.start, ids_d,
                float(similarity_threshold),
            )
            r, c, d = r.cpu().numpy(), c.cpu().numpy(), d.cpu().numpy()
            t1 = time.perf_counter()
            d[d < min_dist] = min_dist
            w = 1.0 / np.maximum(d, 1e-9)
            r = r + islice.start
            c = c + jslice.start
            edge_weights.extend(
                (int(i), int(j), {"weight": float(x)})
                for i, j, x in zip(r.tolist(), c.tolist(), w.tolist())
            )
        else:
            _, _, dist = pairwise_closest(
                starts_d[islice], ends_d[islice], starts_d[jslice], ends_d[jslice],
                clamp=True,
            )
            dist = dist.cpu().numpy().astype(np.float64)
            t1 = time.perf_counter()
            if diagonal:
                np.fill_diagonal(dist, np.nan)
            dist[dist > similarity_threshold] = np.nan
            dist[dist < min_dist] = min_dist
            dist = transform(dist)
            edge_weights.extend(format_graph_edges(islice, jslice, dist, ids_host))
        t_dev += t1 - t0
        t_fmt += time.perf_counter() - t1
    if stats is not None:
        stats.update(blocks_device_s=t_dev, format_s=t_fmt)

    if out_dir is None:
        return edge_weights
    path = Path(out_dir) / "edge_weights.json"
    with path.open("w") as fh:
        json.dump(edge_weights, fh)
    return path


def calc_communities(
    starts: np.ndarray,
    ends: np.ndarray,
    edge_weights,
    louvain_resolution: float = 1.0,
    out_dir=None,
    transform_to_epsg_4978: typing.Optional[np.ndarray] = None,
    seed: int = 0,
    device="cuda",
    stats: typing.Optional[dict] = None,
):
    """Louvain communities over the ray-intersection graph; each community
    is triangulated to one 3D point (reference numeric.py:509-619).

    Deterministic: the port's Louvain runs with a fixed seed and gives
    networkx's partitions for it.  Communities are sorted by size,
    largest first (stable).  ``stats``, when given, gets the seconds of
    the Louvain (``louvain_s``) and of the per-community averages
    (``average_s``).
    """
    from geograypher_tpu_torch.utils import crs as crs_utils
    from geograypher_tpu_torch.utils.louvain import Graph, louvain_communities
    from geograypher_tpu_torch.utils.numeric import intersection_average

    device = resolve_device(device, "calc_communities")
    t0 = time.perf_counter()
    graph = Graph(edge_weights)
    communities = (
        louvain_communities(graph, resolution=louvain_resolution, seed=seed)
        if len(graph) > 0 else []
    )
    t1 = time.perf_counter()
    if communities:
        communities = sorted(communities, key=len, reverse=True)
        community_points = []
        ray_IDs = np.full(starts.shape[0], fill_value=np.nan)
        for community_ID, community in enumerate(communities):
            idx = np.array(list(community))
            ray_IDs[idx] = community_ID
            community_points.append(
                intersection_average(starts=starts[idx], ends=ends[idx],
                                     device=device)
            )
        community_points = np.vstack(community_points)
        result = {"ray_IDs": ray_IDs, "community_points": community_points}
        if transform_to_epsg_4978 is not None:
            hom = np.concatenate(
                [community_points, np.ones_like(community_points[:, :1])], axis=1
            )
            ecef = (transform_to_epsg_4978 @ hom.T).T
            result["community_points_latlon"] = crs_utils.transform_points(
                ecef[:, :3], EARTH_CENTERED_EARTH_FIXED_EPSG, LAT_LON_EPSG
            )
    else:
        result = {
            "ray_IDs": np.zeros((0,), dtype=int),
            "community_points": np.zeros((0, 3)),
        }
        if transform_to_epsg_4978 is not None:
            result["community_points_latlon"] = np.zeros((0, 3))
    if stats is not None:
        stats.update(louvain_s=t1 - t0, average_s=time.perf_counter() - t1)

    if out_dir is not None:
        path = Path(out_dir) / "communities.npz"
        np.savez(path, **result)
        return path
    return result


def triangulate_rays_lstsq(starts: np.ndarray, directions: np.ndarray) -> np.ndarray:
    """Least-squares intersection point of rays (reference numeric.py:239-269;
    kept for API parity: the main triangulation flow uses
    ``intersection_average`` instead).

    Solves min_x sum_i || (I - d_i d_i^T)(x - s_i) ||^2 in closed form.
    """
    d = np.asarray(directions, dtype=np.float64)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    s = np.asarray(starts, dtype=np.float64)
    eye = np.eye(3)
    projs = eye[None] - d[:, :, None] * d[:, None, :]  # (N, 3, 3)
    A = projs.sum(axis=0)
    b = np.einsum("nij,nj->i", projs, s)
    return np.linalg.solve(A, b)
