"""Seeded KMeans in numpy, for the chunked paths' camera and polygon
clustering.  The JAX package clusters with sklearn's KMeans; the port
keeps its own, so it needs no sklearn.

Lloyd's iterations from a greedy k-means++ start (the seeding of Arthur
and Vassilvitskii, 2007, trying ``2 + log k`` candidates per centre as
sklearn does), the best of ``n_init`` seeded starts by inertia.  On
well-separated clusters it finds sklearn's partition; its labels and
centres need not be sklearn's.
"""

from __future__ import annotations

import typing

import numpy as np


def _sq_dists(points: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(N, K) squared distances."""
    return ((points[:, None, :] - centers[None, :, :]) ** 2).sum(axis=-1)


def _kmeans_plus_plus(points: np.ndarray, k: int,
                      rng: np.random.Generator) -> np.ndarray:
    n = len(points)
    trials = 2 + int(np.log(k))
    centers = [points[rng.integers(n)]]
    closest = _sq_dists(points, np.asarray(centers))[:, 0]
    for _ in range(1, k):
        total = closest.sum()
        if total <= 0:  # fewer distinct points than centres
            cand = rng.integers(n, size=trials)
        else:
            cand = np.searchsorted(np.cumsum(closest),
                                   rng.random(trials) * total)
            cand = np.minimum(cand, n - 1)
        # the candidate that leaves the smallest potential
        pot = np.minimum(closest[None, :], _sq_dists(points, points[cand]).T)
        best = int(np.argmin(pot.sum(axis=1)))
        centers.append(points[cand[best]])
        closest = pot[best]
    return np.asarray(centers)


def _lloyd(points: np.ndarray, centers: np.ndarray, max_iter: int,
           tol: float) -> typing.Tuple[np.ndarray, np.ndarray, float]:
    for _ in range(max_iter):
        labels = np.argmin(_sq_dists(points, centers), axis=1)
        new = centers.copy()
        for j in range(len(centers)):
            members = points[labels == j]
            if len(members):
                new[j] = members.mean(axis=0)
            else:  # an empty cluster takes the point farthest from its centre
                far = np.argmax(_sq_dists(points, centers)[
                    np.arange(len(points)), labels])
                new[j] = points[far]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if shift <= tol:
            break
    d = _sq_dists(points, centers)
    labels = np.argmin(d, axis=1)
    return labels, centers, float(d[np.arange(len(points)), labels].sum())


def kmeans(points, n_clusters: int, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-4, seed: int = 0
           ) -> typing.Tuple[np.ndarray, np.ndarray]:
    """``(labels (N,), centres (K, D))`` of ``points`` (N, D).

    ``tol`` is relative to the mean per-dimension variance of the points,
    as in sklearn; the run of least inertia of ``n_init`` starts drawn
    from ``numpy.random.default_rng(seed)`` is kept."""
    points = np.asarray(points, dtype=np.float64)
    if points.ndim != 2 or not 1 <= n_clusters <= len(points):
        raise ValueError(f"need 1 <= n_clusters <= N for points of shape "
                         f"{points.shape}, got {n_clusters}")
    rng = np.random.default_rng(seed)
    abs_tol = tol * float(points.var(axis=0).mean())
    best = None
    for _ in range(max(1, int(n_init))):
        start = _kmeans_plus_plus(points, n_clusters, rng)
        labels, centers, inertia = _lloyd(points, start, max_iter, abs_tol)
        if best is None or inertia < best[2]:
            best = (labels, centers, inertia)
    return best[0], best[1]
