"""A regular grid mesh: the bench suite's plane of sin x cos heights."""

import numpy as np


def make(n: int, size: float, z_amplitude: float, z_frequency: float):
    """A regular (n x n)-vertex plane over ``size`` metres, heights
    ``z_amplitude * sin(f x) cos(f y)``; each cell splits into
    (v00, v10, v11) and (v00, v11, v01).  (verts (V, 3) float64, faces
    (F, 3) int32)."""
    step = size / (n - 1)
    coords = -size / 2 + step * np.arange(n)
    xx, yy = np.meshgrid(coords, coords, indexing="xy")
    zz = z_amplitude * np.sin(z_frequency * xx) * np.cos(z_frequency * yy)
    verts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    iy, ix = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (iy * n + ix).ravel()
    v01 = v00 + n
    tri_a = np.stack([v00, v00 + 1, v01 + 1], axis=1)
    tri_b = np.stack([v00, v01 + 1, v01], axis=1)
    faces = np.concatenate([tri_a, tri_b], axis=1).reshape(-1, 3)
    return verts, faces.astype(np.int32)
