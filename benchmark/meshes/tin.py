"""An irregular Delaunay TIN, as photogrammetry software exports one."""

import numpy as np


def make(n_points: int, size: float, seed: int, z_amplitude: float,
         z_frequency: float, jitter: float = 0.45, extra_frac: float = 0.2):
    """An irregular Delaunay TIN as photogrammetry exports it: grid points
    jittered by ``jitter`` grid steps plus ``extra_frac`` uniform extras,
    faces counter-clockwise in xy, heights as the grid mesh's."""
    from scipy.spatial import Delaunay

    gen = np.random.default_rng(seed)
    n_grid = max(int(np.sqrt(n_points / (1.0 + extra_frac))), 2)
    step = size / (n_grid - 1)
    coords = -size / 2 + step * np.arange(n_grid)
    xx, yy = np.meshgrid(coords, coords, indexing="xy")
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
    pts = pts + gen.uniform(-jitter * step, jitter * step, pts.shape)
    extra = gen.uniform(-size / 2, size / 2, (int(extra_frac * len(pts)), 2))
    pts = np.concatenate([pts, extra], axis=0)
    faces = Delaunay(pts).simplices.astype(np.int32)
    a, b, c = pts[faces[:, 0]], pts[faces[:, 1]], pts[faces[:, 2]]
    det = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
           - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    faces[det < 0] = faces[det < 0][:, ::-1]
    zz = z_amplitude * np.sin(z_frequency * pts[:, 0]) * np.cos(z_frequency * pts[:, 1])
    return np.concatenate([pts, zz[:, None]], axis=1), faces
