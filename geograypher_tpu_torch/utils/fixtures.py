"""Synthetic analytic scenes (numpy, on the host).

Port of the grid mesh, the camera poses and the brute-force oracle of
``geograypher_tpu/utils/fixtures.py``; the tests hold each equal to the
JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_grid_mesh(
    n: int = 201,
    size: float = 4.0,
    z_fn=None,
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Regular (n x n)-vertex triangulated plane centred at the origin.

    Vertex (iy, ix) sits at ``(-size/2 + ix*step, -size/2 + iy*step,
    z_fn(x, y))``; each cell splits into A = (v00, v10, v11) and
    B = (v00, v11, v01), v10 being +x and v01 +y of v00.

    Returns (verts (V, 3) float64, faces (F, 3) int32).
    """
    step = size / (n - 1)
    coords = -size / 2 + step * np.arange(n)
    xx, yy = np.meshgrid(coords, coords, indexing="xy")
    zz = np.zeros_like(xx) if z_fn is None else z_fn(xx, yy)
    verts = np.stack(
        [xx.ravel() + offset[0], yy.ravel() + offset[1], zz.ravel() + offset[2]],
        axis=1,
    )
    iy, ix = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (iy * n + ix).ravel()
    v10 = v00 + 1
    v01 = v00 + n
    v11 = v01 + 1
    tri_a = np.stack([v00, v10, v11], axis=1)
    tri_b = np.stack([v00, v11, v01], axis=1)
    faces = np.concatenate([tri_a, tri_b], axis=1).reshape(-1, 3)
    return verts, faces.astype(np.int32)


def oblique_camera(
    scene_width: float = 4.0,
    focal: float = 100.0,
    sensor_width: int = 200,
    pitch_deg: float = 25.0,
    azimuth_deg: float = 0.0,
) -> np.ndarray:
    """cam-to-world of a camera tilted ``pitch_deg`` off nadir and orbited
    ``azimuth_deg`` about the origin, looking at it from the distance at
    which ``scene_width`` spans the sensor (x right, y down, z = view)."""
    d = scene_width * focal / sensor_width
    pitch = np.deg2rad(pitch_deg)
    az = np.deg2rad(azimuth_deg)
    eye = d * np.array(
        [np.sin(pitch) * np.cos(az), np.sin(pitch) * np.sin(az), np.cos(pitch)]
    )
    z_cam = -eye / np.linalg.norm(eye)
    x_cam = np.cross(z_cam, np.array([0.0, 0.0, 1.0]))
    n = np.linalg.norm(x_cam)
    if n < 1e-9:  # nadir
        x_cam = np.array([1.0, 0.0, 0.0])
    else:
        x_cam = x_cam / n
    y_cam = np.cross(z_cam, x_cam)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x_cam, y_cam, z_cam, eye
    return c2w


def nadir_camera(
    scene_width: float = 4.0, focal: float = 100.0, sensor_width: int = 200
) -> np.ndarray:
    """cam-to-world of a camera looking straight down at the origin from
    the height at which ``scene_width`` spans the sensor; camera +Z maps
    to world -Z and image up to world +Y."""
    height = scene_width * focal / sensor_width
    return np.array(
        [
            [1.0, 0.0, 0.0, 0.0],
            [0.0, -1.0, 0.0, 0.0],
            [0.0, 0.0, -1.0, height],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def gather_tri_verts(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(F, 3, 3) triangle vertices."""
    return np.asarray(verts)[np.asarray(faces)]


def brute_force_pix2face(
    tri_verts_cam: np.ndarray,
    f: float,
    image_w: int,
    image_h: int,
    znear: float = 1e-6,
) -> np.ndarray:
    """Independent O(pixels x faces) float64 reference rasterizer:
    inclusive edge tests at pixel centres on both windings, largest
    perspective-correct 1/z wins, ties to the lowest face id."""
    tri = np.asarray(tri_verts_cam, dtype=np.float64)
    z = tri[..., 2]
    valid = np.all(z > znear, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = f * tri[..., 0] / z + image_w / 2.0
        sy = f * tri[..., 1] / z + image_h / 2.0
        w = 1.0 / z

    cols = np.arange(image_w) + 0.5
    rows = np.arange(image_h) + 0.5
    px, py = np.meshgrid(cols, rows, indexing="xy")

    best_w = np.full((image_h, image_w), -np.inf)
    best_face = np.full((image_h, image_w), -1, dtype=np.int32)
    for fid in range(tri.shape[0]):
        if not valid[fid]:
            continue
        x0, x1, x2 = sx[fid]
        y0, y1, y2 = sy[fid]
        e0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
        e1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
        e2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
        area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        if abs(area2) <= 1e-12:
            continue
        s = np.sign(area2)
        covered = (s * e0 >= 0) & (s * e1 >= 0) & (s * e2 >= 0)
        lam0 = s * e0 / abs(area2)
        lam1 = s * e1 / abs(area2)
        lam2 = s * e2 / abs(area2)
        wpix = lam0 * w[fid, 0] + lam1 * w[fid, 1] + lam2 * w[fid, 2]
        upd = covered & (wpix > best_w)
        best_w[upd] = wpix[upd]
        best_face[upd] = fid
    return best_face
