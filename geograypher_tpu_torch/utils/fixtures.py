"""Synthetic analytic scenes (numpy, on the host).

Port of the grid and irregular meshes, the camera poses and the
brute-force oracle of ``geograypher_tpu/utils/fixtures.py``; the tests
hold each equal to the JAX package's.  :func:`knife_edge_triangles` is the port's own: the
adversarial scene its raster kernels are held to their plain versions on.
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


def make_irregular_mesh(
    n_points: int = 2000,
    size: float = 4.0,
    z_fn=None,
    seed: int = 0,
    jitter: float = 0.45,
    extra_frac: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Irregular Delaunay TIN over jittered grid points plus uniform
    extras, what photogrammetry software exports: no scanline structure,
    irregular valence, locally varying density.  ``jitter`` is each
    point's displacement in grid steps, ``extra_frac`` the share of extra
    uniformly random points; triangles turn counter-clockwise in xy.

    Returns (verts (V, 3) float64, faces (F, 3) int32), F ~= 2 * n_points.
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    n_grid = max(int(np.sqrt(n_points / (1.0 + extra_frac))), 2)
    step = size / (n_grid - 1)
    coords = -size / 2 + step * np.arange(n_grid)
    xx, yy = np.meshgrid(coords, coords, indexing="xy")
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
    pts = pts + rng.uniform(-jitter * step, jitter * step, pts.shape)
    n_extra = int(extra_frac * pts.shape[0])
    if n_extra:
        extra = rng.uniform(-size / 2, size / 2, (n_extra, 2))
        pts = np.concatenate([pts, extra], axis=0)
    faces = Delaunay(pts).simplices.astype(np.int32)
    # Delaunay does not promise an orientation: turn every face CCW in xy
    a, b, c = pts[faces[:, 0]], pts[faces[:, 1]], pts[faces[:, 2]]
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]
    ) * (c[:, 0] - a[:, 0])
    flip = det < 0
    faces[flip] = faces[flip][:, ::-1]
    zz = np.zeros(pts.shape[0]) if z_fn is None else z_fn(pts[:, 0], pts[:, 1])
    return np.concatenate([pts, zz[:, None]], axis=1), faces


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


def knife_edge_triangles(
    image_w: int,
    image_h: int,
    seed: int = 0,
    n_patches: int = 6,
    patch_cells: int = 40,
    n_small: int = 4000,
    n_slivers: int = 1500,
    n_long: int = 40,
    max_sliver: int = 1500,
) -> np.ndarray:
    """(F, 3, 3) float32 camera-frame triangles for focal length 1 whose
    rounding is adversarial for a rasterizer at ``image_w x image_h``.

    Every vertex sits at a depth that is a power of two, so its projection
    is exact: pixel-space positions are what this function places.

    * ``n_patches`` grids of ``patch_cells`` x ``patch_cells`` cells of 1
      to 8 px, vertices exactly on pixel centres (every other patch within
      1e-4 px of them), each cell split on a diagonal through pixel
      centres; axis-aligned edges run through pixel centres.  Half the
      patches are flat (exact 1/z ties where they overlap), half tilted.
    * ``n_small`` triangles of 1-12 px with vertices on pixel centres.
    * ``n_slivers`` slivers along rows and columns through pixel centres,
      up to ``max_sliver`` px long, the third vertex 1e-5 to 0.3 px off
      the line: sharp vertices, where rounding moves coverage furthest.
    * ``n_long`` faces with one vertex 2^18-2^19 px off the image and two
      on pixel centres inside it: edges longer than 2^18 px, still valid.

    F is padded to a multiple of 8 with degenerate (invalid) faces.
    """
    rng = np.random.default_rng(seed)
    tris, depth = [], []  # pixel-space (x, y) per vertex, and its z

    def centre(lo, hi, size):
        return rng.integers(lo, hi, size) + 0.5

    for p in range(n_patches):
        cell = int(rng.integers(1, 9))
        n = patch_cells
        x0 = centre(0, max(1, image_w - n * cell), 1)[0]
        y0 = centre(0, max(1, image_h - n * cell), 1)[0]
        gx, gy = np.meshgrid(np.arange(n + 1) * cell + x0, np.arange(n + 1) * cell + y0)
        if p % 2:
            jitter = rng.choice([-1e-4, 0.0, 1e-4], (2,) + gx.shape)
            gx, gy = gx + jitter[0], gy + jitter[1]
        z = (np.full(gx.shape, 1.0) if p % 4 < 2
             else np.where((np.indices(gx.shape).sum(0) % 2) == 0, 1.0, 2.0))
        i, j = (k.ravel() for k in np.meshgrid(np.arange(n), np.arange(n),
                                                indexing="ij"))
        a, b, c, d = (i * (n + 1) + j, i * (n + 1) + j + 1,
                      (i + 1) * (n + 1) + j, (i + 1) * (n + 1) + j + 1)
        flip = (i + j) % 2 == 1  # alternate the diagonal cell by cell
        faces = np.concatenate([
            np.stack([a, b, np.where(flip, c, d)], 1),
            np.stack([np.where(flip, b, a), d, c], 1),
        ])
        xy = np.stack([gx.ravel(), gy.ravel()], -1)
        tris.append(xy[faces])
        depth.append(z.ravel()[faces])

    base = np.stack([centre(20, image_w - 20, n_small),
                     centre(20, image_h - 20, n_small)], -1)
    offs = rng.integers(-12, 13, (n_small, 2, 2)).astype(np.float64)
    tris.append(np.stack([base, base + offs[:, 0], base + offs[:, 1]], 1))
    depth.append(rng.choice([0.5, 1.0, 2.0, 4.0], (n_small, 3)))

    length = rng.integers(20, max_sliver, n_slivers).astype(np.float64)
    a = np.stack([centre(0, image_w, n_slivers), centre(0, image_h, n_slivers)], -1)
    along = np.where(rng.random(n_slivers) < 0.7, 0, 1)  # 0: a row, 1: a column
    step = np.zeros((n_slivers, 2))
    step[np.arange(n_slivers), along] = length
    b = a + step
    b[np.arange(n_slivers), 1 - along] += rng.choice([0.0, 1e-4, -1e-4], n_slivers)
    c = a + step * rng.uniform(0.05, 0.95, (n_slivers, 1))
    c[np.arange(n_slivers), along] += rng.choice([0.0, 0.5, 1e-4], n_slivers)
    c[np.arange(n_slivers), 1 - along] += (
        10.0 ** rng.uniform(-5, -0.5, n_slivers) * rng.choice([-1, 1], n_slivers))
    tris.append(np.stack([a, b, c], 1))
    depth.append(rng.choice([1.0, 2.0], (n_slivers, 3)))

    m = min(100, image_w // 4, image_h // 4)
    inner = np.stack([centre(m, image_w - m, (n_long, 2)),
                      centre(m, image_h - m, (n_long, 2))], -1)
    far = inner[:, 0].copy()
    far[:, 0] += rng.choice([-1, 1], n_long) * rng.uniform(2**18, 2**19, n_long)
    far[:, 1] += rng.uniform(-50, 50, n_long)
    tris.append(np.stack([far, inner[:, 0], inner[:, 1]], 1))
    depth.append(np.ones((n_long, 3)))

    px = np.concatenate(tris)
    z = np.concatenate(depth)
    pad = -len(px) % 8
    px = np.concatenate([px, np.full((pad, 3, 2), 0.5 + image_w / 2.0)])
    z = np.concatenate([z, np.ones((pad, 3))])
    cam = np.empty(px.shape[:2] + (3,))
    cam[..., 0] = (px[..., 0] - image_w / 2.0) * z
    cam[..., 1] = (px[..., 1] - image_h / 2.0) * z
    cam[..., 2] = z
    return cam.astype(np.float32)


def crowded_tile_triangles(
    image_w: int,
    image_h: int,
    seed: int = 0,
    n_tile: int = 6000,
    n_wide: int = 7000,
    n_scatter: int = 20000,
    tile: Tuple[int, int] = (8, 128),
) -> np.ndarray:
    """(F, 3, 3) float32 camera-frame triangles for focal length 1 that
    crowd single tile lists at ``image_w x image_h``: ``n_tile`` triangles
    of 1-3 px inside the second tile row's first ``tile`` (h, w) tile,
    ``n_wide`` spanning the whole image (the global list) and
    ``n_scatter`` of 1-8 px anywhere, their ids interleaved at random.
    Vertices at depth 1 (exact projections).  F is padded to a multiple
    of 8 with degenerate (invalid) faces."""
    rng = np.random.default_rng(seed)
    th, tw = tile
    kind = rng.permutation(np.repeat([0, 1, 2], [n_tile, n_wide, n_scatter]))
    n = kind.size
    centre = np.stack([rng.uniform(0, image_w, n), rng.uniform(0, image_h, n)], -1)
    size = np.full(n, 4.0)
    crowded = kind == 0
    centre[crowded] = np.stack([rng.uniform(3, tw - 3, n_tile),
                                rng.uniform(th + 2, 2 * th - 2, n_tile)], -1)
    size[crowded] = 1.5
    centre[kind == 1] = (image_w / 2.0, image_h / 2.0)
    size[kind == 1] = 2.0 * max(image_w, image_h)
    px = centre[:, None, :] + rng.uniform(-1, 1, (n, 3, 2)) * size[:, None, None]
    px = np.concatenate([px, np.full((-n % 8, 3, 2), 0.5 + image_w / 2.0)])
    cam = np.ones(px.shape[:2] + (3,))
    cam[..., 0] = px[..., 0] - image_w / 2.0
    cam[..., 1] = px[..., 1] - image_h / 2.0
    return cam.astype(np.float32)


def make_scene_mesh(
    n_objects: int = 4, ground_n: int = 25, size: float = 20.0, seed: int = 0
):
    """Procedural scene: a ground plane plus boxes at random locations, with
    per-face integer class labels (ground=0, boxes=1..).

    Returns (verts (V, 3), faces (F, 3), face_labels (F,),
    object_centers) where each center is (cx, cy, height, half) —
    ``half`` is the box's true half-extent (its footprint is the
    2*half x 2*half square), so ground-truth polygons can be exact.
    """
    rng = np.random.default_rng(seed)
    verts, faces = make_grid_mesh(n=ground_n, size=size)
    labels = [np.zeros((faces.shape[0],), dtype=np.int32)]
    all_verts = [verts]
    all_faces = [faces]
    centers = []
    v_off = verts.shape[0]
    for k in range(n_objects):
        cx_, cy_ = rng.uniform(-size / 3, size / 3, 2)
        half = rng.uniform(0.5, 1.5)
        height = rng.uniform(1.0, 3.0)
        bx, bf = _box_mesh((cx_, cy_, 0.0), half, height)
        all_verts.append(bx)
        all_faces.append(bf + v_off)
        labels.append(np.full((bf.shape[0],), k + 1, dtype=np.int32))
        centers.append((cx_, cy_, height, half))
        v_off += bx.shape[0]
    return (
        np.concatenate(all_verts, axis=0),
        np.concatenate(all_faces, axis=0).astype(np.int32),
        np.concatenate(labels, axis=0),
        np.array(centers),
    )


def _box_mesh(center, half: float, height: float):
    cx, cy, z0 = center
    x0, x1 = cx - half, cx + half
    y0, y1 = cy - half, cy + half
    z1 = z0 + height
    verts = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ]
    )
    quads = [
        (4, 5, 6, 7),  # top
        (0, 1, 5, 4),  # sides
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (3, 0, 4, 7),
    ]
    faces = []
    for (a, b, c, d) in quads:
        faces.append((a, b, c))
        faces.append((a, c, d))
    return verts, np.array(faces, dtype=np.int32)
