"""Inputs of a cell, made from its configuration and the run's seed.

Everything here is numpy: the mesh of a deployment (made by
``meshes/<kind>.py``), the poses of each survey, and the label pools.  The
program under test and the plain reference receive the same arrays.  Nothing imports the program.

A survey's poses follow the bench suite of the repository's first
benchmark: even views nadir with seeded jitter, odd views oblique at a
seeded pitch and azimuth, the focal lengths in turn.  The label images
are constant over seeded squares, as a segmentor's class maps are
spatially coherent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# streams of one seed: each use draws from its own, so adding a use moves
# none of the others
STREAM_LABELS = 1
STREAM_SURVEY = 2
STREAM_WARMUP = 3
STREAM_SAMPLE = 4


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    """A generator for one use of ``seed`` (any non-negative whole number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream, *more]))


def make_mesh(mesh: dict):
    """The configuration's ``mesh`` entry -> (verts, faces): the ``make``
    of ``meshes/<kind>.py`` called with the entry's other keys."""
    from benchmark import cells

    params = {k: v for k, v in mesh.items() if k != "kind"}
    return cells.plugin("meshes", mesh["kind"]).make(**params)


def nadir_c2w(height: float) -> np.ndarray:
    """Camera-to-world of a camera looking straight down from ``height``
    (camera x right, y down, z the view; image up is world +y)."""
    return np.array([[1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0],
                     [0.0, 0.0, -1.0, height], [0.0, 0.0, 0.0, 1.0]])


def oblique_c2w(distance: float, pitch_deg: float, azimuth_deg: float) -> np.ndarray:
    """Camera-to-world of a camera ``pitch_deg`` off nadir at
    ``azimuth_deg``, ``distance`` from the origin and looking at it."""
    pitch, az = np.deg2rad(pitch_deg), np.deg2rad(azimuth_deg)
    eye = distance * np.array([np.sin(pitch) * np.cos(az),
                               np.sin(pitch) * np.sin(az), np.cos(pitch)])
    z_cam = -eye / np.linalg.norm(eye)
    x_cam = np.cross(z_cam, np.array([0.0, 0.0, 1.0]))
    x_cam = x_cam / np.linalg.norm(x_cam)
    y_cam = np.cross(z_cam, x_cam)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x_cam, y_cam, z_cam, eye
    return c2w


@dataclasses.dataclass
class Survey:
    """One survey's views: poses (N, 4, 4) camera-to-world float64, the
    sensor of each view (an index into the configuration's ``sensors``)
    and the label image of each view (an index into the label pool)."""

    c2w: np.ndarray
    sensor: np.ndarray
    label: np.ndarray

    def __len__(self) -> int:
        return len(self.sensor)


@dataclasses.dataclass
class Done:
    """One finished survey of the window: its index, its inputs and what
    the program returned."""

    index: int
    survey: Survey
    result: object


def survey(views: dict, sensors: list, width: int, n_views: int, n_labels: int,
           gen: np.random.Generator) -> Survey:
    """``n_views`` poses of the configuration's ``views`` suite: even views
    nadir with jitter, odd views oblique; view k uses sensor
    ``k % len(sensors)``, from the distance at which the scene spans the
    image's width at that sensor's focal length."""
    size = views["scene_width"]
    jx, jz = views["nadir_jitter_xy"], views["nadir_jitter_z"]
    lo, hi = views["oblique_pitch_deg"]
    c2w = np.empty((n_views, 4, 4))
    sensor = np.arange(n_views) % len(sensors)
    for k in range(n_views):
        d = size * sensors[sensor[k]]["f"] / width
        if k % 2 == 0:
            c2w[k] = nadir_c2w(d)
            c2w[k, 0, 3] += gen.uniform(-jx, jx)
            c2w[k, 1, 3] += gen.uniform(-jx, jx)
            c2w[k, 2, 3] += gen.uniform(0.0, jz)
        else:
            c2w[k] = oblique_c2w(d, gen.uniform(lo, hi), gen.uniform(0.0, 360.0))
    first = gen.integers(n_labels)
    return Survey(c2w, sensor, (first + np.arange(n_views)) % n_labels)


def label_pool(n: int, height: int, width: int, n_classes: int, patch: int,
               gen: np.random.Generator) -> np.ndarray:
    """(n, H, W) int8 class images, each constant over ``patch``-pixel
    squares of seeded classes in ``[0, n_classes)``."""
    rows, cols = -(-height // patch), -(-width // patch)
    squares = gen.integers(0, n_classes, (n, rows, cols), dtype=np.int8)
    full = np.repeat(np.repeat(squares, patch, axis=1), patch, axis=2)
    return np.ascontiguousarray(full[:, :height, :width])


def label_polygons(size: float, n: int, radius: tuple, gen: np.random.Generator):
    """``n`` seeded star polygons of nine corners in a 3-column grid over
    the scene, each ``radius`` (a range, in scene widths) from its centre:
    about half of the surface.  A list of (ring (9, 2), class k % 4)."""
    polys = []
    for k in range(n):
        cx = (k % 3 - 1) * size / 3 + gen.uniform(-0.05, 0.05) * size
        cy = (k // 3 - 0.5) * size / 2 + gen.uniform(-0.05, 0.05) * size
        ang = np.sort(gen.uniform(0, 2 * np.pi, 9))
        r = gen.uniform(radius[0], radius[1], (9, 1)) * size
        polys.append((np.array([cx, cy]) + r * np.stack([np.cos(ang), np.sin(ang)], 1),
                      k % 4))
    return polys


def face_classes(verts: np.ndarray, faces: np.ndarray, polygons) -> np.ndarray:
    """(F,) float32 per-face class: the class of the last polygon holding
    the face's centroid in xy (even-odd rule), NaN where none does."""
    centre = verts[faces].mean(axis=1)[:, :2]
    out = np.full(len(faces), np.nan, np.float32)
    for ring, cls in polygons:
        inside = np.zeros(len(faces), bool)
        for (x0, y0), (x1, y1) in zip(ring, np.roll(ring, -1, axis=0)):
            crosses = (y0 > centre[:, 1]) != (y1 > centre[:, 1])
            t = (centre[:, 1] - y0) / np.where(y1 != y0, y1 - y0, 1.0)
            inside ^= crosses & (centre[:, 0] < x0 + t * (x1 - x0))
        out[inside] = cls
    return out
