"""The plain reference of a detection projection: each view's boxes
painted as detection ids, its pix2face through the lens at the aggregation
scale, and the (face, detection) pixel counts, the views that see each
face and each face's most-seen detection.

Semantics (those the program documents for ``project_detections``):

* the tables: every ``*.csv`` file of a folder in the order of the
  files' names, rows in file order; detection ``d`` is the ``d``-th row
  over them, and a row belongs to the view whose image file has the
  row's ``image_path``'s file name;
* the painting, at scale ``s``: row ``(xmin, ymin, xmax, ymax)`` covers
  the rows ``[trunc(ymin s), trunc(ymax s))`` and the columns
  ``[trunc(xmin s), trunc(xmax s))`` of the scaled image (clipped to it),
  and a pixel takes the detection of the last row, in table order, that
  covers it; no row, no detection;
* pix2face at scale ``s``: the pinhole z-buffer of ``raster.py`` at
  focal length ``f s`` over the ``(int(H s), int(W s))`` image; with a
  lens, scaled pixel ``(i, j)`` samples the full-size sensor at
  ``(i / s + 1 / (2 s), j / s + 1 / (2 s))``, finds there the ideal
  (pinhole) position of the Brown-Conrady warp's inverse, and reads the
  pinhole render at that position times ``s`` rounded half to even (no
  face outside it);
* a view with no painted pixel adds nothing; any other view adds, for
  every (face, detection) pair, its pixels, and 1 to every face it sees;
* a face's label is the detection with the most pixels over the survey,
  ties to the lowest id; a face with no pixel of any detection has none.

Every geometric number is computed in ``dtype``: float64 for the
reference, a lower precision for the control.  Nothing here imports the
program.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import raster

BOX_KEYS = ("xmin", "ymin", "xmax", "ymax")
_PAINT_CHUNK = 16  # boxes painted at once


def read_tables(folder) -> dict:
    """{image file name: ((n, 4) float64 xmin, ymin, xmax, ymax, (n,) int64
    detection ids)} of the ``*.csv`` files of ``folder``."""
    rows = {}
    det = 0
    for path in sorted(Path(folder).glob("*.csv")):
        with open(path, newline="") as fh:
            for row in csv.DictReader(fh):
                name = Path(row["image_path"]).name
                rows.setdefault(name, []).append(
                    ([float(row[k]) for k in BOX_KEYS], det))
                det += 1
    return {name: (np.array([b for b, _ in r], np.float64).reshape(-1, 4),
                   np.array([d for _, d in r], np.int64))
            for name, r in rows.items()}


def paint(boxes: np.ndarray, ids: np.ndarray, height: int, width: int, scale: float,
          device) -> torch.Tensor:
    """(int(H s), int(W s)) int64 detection ids of one view, -1 where no box
    covers a pixel: each pixel the largest table position among the boxes
    covering it (the last row painted)."""
    h, w = int(height * scale), int(width * scale)
    out = torch.full((h, w), -1, dtype=torch.int64, device=device)
    if len(ids) == 0:
        return out
    b = torch.trunc(torch.as_tensor(boxes, dtype=torch.float64, device=device) * scale)
    j0, i0, j1, i1 = b.long().unbind(1)
    d = torch.as_tensor(ids, device=device)
    r = torch.arange(h, device=device)
    c = torch.arange(w, device=device)
    for k in range(0, len(d), _PAINT_CHUNK):
        sl = slice(k, k + _PAINT_CHUNK)
        rows = (r[None, :] >= i0[sl, None]) & (r[None, :] < i1[sl, None])
        cols = (c[None, :] >= j0[sl, None]) & (c[None, :] < j1[sl, None])
        cover = rows[:, :, None] & cols[:, None, :]
        top = torch.where(cover, d[sl, None, None], -1).amax(0)
        out = torch.maximum(out, top)
    return out


def ideal_of_warped_scaled(width: int, height: int, f, cx, cy, dist, scale: float,
                           device, dtype, iterations: int = 40):
    """(rows, cols) in the scaled ideal image that each scaled pixel of the
    lens's image reads (see the module's semantics), each (int(H s),
    int(W s)) in ``dtype``."""
    k1, k2, k3, k4, p1, p2, b1, b2 = (float(v) for v in dist)
    h, w = int(height * scale), int(width * scale)
    rows = (torch.arange(h, dtype=dtype, device=device) / scale
            + 1.0 / (2.0 * scale))[:, None].expand(h, w)
    cols = (torch.arange(w, dtype=dtype, device=device) / scale
            + 1.0 / (2.0 * scale))[None, :].expand(h, w)
    yd = (rows - height / 2.0 - cy) / f
    xd = (cols - width / 2.0 - cx - yd * b2) / (f + b1)
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        tx = p1 * (r2 + 2.0 * x * x) + 2.0 * p2 * x * y
        ty = p2 * (r2 + 2.0 * y * y) + 2.0 * p1 * x * y
        x, y = (xd - tx) / radial, (yd - ty) / radial
    return (y * f + height / 2.0) * scale, (x * f + width / 2.0) * scale


def pix2face(verts: torch.Tensor, faces: torch.Tensor, c2w, sensor: dict, width: int,
             height: int, scale: float, dtype=torch.float64, lens=None) -> torch.Tensor:
    """(int(H s), int(W s)) int64 pix2face of one view at ``scale``, -1
    where no face is seen (``faces`` (F, 3) int64 on the vertices'
    device; ``lens``: the sensor's :func:`ideal_of_warped_scaled`, made
    here when not given)."""
    w2c, f, cx, cy, dist = raster.camera_params(c2w, sensor)
    h, w = int(height * scale), int(width * scale)
    p2f = raster.rasterize(verts, faces, w2c, f * scale, 0.0, 0.0, np.zeros(8), w, h,
                           dtype)
    if any(dist) or cx or cy:
        rows, cols = lens or ideal_of_warped_scaled(width, height, f, cx, cy, dist,
                                                    scale, verts.device, dtype)
        ri, ci = torch.round(rows).long(), torch.round(cols).long()
        inside = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
        p2f = torch.where(inside, p2f[ri.clamp(0, h - 1), ci.clamp(0, w - 1)], -1)
    return p2f


def project(verts: np.ndarray, faces: np.ndarray, survey, sensors: list, names: list,
            tables: dict, width: int, height: int, scale: float, device,
            dtype=torch.float64):
    """A survey's ((n, 3) int64 face, detection, pixel count rows, sorted;
    (F,) float64 views that see each face) as numpy; view k's image file
    is ``names[k]`` and its rows ``tables[names[k]]`` (none where absent)."""
    v = torch.as_tensor(verts, device=device)
    fc = torch.as_tensor(faces, device=device).long()
    seen = torch.zeros(len(faces), dtype=torch.float64, device=device)
    pairs = []
    n_det = 1 + max((int(ids.max()) for _, ids in tables.values() if len(ids)),
                    default=0)
    lenses = {}  # each sensor's map, made once
    for k in range(len(survey)):
        boxes, ids = tables.get(names[k], (np.zeros((0, 4)), np.zeros(0, np.int64)))
        det = paint(boxes, ids, height, width, scale, device).view(-1)
        if not bool((det >= 0).any()):
            continue
        sensor = sensors[survey.sensor[k]]
        _, f, cx, cy, dist = raster.camera_params(survey.c2w[k], sensor)
        if int(survey.sensor[k]) not in lenses and (any(dist) or cx or cy):
            lenses[int(survey.sensor[k])] = ideal_of_warped_scaled(
                width, height, f, cx, cy, dist, scale, device, dtype)
        p2f = pix2face(v, fc, survey.c2w[k], sensor, width, height, scale, dtype,
                       lenses.get(int(survey.sensor[k]))).view(-1)
        seen[torch.unique(p2f[p2f >= 0])] += 1.0
        use = (p2f >= 0) & (det >= 0)
        key, count = torch.unique(p2f[use] * n_det + det[use], return_counts=True)
        pairs.append(torch.stack([key // n_det, key % n_det, count], 1))
    rows = (torch.cat(pairs) if pairs else torch.zeros((0, 3), dtype=torch.int64,
                                                       device=device))
    rows = rows.cpu().numpy()
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))], seen.cpu().numpy()


def labels(rows: np.ndarray, n_faces: int) -> np.ndarray:
    """(F,) float64 most-seen detection of each face from ``project``'s
    rows, ties to the lowest id; NaN where a face has no pixel of any."""
    out = np.full(n_faces, np.nan)
    if len(rows):
        order = np.lexsort((rows[:, 1], -rows[:, 2], rows[:, 0]))
        face = rows[order, 0]
        first = np.ones(len(face), bool)
        first[1:] = face[1:] != face[:-1]
        out[face[first]] = rows[order][first, 1]
    return out
