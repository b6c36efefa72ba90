"""A plain z-buffer rasterizer and the survey aggregation over it.

Semantics (those the program documents for its raster chain): a pinhole
camera (camera x right, y down, z the view), pixel (i, j) sampled at its
centre (j + 0.5, i + 0.5); a face covers a pixel when all three edge
functions there are >= 0 on either winding; the face with the largest
perspective-correct 1/z wins, ties to the lowest face id; a face with a
vertex at or behind ``znear``, or (with a lens) a vertex past 1.3 times the
image corner's ideal radius, is dropped.  A Brown-Conrady lens (Metashape's
frame camera: k1-k4, p1, p2, b1, b2) warps the vertices into the sensor's
distorted pixels, where the faces are rasterized as straight triangles.

Every number is computed in ``dtype``: float64 for the reference, and a
lower precision for the control.  The depth test packs the 1/z value, as
float32 bits, with the face id into one int64 key per candidate pixel, so
one ``scatter_reduce`` resolves a view.
"""

from __future__ import annotations

import numpy as np
import torch

ZNEAR = 1e-6
LENS_DOMAIN = 1.69  # (1.3 x the image corner's ideal radius) squared
_ID_MASK = (1 << 31) - 1


def camera_params(c2w: np.ndarray, sensor: dict):
    """World-to-camera (4, 4) float64 and the intrinsics of one view."""
    dist = sensor.get("distortion", {})
    keys = ("k1", "k2", "k3", "k4", "p1", "p2", "b1", "b2")
    return (np.linalg.inv(np.asarray(c2w, np.float64)), float(sensor["f"]),
            float(sensor.get("cx", 0.0)), float(sensor.get("cy", 0.0)),
            np.array([float(dist.get(k, 0.0)) for k in keys]))


def project(verts: torch.Tensor, w2c, f, cx, cy, dist, width: int, height: int,
            dtype=torch.float64):
    """Vertices (V, 3) -> (sx, sy, inv_z, ok) in ``dtype`` on the vertices'
    device: screen position, 1/z, and whether the vertex may take part
    (in front of ``znear`` and, with a lens, inside its domain)."""
    dev = verts.device
    v = verts.to(dtype)
    m = torch.as_tensor(np.asarray(w2c), dtype=dtype, device=dev)
    cam = v @ m[:3, :3].T + m[:3, 3]
    z = cam[:, 2]
    ok = z > ZNEAR
    inv_z = 1.0 / torch.where(ok, z, torch.ones_like(z))
    xn, yn = cam[:, 0] * inv_z, cam[:, 1] * inv_z
    k1, k2, k3, k4, p1, p2, b1, b2 = (float(d) for d in dist)
    if not any((k1, k2, k3, k4, p1, p2, b1, b2, cx, cy)):
        return xn * f + width / 2.0, yn * f + height / 2.0, inv_z, ok
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = xn * radial + p1 * (r2 + 2.0 * xn * xn) + 2.0 * p2 * xn * yn
    yd = yn * radial + p2 * (r2 + 2.0 * yn * yn) + 2.0 * p1 * xn * yn
    sx = width / 2.0 + cx + xd * (f + b1) + yd * b2
    sy = height / 2.0 + cy + yd * f
    corner2 = ((width / 2.0 + abs(cx)) ** 2 + (height / 2.0 + abs(cy)) ** 2) / (f * f)
    return sx, sy, inv_z, ok & (r2 <= corner2 * LENS_DOMAIN)


def face_boxes(sx, sy, ok, faces: torch.Tensor, width: int, height: int):
    """Per face: its three screen corners (F, 3) x 2, whether it is in front
    (every vertex ``ok``), and its pixel-centre box clipped to the image as
    (x0, y0, nx, ny), with nx = ny = 0 where the clipped box is empty."""
    x, y = sx[faces], sy[faces]
    front = ok[faces].all(dim=1)
    x0 = torch.ceil(x.min(dim=1).values.double() - 0.5).clamp(0, width)
    x1 = torch.floor(x.max(dim=1).values.double() - 0.5).clamp(-1, width - 1)
    y0 = torch.ceil(y.min(dim=1).values.double() - 0.5).clamp(0, height)
    y1 = torch.floor(y.max(dim=1).values.double() - 0.5).clamp(-1, height - 1)
    nx = (x1 - x0 + 1).clamp(min=0).long()
    ny = (y1 - y0 + 1).clamp(min=0).long()
    live = front & (nx > 0) & (ny > 0)
    nx, ny = torch.where(live, nx, 0), torch.where(live, ny, 0)
    return x, y, front, (x0.long(), y0.long(), nx, ny)


def candidate_pixels(face_boxes_out) -> int:
    """Pixels in the clipped boxes of the faces in front of the camera."""
    _, _, _, (_, _, nx, ny) = face_boxes_out
    return int((nx * ny).sum())


def rasterize(verts: torch.Tensor, faces: torch.Tensor, w2c, f, cx, cy, dist,
              width: int, height: int, dtype=torch.float64,
              chunk_pixels: int = 1 << 23) -> torch.Tensor:
    """(H, W) int64 pix2face (-1 where no face is seen) of one view;
    ``faces`` (F, 3) int64 on the vertices' device."""
    sx, sy, inv_z, ok = project(verts, w2c, f, cx, cy, dist, width, height, dtype)
    x, y, _, (bx0, by0, nx, ny) = face_boxes(sx, sy, ok, faces, width, height)
    w = inv_z[faces]
    npix = nx * ny
    best = torch.full((height * width,), -1, dtype=torch.int64, device=verts.device)
    ends = torch.cumsum(npix, 0)
    start = 0
    while start < len(npix):
        # faces [start, stop) whose candidates fit one chunk
        base = int(ends[start - 1]) if start else 0
        stop = int(torch.searchsorted(ends, base + chunk_pixels, right=True))
        stop = max(stop, start + 1)
        _resolve(best, torch.arange(start, stop, device=verts.device), x, y, w,
                 bx0, by0, nx, npix, width)
        start = stop
    return torch.where(best >= 0, _ID_MASK - (best & 0xFFFFFFFF), -1).view(height, width)


def _resolve(best, ids, x, y, w, bx0, by0, nx, npix, width):
    """Fold the candidate pixels of faces ``ids`` into the per-pixel keys."""
    counts = npix[ids]
    total = int(counts.sum())
    if total == 0:
        return
    face = torch.repeat_interleave(ids, counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    off = torch.arange(total, device=ids.device) - first
    col = bx0[face] + off % nx[face]
    row = by0[face] + off // nx[face]
    dtype = x.dtype
    px, py = col.to(dtype) + 0.5, row.to(dtype) + 0.5
    xf, yf = x[face], y[face]

    def edge(a, b):
        # E(p) = (xb - xa)(py - ya) - (yb - ya)(px - xa), zero on edge a->b
        return ((xf[:, b] - xf[:, a]) * (py - yf[:, a])
                - (yf[:, b] - yf[:, a]) * (px - xf[:, a]))

    e0, e1, e2 = edge(1, 2), edge(2, 0), edge(0, 1)
    area2 = ((xf[:, 2] - xf[:, 1]) * (yf[:, 0] - yf[:, 1])
             - (yf[:, 2] - yf[:, 1]) * (xf[:, 0] - xf[:, 1]))
    sign = torch.where(area2 < 0, -1.0, 1.0).to(dtype)
    e0, e1, e2 = e0 * sign, e1 * sign, e2 * sign
    covered = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (area2.abs() > 1e-12)
    wf = w[face]
    inv_z = (e0 * wf[:, 0] + e1 * wf[:, 1] + e2 * wf[:, 2]) / (area2 * sign)
    depth = inv_z.float().clamp(min=0).view(torch.int32).long()
    key = (depth << 32) | (_ID_MASK - face)
    pix = row * width + col
    best.scatter_reduce_(0, pix[covered], key[covered], reduce="amax")


def aggregate(verts: np.ndarray, faces: np.ndarray, survey, sensors: list,
              labels: np.ndarray, width: int, height: int, n_classes: int,
              device, dtype=torch.float64):
    """A survey's (fraction_sums (F, C), view_counts (F,)) as float64
    numpy, faces in the order of ``faces``: each view adds, for every face it sees with a labelled pixel,
    that face's class fractions (class pixels / labelled pixels) and a 1,
    both added up in ``dtype``.
    ``labels`` is the label pool and ``survey.label`` each view's entry."""
    v = torch.as_tensor(verts, device=device)
    fc = torch.as_tensor(faces, device=device).long()
    n_faces = len(faces)
    sums = torch.zeros(n_faces * n_classes, dtype=dtype, device=device)
    seen = torch.zeros(n_faces, dtype=dtype, device=device)
    for k in range(len(survey)):
        w2c, f, cx, cy, dist = camera_params(survey.c2w[k], sensors[survey.sensor[k]])
        p2f = rasterize(v, fc, w2c, f, cx, cy, dist, width, height, dtype).view(-1)
        lab = torch.as_tensor(labels[survey.label[k]], device=device).view(-1).long()
        use = (p2f >= 0) & (lab >= 0) & (lab < n_classes)
        counts = torch.bincount(p2f[use] * n_classes + lab[use],
                                minlength=n_faces * n_classes).view(n_faces, n_classes)
        total = counts.sum(dim=1)
        hit = total > 0
        frac = counts.to(dtype) / total.clamp(min=1).to(dtype)[:, None]
        sums += frac.view(-1)
        seen += hit.to(dtype)
    return (sums.view(n_faces, n_classes).double().cpu().numpy(),
            seen.double().cpu().numpy())


def ideal_of_warped(width: int, height: int, f, cx, cy, dist, device, dtype,
                    iterations: int = 40):
    """(rows, cols) of the ideal (pinhole, centred) image that each pixel
    index (i, j) of the lens's image sees: the Brown-Conrady warp inverted
    by fixed-point iteration, each a (H, W) tensor in ``dtype``."""
    k1, k2, k3, k4, p1, p2, b1, b2 = (float(d) for d in dist)
    rows = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    cols = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    yd = (rows - height / 2.0 - cy) / f
    xd = (cols - width / 2.0 - cx - yd * b2) / (f + b1)
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        tx = p1 * (r2 + 2.0 * x * x) + 2.0 * p2 * x * y
        ty = p2 * (r2 + 2.0 * y * y) + 2.0 * p1 * x * y
        x, y = (xd - tx) / radial, (yd - ty) / radial
    return y * f + height / 2.0, x * f + width / 2.0


def render_mask(verts: torch.Tensor, faces: torch.Tensor, texture: torch.Tensor,
                c2w, sensor: dict, width: int, height: int,
                dtype=torch.float64) -> torch.Tensor:
    """(H, W) uint8 label mask of one view: each pixel the class of the face
    it sees (``texture`` (F,), NaN where a face has none), 255 where no
    face or no class.  A lens's view is the pinhole render, resampled at
    each pixel's nearest ideal pixel (half to even), -1 outside it."""
    w2c, f, _, _, dist = camera_params(c2w, sensor)
    cx, cy = float(sensor.get("cx", 0.0)), float(sensor.get("cy", 0.0))
    p2f = rasterize(verts, faces, w2c, f, 0.0, 0.0, np.zeros(8), width, height, dtype)
    if any(dist) or cx or cy:
        rows, cols = ideal_of_warped(width, height, f, cx, cy, dist, verts.device, dtype)
        ri, ci = torch.round(rows).long(), torch.round(cols).long()
        inside = (ri >= 0) & (ri < height) & (ci >= 0) & (ci < width)
        p2f = torch.where(inside, p2f[ri.clamp(0, height - 1), ci.clamp(0, width - 1)], -1)
    value = texture[p2f.clamp(min=0)]
    value = torch.where((p2f >= 0) & torch.isfinite(value), value, 255.0)
    return value.clamp(0, 255).to(torch.uint8)
