"""Filling an integer-vertex polygon into an image as ``cv2.fillPoly``
does with its defaults (8-connected lines, no sub-pixel shift), in numpy.

cv2 fills a polygon in two parts, and so does :func:`fill_poly`:

* the outline: each edge drawn as an 8-connected Bresenham line from its
  left end (``LineIterator`` with ``leftToRight``), horizontal edges
  included;
* the scanline fill: each non-horizontal edge covers the rows ``[y_top,
  y_bottom)``, its x in 16.16 fixed point starting at its top vertex and
  stepping by the truncated quotient ``((x_b - x_a) << 16) / (y_b -
  y_a)`` a row; in every row the sorted crossings pair up into spans
  from ``x_left`` rounded half up to ``x_right`` rounded down, clipped
  to the image.

Equal to cv2 (checked against OpenCV 5.0) on polygons inside the image,
and on axis-aligned rectangles anywhere.  Where a slanted edge leaves the
image, the edge is clipped to the image as cv2 clips it, and cv2 still
draws some pixels of the image's outermost rows and columns otherwise
(it fills the border column beside a polygon that lies wholly outside,
for one): every difference found lies on the image's border (ROADMAP C4).
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` to the image ``[0, w) x [0, h)``: (inside, x1,
    y1, x2, y2).  The endpoints move even when the result is outside, as
    in cv2, whose callers read them either way."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w, h, *pts) -> bool:
    return any(not (0 <= x < w and 0 <= y < h) for x, y in pts)


def _line_pixels(x0: int, y0: int, x1: int, y1: int):
    """(xs, ys) of cv2's 8-connected line from (x0, y0) to (x1, y1)
    inside the image (its ``LineIterator``, left to right)."""
    if x1 < x0:  # left to right
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # minor steps before point k: the least m with 2 major m + major >=
    # 2 minor k (Bresenham's error term, err = major - 2 minor at k = 0)
    m = np.maximum(0, -((major - 2 * minor * k) // (2 * major))) if major else k
    if steep:
        return x0 + m, y0 + sy * k
    return x0 + k, y0 + sy * m


def fill_poly(img: np.ndarray, pts: np.ndarray, value) -> np.ndarray:
    """Fill the polygon ``pts`` ((N, 2) integer (x, y) vertices) with
    ``value`` in the 2D array ``img``, in place, as ``cv2.fillPoly(img,
    [pts], value)``; returns ``img``."""
    pts = np.asarray(pts, dtype=np.int64).reshape(-1, 2)
    h, w = img.shape[:2]
    n = len(pts)
    if n == 0:
        return img
    a = np.roll(pts, 1, axis=0)  # edge k runs from pts[k - 1] to pts[k]
    b = pts
    # the outline: each edge clipped to the image, then drawn
    for (xa, ya), (xb, yb) in zip(a.tolist(), b.tolist()):
        ends = (xa, ya, xb, yb)
        if _outside(w, h, (xa, ya), (xb, yb)):
            inside, *ends = _clip_line(w, h, xa, ya, xb, yb)
            if not inside:
                continue
        xs, ys = _line_pixels(*ends)
        img[ys, xs] = value
    # the scanline fill over the non-horizontal edges; an edge that
    # leaves the image takes its slope and start from its clipped ends
    edges = []
    for (xa, ya), (xb, yb) in zip(a.tolist(), b.tolist()):
        if ya == yb:
            continue
        ca, cb = (xa << XY_SHIFT, ya), (xb << XY_SHIFT, yb)
        if _outside(w, h, (xa, ya), (xb, yb)):
            _, x0c, y0c, x1c, y1c = _clip_line(w, h, xa, ya, xb, yb)
            if y0c != y1c:
                ca, cb = (x0c << XY_SHIFT, y0c), (x1c << XY_SHIFT, y1c)
        num, den = cb[0] - ca[0], cb[1] - ca[1]
        step = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)  # C's /
        top = ca if ya < yb else cb
        y0 = min(ya, yb)
        edges.append((y0, max(ya, yb), top[0] + (y0 - top[1]) * step, step))
    if len(edges) < 2:
        return img
    y_top, y_bot, x_top, step = (np.array(c, dtype=np.int64) for c in zip(*edges))
    y_lo, y_hi = max(int(y_top.min()), 0), min(int(y_bot.max()), h)
    if y_lo >= y_hi:
        return img
    ys = np.arange(y_lo, y_hi, dtype=np.int64)[:, None]
    active = (ys >= y_top[None]) & (ys < y_bot[None])
    xs = x_top[None] + (ys - y_top[None]) * step[None]
    big = np.iinfo(np.int64).max
    xs = np.sort(np.where(active, xs, big), axis=1)
    for k in range(0, xs.shape[1] - 1, 2):
        x_l, x_r = xs[:, k], xs[:, k + 1]
        ok = x_r != big
        x1 = np.maximum((x_l + (1 << (XY_SHIFT - 1))) >> XY_SHIFT, 0)
        x2 = np.minimum(x_r >> XY_SHIFT, w - 1)
        ok &= (x1 < w) & (x2 >= 0) & (x1 <= x2)
        for y, lo, hi in zip(ys[ok, 0].tolist(), x1[ok].tolist(), x2[ok].tolist()):
            img[y, lo:hi + 1] = value
    return img
