"""Contours and binary morphology of masks in numpy: what the JAX package
asks of cv2 for its raster polygon operations (``findContours`` with
``RETR_CCOMP`` and ``CHAIN_APPROX_SIMPLE``, ``getStructuringElement``
with ``MORPH_ELLIPSE``, ``dilate`` and ``erode``).

:func:`find_contours` follows every border as Suzuki and Abe's algorithm
(and cv2's) does, without a walk per pixel.  A step of the walk is a
state (pixel, direction back to the previous pixel); its successor is
local: the first foreground neighbour counter-clockwise from the back
direction, a table lookup on the 8-neighbourhood.  The successors of all
states at once form a permutation whose cycles are the borders, and
pointer doubling finds the cycle of every border's start state and each
state's place in it.  Borders start where the raster scan starts them:
an outer border at the first pixel of each 8-connected foreground
component, a hole border left of the first pixel of each 4-connected
background component other than the one outside (``scipy.ndimage``
labels both).  The list order, start points, orientation, collinear
point removal and the two-level hierarchy are cv2's: equal to OpenCV
5.0's output contour for contour on every mask the tests draw.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy import ndimage

# direction s -> (dx, dy), counter-clockwise on screen (y down), from right
_DX = np.array([1, 1, 0, -1, -1, -1, 0, 1])
_DY = np.array([0, -1, -1, -1, 0, 1, 1, 1])


def _first_set(order) -> np.ndarray:
    """(256,) the first direction of ``order`` set in an 8-neighbour code,
    -1 where none is."""
    codes = np.arange(256)
    out = np.full(256, -1, np.int64)
    for s in order[::-1]:
        out = np.where((codes >> s) & 1, s, out)
    return out


# (code, back direction) -> the move: first foreground of back+1 .. back+8
_NEXT = np.stack(
    [_first_set([(sb + k) % 8 for k in range(1, 9)]) for sb in range(8)], axis=1
)
# a border's first move is searched clockwise from its background pixel:
# left of an outer border's start, right of a hole border's
_START_OUTER = _first_set([3, 2, 1, 0, 7, 6, 5])
_START_HOLE = _first_set([7, 6, 5, 4, 3, 2, 1])


def _cycle_labels(nxt: np.ndarray, lab: np.ndarray) -> np.ndarray:
    """Each state's least label over its forward orbit, by doubling: the
    window of each state's minimum doubles a round; once a round changes
    nothing no later round does."""
    jump = nxt
    while True:
        new = np.minimum(lab, lab[jump])
        if np.array_equal(new, lab):
            return lab
        lab, jump = new, jump[jump]


def _steps_to_end(nxt: np.ndarray) -> np.ndarray:
    """Each node's number of steps to the end of its chain (``nxt`` -1 at
    the end), by doubling."""
    d = (nxt >= 0).astype(np.int64)
    jump = nxt
    while (jump >= 0).any():
        ok = jump >= 0
        d_new = d.copy()
        d_new[ok] += d[jump[ok]]
        jump_new = jump.copy()
        jump_new[ok] = jump[jump[ok]]
        d, jump = d_new, jump_new
    return d


def find_contours(mask: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray]:
    """``cv2.findContours(mask, RETR_CCOMP, CHAIN_APPROX_SIMPLE)`` of a 2D
    mask (nonzero = foreground): (contours, each an (n, 2) int64 array of
    (x, y) pixel corners; hierarchy (N, 4) rows of (next, previous, first
    child, parent), -1 for none).  Outer borders wind counter-clockwise on
    screen (y down) from their top-left pixel, hole borders clockwise;
    holes are the children of their component's outer border, components
    inside holes are top level again."""
    m = np.pad(np.asarray(mask) != 0, 1)
    w = m.shape[1]
    flat = m.ravel()
    off = _DY * w + _DX
    # border pixels: foreground with a background 4-neighbour
    border = np.zeros_like(m)
    border[1:-1, 1:-1] = m[1:-1, 1:-1] & (
        ~m[:-2, 1:-1] | ~m[2:, 1:-1] | ~m[1:-1, :-2] | ~m[1:-1, 2:]
    )
    pix = np.flatnonzero(border)
    nb = flat[pix[:, None] + off[None, :]]  # (K, 8) foreground neighbours
    code = (nb.astype(np.int64) << np.arange(8)).sum(axis=1)
    bidx = np.full(m.size, -1, np.int64)
    bidx[pix] = np.arange(len(pix))

    # where the raster scan starts each border
    fg_lab, n_fg = ndimage.label(m, structure=np.ones((3, 3), int))
    bg_lab, _ = ndimage.label(~m)
    fl, bl = fg_lab.ravel(), bg_lab.ravel()
    u, fg_first = np.unique(fl, return_index=True)
    fg_first = fg_first[u > 0]
    u, bg_first = np.unique(bl, return_index=True)
    bg_first = bg_first[(u > 0) & (u != bl[0])]  # not the outside
    hole_pix = bg_first - 1
    start_pix = np.concatenate([fg_first, hole_pix])
    start_dir = np.concatenate([
        _START_OUTER[code[bidx[fg_first]]], _START_HOLE[code[bidx[hole_pix]]],
    ])
    is_hole = np.concatenate([
        np.zeros(len(fg_first), bool), np.ones(len(hole_pix), bool),
    ])
    order = np.argsort(np.concatenate([fg_first, bg_first]), kind="stable")
    start_pix, start_dir, is_hole = start_pix[order], start_dir[order], is_hole[order]
    comp = fl[start_pix] - 1
    n_borders = len(start_pix)
    single = start_dir < 0  # an isolated pixel: one point, no walk

    # the walk's states (border pixel k, back direction sb) -> k * 8 + sb
    n_states = len(pix) * 8
    move = _NEXT[code]  # (K, 8)
    target = bidx[pix[:, None] + off[np.maximum(move, 0)]]
    nxt = np.where(nb & (target >= 0), target * 8 + ((move + 4) & 7), n_states)
    nxt = np.append(nxt.ravel(), n_states)  # the last state is a sink
    starts = bidx[start_pix[~single]] * 8 + start_dir[~single]
    lab = np.full(n_states + 1, n_borders, np.int64)
    lab[starts] = np.flatnonzero(~single)
    lab = _cycle_labels(nxt, lab)
    on = np.flatnonzero(lab[:n_states] < n_borders)  # states of real borders
    # each border's cycle cut before its start: rank = steps to the cut
    cut = nxt[on].copy()
    is_start = np.zeros(n_states + 1, bool)
    is_start[starts] = True
    cut[is_start[cut]] = -1
    local = np.full(n_states + 1, -1, np.int64)
    local[on] = np.arange(len(on))
    cut[cut >= 0] = local[cut[cut >= 0]]
    steps = _steps_to_end(cut)
    seq = np.lexsort((-steps, lab[on]))
    states = on[seq]
    of_border = lab[on][seq]
    px = pix[states // 8]
    mv = move.ravel()[states]
    bounds = np.searchsorted(of_border, np.arange(n_borders + 1))

    contours = []
    for b in range(n_borders):
        if single[b]:
            p = np.array([start_pix[b]])
        else:
            lo, hi = bounds[b], bounds[b + 1]
            dirs = mv[lo:hi]
            # CHAIN_APPROX_SIMPLE: a pixel where the direction turns
            p = px[lo:hi][dirs != np.roll(dirs, 1)]
        contours.append(np.stack([p % w - 1, p // w - 1], axis=1))

    # RETR_CCOMP: the tree cv2 builds inserts every border first among its
    # siblings, and lists it depth first
    outer_of = np.full(n_fg, -1)
    outer_of[comp[~is_hole]] = np.flatnonzero(~is_hole)
    parent = np.where(is_hole, outer_of[comp], -1)
    tops = np.flatnonzero(~is_hole)[::-1]
    kids = {}
    for b in np.flatnonzero(is_hole)[::-1]:
        kids.setdefault(int(parent[b]), []).append(int(b))
    out = []
    for t in tops:
        out.append(int(t))
        out.extend(kids.get(int(t), []))
    pos = np.empty(n_borders, np.int64)
    pos[out] = np.arange(n_borders)
    hierarchy = np.full((n_borders, 4), -1, np.int64)
    for siblings in [tops.tolist()] + list(kids.values()):
        for a, b in zip(siblings[:-1], siblings[1:]):
            hierarchy[pos[a], 0] = pos[b]
            hierarchy[pos[b], 1] = pos[a]
    for p, children in kids.items():
        hierarchy[pos[p], 2] = pos[children[0]]
        hierarchy[pos[children], 3] = pos[p]
    return [contours[b] for b in out], hierarchy


def ellipse_kernel(k: int) -> np.ndarray:
    """(k, k) bool: ``cv2.getStructuringElement(MORPH_ELLIPSE, (k, k))``."""
    if k == 1:
        return np.ones((1, 1), bool)
    r = c = k // 2
    out = np.zeros((k, k), bool)
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            # cv2's saturate_cast rounds half to even, as np.rint does
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) / (r * r))))
            out[i, max(c - dx, 0):min(c + dx + 1, k)] = True
    return out


def _row_distance(mask: np.ndarray) -> np.ndarray:
    """Per pixel, the distance along its row to the nearest foreground
    pixel (2^30 or more when the row has none)."""
    w = mask.shape[1]
    x = np.arange(w, dtype=np.int32)
    far = np.int32(2 ** 30)
    left = np.maximum.accumulate(np.where(mask, x, -far), axis=1)
    right = np.minimum.accumulate(np.where(mask, x, far)[:, ::-1], axis=1)[:, ::-1]
    return np.minimum(x - left, right - x)


def dilate(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate`` of a bool mask with an odd-sized bool kernel anchored
    at its centre whose rows are each one run centred on the anchor's
    column, as an ellipse's are (pixels outside the image count as
    background).  Each kernel row is one test on the row distance to the
    foreground, shifted by the row's offset: no pass over the kernel's
    pixels."""
    mask = np.asarray(mask, bool)
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h = mask.shape[0]
    dist = _row_distance(mask)
    out = np.zeros_like(mask)
    for i in range(kh):
        cols = np.flatnonzero(kernel[i])
        dy = i - ay
        if not len(cols) or abs(dy) >= h:
            continue
        reach = int(cols[-1]) - ax
        if int(cols[0]) - ax != -reach or len(cols) != 2 * reach + 1:
            raise ValueError("each kernel row must be one run centred on the anchor")
        hit = dist[max(dy, 0):h + min(dy, 0)] <= reach
        if dy >= 0:
            out[:h - dy] |= hit
        else:
            out[-dy:] |= hit
    return out


def erode(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.erode`` of a bool mask with a kernel :func:`dilate` takes
    (pixels outside the image count as foreground, cv2's default
    border)."""
    return ~dilate(~np.asarray(mask, bool), kernel)
