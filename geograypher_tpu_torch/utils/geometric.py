"""Face orderings for tile binning (numpy, on the host).

Port of ``serpentine_face_order`` and ``partitioned_face_order`` of
``geograypher_tpu/utils/geometric.py``; the tests hold both orders equal
to the JAX package's.
"""

from __future__ import annotations

import numpy as np


def serpentine_face_order(
    centroids_2d: np.ndarray, rows_per_bin: float = 2.0
) -> np.ndarray:
    """Scanline face permutation with x reversed on odd scanline rows, so
    consecutive ids stay spatially adjacent across row turns and a
    ``bin_block`` id block never spans the image at a row wrap.

    ``rows_per_bin`` is the scanline bin height in units of the mesh's
    natural face-row pitch; 2.0 keeps id blocks about 2 face rows tall by
    4 faces wide.

    Returns ``order`` with ``new_faces = faces[order]``.
    """
    cent = np.asarray(centroids_2d, np.float64)
    n_bins = max(int(np.sqrt(len(cent)) / max(rows_per_bin, 1e-9)), 1)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    y_bin = np.minimum(
        ((cent[:, 1] - lo[1]) / span[1] * n_bins).astype(np.int64),
        n_bins - 1,
    )
    x_key = np.where(y_bin % 2 == 1, -cent[:, 0], cent[:, 0])
    return np.lexsort((x_key, y_bin))


def partitioned_face_order(
    face_verts_2d: np.ndarray,
    rows_per_bin: float = 2.0,
    big_factor: float = 8.0,
    return_split: bool = False,
):
    """Serpentine face permutation with oversized faces (xy-bbox diagonal
    above ``big_factor`` x the median) packed into their own trailing id
    range.

    With ``return_split`` it also returns the new index of the first
    oversized face (the number of regular faces), which
    ``RasterConfig.global_from`` takes so binning pins that tail to the
    global list.  A regular mesh comes out in plain serpentine order.
    """
    fv = np.asarray(face_verts_2d, np.float64)
    span = fv.max(axis=1) - fv.min(axis=1)
    diag = np.hypot(span[:, 0], span[:, 1])
    med = np.median(diag)
    big = diag > big_factor * max(med, 1e-300)
    cent = fv.mean(axis=1)
    if not big.any():
        order = serpentine_face_order(cent, rows_per_bin)
        return (order, len(order)) if return_split else order
    small_idx = np.flatnonzero(~big)
    big_idx = np.flatnonzero(big)
    order_small = serpentine_face_order(cent[small_idx], rows_per_bin)
    order_big = serpentine_face_order(cent[big_idx], rows_per_bin)
    order = np.concatenate([small_idx[order_small], big_idx[order_big]])
    return (order, len(small_idx)) if return_split else order
