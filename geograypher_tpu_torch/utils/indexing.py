"""Indexing and map inversion: the port's own copy of
``geograypher_tpu/utils/indexing.py`` (numpy, and scipy's ``griddata``).

``find_argmax_nonzero_value`` is the port's tensor version in
``ops/aggregate.py``, re-exported here.  ``inverse_map_interpolation`` is
kept for the generic warps with no analytic inverse; lens distortion
inverts its warp directly (``cameras/distortion.py``).
"""

from __future__ import annotations

import typing

import numpy as np

from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value

__all__ = ["find_argmax_nonzero_value", "determine_IDs_to_labels",
           "inverse_map_interpolation"]


def determine_IDs_to_labels(
    texture_array: np.ndarray,
    all_discrete_texture_values: typing.Optional[list] = None,
    background_ID: typing.Optional[int] = None,
) -> typing.Optional[dict]:
    """Unique-value -> integer-ID mapping for discrete textures, or None
    for truly continuous data (reference indexing.py:35-85)."""
    texture_array = np.asarray(texture_array)
    if texture_array.dtype == float:
        finite = texture_array[np.isfinite(texture_array)]
        if finite.size and not np.allclose(finite, finite.astype(int)):
            return None
    source = (
        texture_array
        if all_discrete_texture_values is None
        else np.asarray(all_discrete_texture_values)
    )
    unique_values = np.unique(source[~_isnan_safe(source)])
    IDs_to_labels = {}
    i = 0
    for v in unique_values:
        if background_ID is not None and i == background_ID:
            i += 1
        IDs_to_labels[i] = v.item() if hasattr(v, "item") else v
        i += 1
    return IDs_to_labels


def _isnan_safe(arr):
    try:
        return np.isnan(arr)
    except TypeError:
        return np.zeros(np.shape(arr), dtype=bool)


def inverse_map_interpolation(
    ijmap: np.ndarray, downsample: int = 1, fill: float = -1
) -> np.ndarray:
    """Invert a (2, H, W) sampling map by scattered-data interpolation
    (reference indexing.py:87-150; scipy griddata)."""
    from scipy.interpolate import griddata

    H, W = ijmap.shape[1:]
    igrid, jgrid = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid_coords = np.stack([igrid.ravel(), jgrid.ravel()], axis=1)
    if downsample > 1:
        ds = slice(None, None, downsample)
        sample_y = np.stack(
            [igrid[ds, ds].ravel(), jgrid[ds, ds].ravel()], axis=1
        )
        sample_x = np.stack(
            [ijmap[0][ds, ds].ravel(), ijmap[1][ds, ds].ravel()], axis=1
        )
    else:
        sample_y = grid_coords.copy()
        sample_x = np.stack([ijmap[0].ravel(), ijmap[1].ravel()], axis=1)
    inv_i = griddata(
        sample_x, sample_y[:, 0], grid_coords, method="linear", fill_value=fill
    )
    inv_j = griddata(
        sample_x, sample_y[:, 1], grid_coords, method="linear", fill_value=fill
    )
    return np.stack([inv_i.reshape(H, W), inv_j.reshape(H, W)], axis=0)
