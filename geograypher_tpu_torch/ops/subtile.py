"""Level S: the sub-tile raster for small triangles.

Port of ``geograypher_tpu/ops/subtile.py``.  A tile-list candidate costs
every pixel of its 8 x 128 tile; the far-field triangles of oblique drone
views cover a few pixels each.  Level S bins SMALL units of ``s_block``
consecutive faces to (h, w) sub-tile cells of the image (8 x 16 by
default) and resolves each only against the cells its box touches.

* :func:`subtile_mask8` decides which ``bin_block`` blocks leave the
  L0..L3 tile lists: a block is diverted only when every occupied
  ``s_block`` unit of it fits an ``s_window`` of cells (assignment is
  exclusive, so no face is resolved or counted twice), and never when it
  holds an oversized-tail face (``global_from``).  It equals the JAX
  package's mask exactly.
* :func:`bin_subtiles` sorts the (sub-tile, unit) pairs once into a CSR
  list over the occupied sub-tiles, at the view's exact demand: level S
  has no capacity and can never drop a candidate.
* :func:`s_raster` resolves the lists into image-layout (best 1/z, face)
  planes that seed the tile raster's carry (``raster_tiles(s_init=)``).

The TPU layout of 128-slot chunks, 32-slot quarters and kb-aligned tile
pairs, the bf16 hi/lo slab and the sub-tile-major output are not carried
over: the CUDA kernel reads the CSR list directly and writes the image
layout.

Kernel source note.  :func:`s_raster` replaces the TPU kernel
``geograypher_tpu/ops/subtile.py`` ``s_raster_pallas``.  It evaluates
planes at global pixel centres with the tile raster's rounding, so
coverage and depth are bit-identical to the path with level S off, and
the CUDA kernel (``csrc/s_raster.cu``) is bit-equal to
:func:`s_raster_plain`.  Its work is FP32 instructions, 16 FLOP per
candidate-pixel, and it makes ~8x fewer candidate-pixel evaluations than
the same faces cost in an 8 x 128 L0 tile.  Counted over each face's own
box instead, the work a view needs is less than the bytes it must move,
so its least time is a byte bound.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geograypher_tpu_torch.kernels import build
from geograypher_tpu_torch.ops.raster_tiles import INT32_MAX

# kernel launches since the last reset (the main path's proof of use)
launches = 0

_MAX_SUBTILE_PIXELS = 256  # the CUDA kernel's threads, one pixel each


class SubtileBinned(NamedTuple):
    """One view's level-S lists, CSR over the occupied sub-tiles.

    Sub-tiles are numbered ``cy * nsx + cx`` on the image's own grid of
    (h, w) cells (:func:`subtile_grid`).
    """

    units: torch.Tensor  # (n_pairs,) int32 unit ids, per sub-tile ascending
    sub_ids: torch.Tensor  # (n_occ,) int32 occupied sub-tile ids, ascending
    sub_start: torch.Tensor  # (n_occ,) int32 first entry in ``units``
    sub_count: torch.Tensor  # (n_occ,) int32 units of the sub-tile
    s_mask8: torch.Tensor  # (F / bin_block,) bool: block diverted to S


def subtile_grid(config, image_h: int, image_w: int):
    """(nsy, nsx): the image's grid of sub-tile cells."""
    sh, sw = config.subtile
    return -(-image_h // sh), -(-image_w // sw)


def _unit_fit(setup, config):
    """Per-``s_block``-unit cell spans and the diversion masks.

    Returns (cy0, cy1, cx0, cx1, uvalid, s_mask8, s_unit): the cell box
    of each unit, unit validity, the per-``bin_block``-block diversion
    mask and the per-unit "binned to S" mask.
    """
    sh, sw = config.subtile
    wy, wx = config.s_window
    sbb = config.s_block
    bb = config.bin_block  # a multiple of sbb (RasterConfig checks it)
    if setup.valid.shape[0] % bb:
        raise ValueError(
            f"face count {setup.valid.shape[0]} not a multiple of bin_block "
            f"{bb}; pad the mesh to a multiple of bin_block"
        )
    py0, px0, py1, px1 = (setup.bbox[k] for k in range(4))
    valid = setup.valid
    py0u = torch.where(valid, py0, INT32_MAX).reshape(-1, sbb).amin(1).long()
    px0u = torch.where(valid, px0, INT32_MAX).reshape(-1, sbb).amin(1).long()
    py1u = torch.where(valid, py1, -1).reshape(-1, sbb).amax(1).long()
    px1u = torch.where(valid, px1, -1).reshape(-1, sbb).amax(1).long()
    uvalid = valid.reshape(-1, sbb).any(1)

    cy0 = torch.div(py0u, sh, rounding_mode="floor")
    cy1 = torch.div(py1u, sh, rounding_mode="floor")
    cx0 = torch.div(px0u, sw, rounding_mode="floor")
    cx1 = torch.div(px1u, sw, rounding_mode="floor")
    fits = (cy1 - cy0 < wy) & (cx1 - cx0 < wx)
    if config.global_from is not None:
        # oversized-tail faces are never diverted to level S
        unit_last = torch.arange(fits.shape[0], device=fits.device) * sbb + (sbb - 1)
        fits = fits & (unit_last < config.global_from)
    # empty units never block their block's diversion
    ok_unit = fits | ~uvalid
    k8 = bb // sbb
    s_mask8 = ok_unit.reshape(-1, k8).all(1)
    s_unit = uvalid & s_mask8.repeat_interleave(k8)
    return cy0, cy1, cx0, cx1, uvalid, s_mask8, s_unit


def subtile_mask8(setup, config) -> torch.Tensor:
    """The level-S diversion mask alone, (F / bin_block,) bool."""
    return _unit_fit(setup, config)[5]


def _pair_keys(setup, config, image_h: int, image_w: int):
    """(keys (wy*wx*n_units,) int64, n_units, s_mask8): the sub-tile id of
    every (window cell, unit) pair, ``INT32_MAX`` where the pair is not
    binned."""
    wy, wx = config.s_window
    cy0, cy1, cx0, cx1, uvalid, s_mask8, s_unit = _unit_fit(setup, config)
    _, nsx = subtile_grid(config, image_h, image_w)
    keys = []
    for dy in range(wy):
        for dx in range(wx):
            cy, cx = cy0 + dy, cx0 + dx
            ok = s_unit & (cy <= cy1) & (cx <= cx1)
            keys.append(torch.where(ok, cy * nsx + cx, INT32_MAX))
    return torch.cat(keys), uvalid.shape[0], s_mask8


def subtile_counts_census(setup, config, image_h: int, image_w: int):
    """Exact level-S demand, (2,) int64: total (sub-tile, unit) pairs and
    the most units any one sub-tile holds."""
    keys, _, _ = _pair_keys(setup, config, image_h, image_w)
    nsy, nsx = subtile_grid(config, image_h, image_w)
    keys = keys[keys != INT32_MAX]
    per_sub = torch.bincount(keys, minlength=nsy * nsx)
    return torch.stack([per_sub.sum(), per_sub.max()])


def bin_subtiles(setup, config, image_h: int, image_w: int) -> SubtileBinned:
    """Bin small units to sub-tile cells with one sort.

    ``setup`` is the view's TriangleSetup, faces padded to a multiple of
    ``bin_block`` as for ``bin_triangles``.  Each unit whose cell box fits
    the ``s_window`` emits one (sub-tile, unit) pair per cell of its box;
    sorting the combined int64 key ``sub_tile * n_units + unit`` groups
    them per sub-tile with units ascending, which the tie rule needs.
    Sizing the lists reads two numbers back from the device.
    """
    keys, n_units, s_mask8 = _pair_keys(setup, config, image_h, image_w)
    dev = keys.device
    nsy, nsx = subtile_grid(config, image_h, image_w)
    n_sub = nsy * nsx
    units = torch.arange(n_units, device=dev).repeat(keys.shape[0] // max(n_units, 1))
    combined, _ = torch.sort(keys * n_units + units)
    sorted_keys = torch.div(combined, max(n_units, 1), rounding_mode="floor")
    starts = torch.searchsorted(sorted_keys, torch.arange(n_sub + 1, device=dev))
    per_sub = starts[1:] - starts[:-1]
    occ = torch.nonzero(per_sub).squeeze(1)
    n_pairs = int(starts[-1])
    return SubtileBinned(
        units=(combined[:n_pairs] - sorted_keys[:n_pairs] * n_units).to(torch.int32),
        sub_ids=occ.to(torch.int32),
        sub_start=starts[occ].to(torch.int32),
        sub_count=per_sub[occ].to(torch.int32),
        s_mask8=s_mask8,
    )


def s_raster_plain(sb: SubtileBinned, planes: torch.Tensor, config,
                   image_h: int, image_w: int):
    """Plain PyTorch level-S z-pass -> (best_w, best_id), each (H, W).

    Every occupied sub-tile's pixels (at global centres ``x + 0.5``)
    against its list, ``config.chunk`` face slots at a time, each plane
    evaluated as ``(a*x + b*y) + c`` with every operation rounded on its
    own.  The larger 1/z wins and an exact tie goes to the lower face id
    (the lists are ascending).  ``best_w`` is -inf and ``best_id`` -1
    where no S candidate covers a pixel.
    """
    sh, sw = config.subtile
    sbb = config.s_block
    nsy, nsx = subtile_grid(config, image_h, image_w)
    dev = planes.device
    best_w = torch.full((nsy * sh, nsx * sw), float("-inf"), dtype=planes.dtype,
                        device=dev)
    best_id = torch.full((nsy * sh, nsx * sw), -1, dtype=torch.int32, device=dev)
    n_occ = sb.sub_ids.shape[0]
    if n_occ:
        sub = sb.sub_ids.long()
        p = torch.arange(sh * sw, device=dev)
        x = ((sub % nsx * sw)[:, None] + (p % sw)[None, :]).to(planes.dtype) + 0.5
        y = ((sub // nsx * sh)[:, None] + (p // sw)[None, :]).to(planes.dtype) + 0.5
        x, y = x[:, :, None], y[:, :, None]  # (n_occ, P, 1)
        neg = torch.tensor(float("-inf"), dtype=planes.dtype, device=dev)
        big = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
        gw = torch.full((n_occ, sh * sw), float("-inf"), dtype=planes.dtype,
                        device=dev)
        gid = torch.full((n_occ, sh * sw), -1, dtype=torch.int32, device=dev)
        n_slots = sb.sub_count.long() * sbb
        last = max(sb.units.shape[0] - 1, 0)
        for s in range(0, int(n_slots.max()), config.chunk):
            slot = s + torch.arange(config.chunk, device=dev)
            ok = slot[None, :] < n_slots[:, None]  # (n_occ, chunk)
            entry = torch.clamp(sb.sub_start.long()[:, None] + slot // sbb, max=last)
            fid = sb.units[entry] * sbb + (slot % sbb).to(torch.int32)
            fid = torch.where(ok, fid, 0)
            pl = planes[fid.long()]  # (n_occ, chunk, 12)

            def plane(k):
                return (x * pl[:, None, :, 3 * k]
                        + y * pl[:, None, :, 3 * k + 1]
                        + pl[:, None, :, 3 * k + 2])

            covered = (
                (plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
                & ok[:, None, :]
            )
            wv = torch.where(covered, plane(3), neg)
            wmax = wv.amax(dim=2)
            cmin = torch.where(
                covered & (wv == wmax[..., None]), fid[:, None, :], big
            ).amin(dim=2)
            # slots ascend, so a later chunk wins only strictly
            upd = wmax > gw
            gw = torch.where(upd, wmax, gw)
            gid = torch.where(upd, cmin, gid)
        # scatter each sub-tile's pixels into the image
        cy, cx = sub // nsx, sub % nsx
        best_w.view(nsy, sh, nsx, sw).permute(0, 2, 1, 3)[cy, cx] = (
            gw.view(n_occ, sh, sw))
        best_id.view(nsy, sh, nsx, sw).permute(0, 2, 1, 3)[cy, cx] = (
            gid.view(n_occ, sh, sw))
    return (best_w[:image_h, :image_w].contiguous(),
            best_id[:image_h, :image_w].contiguous())


def s_raster(sb: SubtileBinned, planes: torch.Tensor, config, image_h: int,
             image_w: int):
    """Level-S z-pass: (best_w (H, W) float32, best_id (H, W) int32), the
    tile raster's carry init; -inf / -1 where no S candidate covers.

    A CUDA tensor launches ``csrc/s_raster.cu`` (one thread block per
    occupied sub-tile, one thread per pixel) or raises; only a CPU tensor
    runs :func:`s_raster_plain`.
    """
    global launches
    if planes.dtype != torch.float32 or planes.ndim != 2 or planes.shape[1] != 12:
        raise ValueError(f"planes must be float32 (F, 12), got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    for name in ("units", "sub_ids", "sub_start", "sub_count"):
        t = getattr(sb, name)
        if t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"sb.{name} must be contiguous int32 (n,), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != planes.device:
            raise ValueError(f"sb.{name} is on {t.device}, planes on "
                             f"{planes.device}")
    if planes.device.type == "cpu":
        return s_raster_plain(sb, planes, config, image_h, image_w)
    if planes.device.type != "cuda":
        raise ValueError(f"s_raster: unsupported device {planes.device}")
    sh, sw = config.subtile
    if sh * sw > _MAX_SUBTILE_PIXELS:
        raise ValueError(f"s_raster: CUDA kernel takes sub-tiles of at most "
                         f"{_MAX_SUBTILE_PIXELS} pixels, got {sh}x{sw}")
    _, nsx = subtile_grid(config, image_h, image_w)
    best_w = torch.full((image_h, image_w), float("-inf"), dtype=torch.float32,
                        device=planes.device)
    best_id = torch.full((image_h, image_w), -1, dtype=torch.int32,
                         device=planes.device)
    if sb.sub_ids.shape[0] == 0:  # no S candidate: nothing to launch
        return best_w, best_id
    lib = build.load()
    err = lib.gg_s_raster(
        planes.data_ptr(), sb.units.data_ptr(), sb.sub_ids.data_ptr(),
        sb.sub_start.data_ptr(), sb.sub_count.data_ptr(),
        best_w.data_ptr(), best_id.data_ptr(),
        sb.sub_ids.shape[0], image_h, image_w, sh, sw, nsx, config.s_block,
        build.stream_ptr(planes.device),
    )
    build.check(err, "gg_s_raster")
    launches += 1
    return best_w, best_id
