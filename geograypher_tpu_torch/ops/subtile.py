"""Level S: the sub-tile raster for small triangles.

Port of ``geograypher_tpu/ops/subtile.py``.  A tile-list candidate costs
every pixel of its 8 x 128 tile; the far-field triangles of oblique drone
views cover a few pixels each.  Level S takes SMALL units of ``s_block``
consecutive faces whose box fits an ``s_window`` of (h, w) sub-tile cells
of the image (8 x 16 by default) and resolves each only over those cells.

* :func:`subtile_units` computes, elementwise from the setup, each unit's
  cell box, which units level S takes (``s_unit``) and the per-block
  diversion mask ``s_mask8``: a ``bin_block`` block leaves the L0..L3
  tile lists only when every occupied unit of it fits (assignment is
  exclusive, so no face is resolved or counted twice), and never when it
  holds an oversized-tail face (``global_from``).  It equals the JAX
  package's mask exactly.  This is all the card's path needs: no sort,
  no read-back to the host.
* :func:`bin_subtiles` (:func:`subtile_csr` of the units) sorts the
  (sub-tile, unit) pairs into a CSR list over the occupied sub-tiles, at
  the view's exact demand.  The plain version and the CPU tests use it.
* :func:`s_raster` resolves the units into image-layout (best 1/z, face)
  planes that seed the tile raster's carry (``raster_tiles(s_init=)``).

The TPU layout of 128-slot chunks, 32-slot quarters and kb-aligned tile
pairs, the bf16 hi/lo slab, the sub-tile-major output and the S
capacities are not carried over.

Kernel source note.  :func:`s_raster` replaces the TPU kernel
``geograypher_tpu/ops/subtile.py`` ``s_raster_pallas``.  The CUDA kernel
(``csrc/s_raster.cu``) is face-parallel: one thread per face of every S
unit loops over its domain (:func:`s_face_domains`: its box widened by
1 px, within its unit's cell box; the whole cell box for a face the cull
rule exempts) and keeps each pixel's winner with a 64-bit ``atomicMax``
of the packed key of :func:`s_pack_key`, whose max is exactly "larger
1/z, then lower id", so the result does not depend on the order the
atomics land in.  It evaluates planes at global pixel centres with the
tile raster's rounding, so coverage and depth are bit-identical to the
path with level S off, and it is bit-equal to :func:`s_raster_plain`.
Its candidate-pixels are each face over its own box, ~the work the data
needs (a few 1e7 FLOP per 4K view), so its least time is a byte bound:
the (H, W) key buffer and the plane rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geograypher_tpu_torch.kernels import build
from geograypher_tpu_torch.ops.raster_tiles import INT32_MAX, cull_boxes

# kernel launches since the last reset (the main path's proof of use)
launches = 0


class SubtileUnits(NamedTuple):
    """One view's level-S units, computed elementwise from its setup (no
    sort and no read-back to the host): what the card's S path needs.

    A unit is ``s_block`` consecutive faces; cells are (h, w) sub-tiles
    of the image's own grid (:func:`subtile_grid`).
    """

    cells: torch.Tensor  # (4, n_units) int32 rows cy0, cx0, cy1, cx1
    s_unit: torch.Tensor  # (n_units,) bool: unit resolved at level S
    s_mask8: torch.Tensor  # (F / bin_block,) bool: block diverted to S


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


def subtile_units(setup, config) -> SubtileUnits:
    """The view's :class:`SubtileUnits`, elementwise from ``setup`` (faces
    padded to a multiple of ``bin_block`` as for ``bin_triangles``)."""
    cy0, cy1, cx0, cx1, _, s_mask8, s_unit = _unit_fit(setup, config)
    cells = torch.stack([cy0, cx0, cy1, cx1]).to(torch.int32).contiguous()
    return SubtileUnits(cells=cells, s_unit=s_unit.contiguous(), s_mask8=s_mask8)


def subtile_pairs(su: SubtileUnits) -> torch.Tensor:
    """() int64 number of (sub-tile, unit) pairs: every S unit's cells."""
    cy0, cx0, cy1, cx1 = (su.cells[k].long() for k in range(4))
    return torch.where(su.s_unit, (cy1 - cy0 + 1) * (cx1 - cx0 + 1), 0).sum()


def _pair_keys(su: SubtileUnits, config, image_h: int, image_w: int):
    """(wy*wx*n_units,) int64: the sub-tile id of every (window cell,
    unit) pair, ``INT32_MAX`` where the pair is not binned."""
    wy, wx = config.s_window
    cy0, cx0, cy1, cx1 = (su.cells[k].long() for k in range(4))
    _, nsx = subtile_grid(config, image_h, image_w)
    keys = []
    for dy in range(wy):
        for dx in range(wx):
            cy, cx = cy0 + dy, cx0 + dx
            ok = su.s_unit & (cy <= cy1) & (cx <= cx1)
            keys.append(torch.where(ok, cy * nsx + cx, INT32_MAX))
    return torch.cat(keys)


def subtile_counts_census(setup, config, image_h: int, image_w: int):
    """Exact level-S demand, (2,) int64: total (sub-tile, unit) pairs and
    the most units any one sub-tile holds."""
    keys = _pair_keys(subtile_units(setup, config), config, image_h, image_w)
    nsy, nsx = subtile_grid(config, image_h, image_w)
    keys = keys[keys != INT32_MAX]
    per_sub = torch.bincount(keys, minlength=nsy * nsx)
    return torch.stack([per_sub.sum(), per_sub.max()])


def subtile_csr(su: SubtileUnits, config, image_h: int,
                image_w: int) -> SubtileBinned:
    """The units' (sub-tile, unit) pairs as CSR lists, with one sort.

    Each S unit emits one pair per cell of its box; sorting the combined
    int64 key ``sub_tile * n_units + unit`` groups them per sub-tile with
    units ascending, which the tie rule needs.  Sizing the lists reads two
    numbers back from the device.
    """
    keys = _pair_keys(su, config, image_h, image_w)
    n_units = su.s_unit.shape[0]
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
        s_mask8=su.s_mask8,
    )


def bin_subtiles(setup, config, image_h: int, image_w: int) -> SubtileBinned:
    """Bin small units to sub-tile cells: :func:`subtile_csr` of
    :func:`subtile_units`.  ``setup`` is the view's TriangleSetup, faces
    padded to a multiple of ``bin_block`` as for ``bin_triangles``."""
    return subtile_csr(subtile_units(setup, config), config, image_h, image_w)


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


def s_face_domains(su: SubtileUnits, setup, config, image_h: int,
                   image_w: int) -> torch.Tensor:
    """(F, 4) int64 rows (y0, x0, y1, x1), inclusive: the pixels the CUDA
    kernel evaluates for each face, its ``cull_boxes`` box within its
    unit's cell box.  That is its box widened by ``CULL_MARGIN``, the
    whole cell box when the cull rule exempts it, and nothing (y0 > y1)
    when it never covers or its unit is not an S unit."""
    sh, sw = config.subtile
    cells = su.cells.long().repeat_interleave(config.s_block, dim=1)  # (4, F)
    boxes = cull_boxes(setup.planes, setup.bbox, image_h, image_w)
    lo = torch.maximum(boxes[:, :2], torch.stack([cells[0] * sh, cells[1] * sw], 1))
    hi = torch.minimum(boxes[:, 2:], torch.stack([
        torch.clamp((cells[2] + 1) * sh, max=image_h) - 1,
        torch.clamp((cells[3] + 1) * sw, max=image_w) - 1], 1))
    live = su.s_unit.repeat_interleave(config.s_block)[:, None]
    return torch.where(live, torch.cat([lo, hi], dim=1),
                       torch.tensor([1, 1, 0, 0], device=cells.device))


def s_pack_key(w: torch.Tensor, face_id: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's packed (1/z, id) key as int64, for any shape.

    The kernel's unsigned key is ``ordered_bits(w + 0.0) << 32 |
    (0xFFFFFFFF - id)``, where ``ordered_bits`` maps a float32's bits to
    an unsigned int in the float order; this is the same key minus 2^63,
    so that its order as a signed int64 is the kernel's unsigned order.
    Its max is "larger w, then lower id", -0.0 and +0.0 equal.
    """
    u = (w + 0.0).to(torch.float32).view(torch.int32).long() & 0xFFFFFFFF
    ordered = torch.where(u >= 2**31, 0xFFFFFFFF - u, u + 2**31)
    return (ordered - 2**31) * 2**32 + (0xFFFFFFFF - face_id.long())


def s_raster(su: SubtileUnits, setup, config, image_h: int, image_w: int):
    """Level-S z-pass: (best_w (H, W) float32, best_id (H, W) int32), the
    tile raster's carry init; -inf / -1 where no S face covers.

    ``su`` comes from :func:`subtile_units` and ``setup`` is the view's
    TriangleSetup (its ``planes`` and ``bbox``).  A CUDA tensor launches
    ``csrc/s_raster.cu`` (one thread per face of every S unit, a 64-bit
    atomic max per covered pixel, then an unpack) or raises; only a CPU
    tensor runs :func:`s_raster_plain`, over the CSR lists of
    :func:`subtile_csr`.
    """
    global launches
    planes, bbox = setup.planes, setup.bbox
    if planes.dtype != torch.float32 or planes.ndim != 2 or planes.shape[1] != 12:
        raise ValueError(f"planes must be float32 (F, 12), got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    n_faces = planes.shape[0]
    n_units = su.s_unit.shape[0]
    if n_units * config.s_block != n_faces:
        raise ValueError(f"{n_units} units of {config.s_block} faces do not "
                         f"cover {n_faces} faces")
    for name, t, dtype, shape in (
        ("setup.bbox", bbox, torch.int32, (4, n_faces)),
        ("su.cells", su.cells, torch.int32, (4, n_units)),
        ("su.s_unit", su.s_unit, torch.bool, (n_units,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != planes.device:
            raise ValueError(f"{name} is on {t.device}, planes on {planes.device}")
    if planes.device.type == "cpu":
        return s_raster_plain(subtile_csr(su, config, image_h, image_w),
                              planes.contiguous(), config, image_h, image_w)
    if planes.device.type != "cuda":
        raise ValueError(f"s_raster: unsupported device {planes.device}")
    planes, bbox = planes.contiguous(), bbox.contiguous()
    cells, s_unit = su.cells.contiguous(), su.s_unit.contiguous()
    sh, sw = config.subtile
    keys = torch.zeros((image_h, image_w), dtype=torch.int64, device=planes.device)
    best_w = torch.empty((image_h, image_w), dtype=torch.float32,
                         device=planes.device)
    best_id = torch.empty((image_h, image_w), dtype=torch.int32,
                          device=planes.device)
    lib = build.load()
    # launched under the tensor's device, whose stream it is given
    with torch.cuda.device(planes.device):
        err = lib.gg_s_raster(
            planes.data_ptr(), bbox.data_ptr(), cells.data_ptr(), s_unit.data_ptr(),
            keys.data_ptr(), best_w.data_ptr(), best_id.data_ptr(),
            n_faces, image_h, image_w, sh, sw, config.s_block,
            build.stream_ptr(planes.device),
        )
    build.check(err, "gg_s_raster")
    launches += 1
    return best_w, best_id
