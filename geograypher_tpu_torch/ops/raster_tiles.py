"""Tile z-buffer resolve: the raster kernel's wrapper and its plain version.

:func:`raster_tiles` turns triangle plane rows and per-level tile
candidate lists into pix2face.  On a CUDA tensor it launches the
hand-written kernel ``csrc/raster_tiles.cu``; on a CPU tensor it runs
:func:`raster_tiles_plain`, the PyTorch port of the JAX package's XLA
resolve (``geograypher_tpu/ops/rasterize.py`` ``_raster_tiles_xla``).

Kernel source note.  Replaces the TPU kernel
``geograypher_tpu/ops/pallas_raster.py`` ``raster_tiles_pallas`` (its
z-resolve).  On the H100 it is bound by FP32 instruction throughput:
every candidate costs each pixel of its tile four plane evaluations.  One
thread block per L0 tile stages 128 candidate plane rows at a time in
shared memory, loops only to each list's true count and keeps the
per-pixel winner in registers; see the source for the details.

Tie rules, shared by both versions: inside a candidate group the larger
1/z wins and an exact tie goes to the lower face id; across the groups
(L0, then L1, then L2 + global) only a strictly larger 1/z replaces the
earlier winner.  This is the Pallas kernel's rule; the JAX XLA resolve
differs only on exact ties between an L2 and a global candidate, where
it keeps list order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from geograypher_tpu_torch.kernels import build

INT32_MAX = 2**31 - 1

# kernel launches since the last reset (the main path's proof of use)
launches = 0

_MAX_TILE_PIXELS = 1024  # the CUDA kernel's 256 threads x 4 pixels


def _parents(config, image_h: int, image_w: int, device):
    """(L1 parent, L2 parent) tile index of every L0 tile, row-major."""
    grids = config.grids(image_h, image_w)
    nty0, ntx0 = grids[0]
    ty = torch.arange(nty0, device=device).repeat_interleave(ntx0)
    tx = torch.arange(ntx0, device=device).repeat(nty0)
    out = []
    for lvl in (1, 2):
        s = config.level_scales[lvl]
        nty_l, ntx_l = grids[lvl]
        out.append(
            torch.clamp(ty // s, max=nty_l - 1) * ntx_l
            + torch.clamp(tx // s, max=ntx_l - 1)
        )
    return out


def tile_candidate_groups(cand, counts, config, image_h: int, image_w: int):
    """Per-L0-tile candidate groups: [(ids (T, C_g), ok (T, C_g)), ...].

    Group 0 is the tile's own list, group 1 its L1 parent's list and
    group 2 its L2 parent's list followed by the global list; ``ok``
    marks the slots below each list's count that hold a face.
    """
    p1, p2 = _parents(config, image_h, image_w, cand[0].device)
    n_tiles = cand[0].shape[0]

    def level(lvl, rows=None):
        ids = cand[lvl] if rows is None else cand[lvl][rows]
        cnt = counts[lvl] if rows is None else counts[lvl][rows]
        slot = torch.arange(ids.shape[1], device=ids.device)
        return ids, (slot[None, :] < cnt[:, None]) & (ids >= 0)

    ids3, ok3 = level(3)
    ids3 = ids3.expand(n_tiles, -1)
    ok3 = ok3.expand(n_tiles, -1)
    ids2, ok2 = level(2, p2)
    return [
        level(0),
        level(1, p1),
        (torch.cat([ids2, ids3], dim=1), torch.cat([ok2, ok3], dim=1)),
    ]


def raster_tiles_plain(
    planes: torch.Tensor,
    cand: Sequence[torch.Tensor],
    counts: Sequence[torch.Tensor],
    config,
    image_h: int,
    image_w: int,
) -> torch.Tensor:
    """Plain PyTorch z-resolve (port of ``_raster_tiles_xla``).

    Scans each candidate group in chunks of ``config.chunk`` slots, so
    the live intermediate is (tiles, pixels, chunk) per plane.  Follows
    the tie rules of the module docstring.
    """
    th, tw = config.tile_h, config.tile_w
    nty, ntx = config.grids(image_h, image_w)[0]
    n_tiles = nty * ntx
    dev = planes.device
    t = torch.arange(n_tiles, device=dev)
    p = torch.arange(th * tw, device=dev)
    x = ((t % ntx)[:, None] * tw + (p % tw)[None, :]).to(planes.dtype) + 0.5
    y = ((t // ntx)[:, None] * th + (p // tw)[None, :]).to(planes.dtype) + 0.5
    x, y = x[:, :, None], y[:, :, None]  # (T, P, 1)

    neg = torch.tensor(float("-inf"), dtype=planes.dtype, device=dev)
    big = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
    best_w = torch.full((n_tiles, th * tw), float("-inf"), dtype=planes.dtype,
                        device=dev)
    best_id = torch.full((n_tiles, th * tw), -1, dtype=torch.int32, device=dev)
    for ids, ok in tile_candidate_groups(cand, counts, config, image_h, image_w):
        gw = torch.full_like(best_w, float("-inf"))
        gid = torch.full_like(best_id, INT32_MAX)
        for s in range(0, ids.shape[1], config.chunk):
            cid = ids[:, s:s + config.chunk]
            cok = ok[:, s:s + config.chunk]
            pl = planes[cid.clamp(min=0).long()]  # (T, c, 12)

            def plane(k):
                return (x * pl[:, None, :, 3 * k]
                        + y * pl[:, None, :, 3 * k + 1]
                        + pl[:, None, :, 3 * k + 2])

            covered = (
                (plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
                & cok[:, None, :]
            )
            wv = torch.where(covered, plane(3), neg)
            wmax = wv.amax(dim=2)
            # lowest face id among the chunk's maxima
            cmin = torch.where(
                covered & (wv == wmax[..., None]), cid[:, None, :], big
            ).amin(dim=2)
            upd = (wmax > gw) | ((wmax == gw) & (cmin < gid))
            gw = torch.where(upd, wmax, gw)
            gid = torch.where(upd, cmin, gid)
        take = gw > best_w
        best_w = torch.where(take, gw, best_w)
        best_id = torch.where(take, gid, best_id)
    img = best_id.reshape(nty, ntx, th, tw).permute(0, 2, 1, 3)
    return img.reshape(nty * th, ntx * tw)[:image_h, :image_w].contiguous()


def _check(planes, cand, counts, config, image_h, image_w):
    if planes.dtype != torch.float32 or planes.ndim != 2 or planes.shape[1] != 12:
        raise ValueError(f"planes must be float32 (F, 12), got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if len(cand) != 4 or len(counts) != 4:
        raise ValueError("cand and counts need one entry per level (4)")
    grids = config.grids(image_h, image_w)
    n_tiles = [g[0] * g[1] for g in grids] + [1]
    for lvl in range(4):
        c, n = cand[lvl], counts[lvl]
        for name, t, shape in (
            ("cand", c, (n_tiles[lvl], c.shape[-1])),
            ("counts", n, (n_tiles[lvl],)),
        ):
            if t.dtype != torch.int32 or tuple(t.shape) != shape:
                raise ValueError(
                    f"{name}[{lvl}] must be int32 {shape}, got "
                    f"{t.dtype} {tuple(t.shape)}"
                )
            if t.device != planes.device:
                raise ValueError(f"{name}[{lvl}] is on {t.device}, planes on "
                                 f"{planes.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}[{lvl}] must be contiguous")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")


def raster_tiles(
    planes: torch.Tensor,
    cand: Sequence[torch.Tensor],
    counts: Sequence[torch.Tensor],
    config,
    image_h: int,
    image_w: int,
) -> torch.Tensor:
    """(image_h, image_w) int32 pix2face, -1 for background.

    Args:
        planes: (F, 12) float32 plane rows from ``setup_from_soa``
            (invalid faces carry the coverage-false sentinel row).
        cand: per-level FACE-id lists (after ``expand_block_ids``):
            (n_tiles_l, C_l) int32 for levels 0-2 and (1, C_3) for the
            global list; each tile's list ascending, -1 in empty slots.
        counts: per-level int32 true counts in face slots,
            (n_tiles_l,) for levels 0-2 and (1,) for the global list.
        config: the ``RasterConfig`` the lists were binned with.

    A CUDA tensor launches the CUDA kernel (or raises); only a CPU tensor
    runs the plain version.
    """
    global launches
    _check(planes, cand, counts, config, image_h, image_w)
    if planes.device.type == "cpu":
        return raster_tiles_plain(planes, cand, counts, config, image_h,
                                  image_w)
    if planes.device.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {planes.device}")
    th, tw = config.tile_h, config.tile_w
    if th * tw > _MAX_TILE_PIXELS:
        raise ValueError(
            f"raster_tiles: CUDA kernel takes tiles of at most "
            f"{_MAX_TILE_PIXELS} pixels, got {th}x{tw}"
        )
    (nty0, ntx0), (nty1, ntx1), (nty2, ntx2) = config.grids(image_h, image_w)
    out = torch.empty((image_h, image_w), dtype=torch.int32,
                      device=planes.device)
    lib = build.load()
    err = lib.gg_raster_tiles(
        planes.data_ptr(),
        *[c.data_ptr() for c in cand],
        *[n.data_ptr() for n in counts],
        out.data_ptr(),
        image_h, image_w, th, tw, nty0, ntx0, nty1, ntx1, nty2, ntx2,
        config.level_scales[1], config.level_scales[2],
        *[c.shape[1] for c in cand],
        build.stream_ptr(planes.device),
    )
    build.check(err, "gg_raster_tiles")
    launches += 1
    return out
