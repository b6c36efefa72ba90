"""Tile z-buffer resolve: the raster kernel's wrapper and its plain version.

:func:`raster_tiles` turns triangle plane rows and per-level tile
candidate lists into pix2face.  On a CUDA tensor it launches the
hand-written kernel ``csrc/raster_tiles.cu``; on a CPU tensor it runs
:func:`raster_tiles_plain`, the PyTorch port of the JAX package's XLA
resolve (``geograypher_tpu/ops/rasterize.py`` ``_raster_tiles_xla``).

Kernel source note.  Replaces the TPU kernel
``geograypher_tpu/ops/pallas_raster.py`` ``raster_tiles_pallas`` (its
z-resolve).  On the H100 it is bound by FP32 instructions: each
candidate-pixel costs four plane evaluations, and evaluated over its whole
8 x 128 tile a candidate costs 1024 pixels where its box needs a few
tens.  One thread block per L0 tile splits the tile into 8 warp
rectangles (:func:`warp_split`, 8 x 16 by default); each warp culls the
staged candidates against its rectangle with their boxes (``bbox``) and
a ballot, and evaluates only the survivors.  The cull
(:func:`cull_rule`, :func:`cull_boxes`) skips a face only outside its box
widened by 1 px, and only when rounding cannot carry its coverage that
far: no edge coefficient above 2^18 and no vertex sharper than the
rounding of its edges allows (the CPU tests find slivers whose rounded
coverage runs tens of pixels past a 1 px margin).  Plane rows and boxes
are staged with ``cp.async`` into a double-buffered chunk.  No tensor
cores: a TF32 product would round the coefficients and flip pixels
between a face and the background.  :func:`kernel_cand_pixels` counts
the candidate-pixels the kernel evaluates; see the source for the rest.

Tie rules, shared by both versions: inside a candidate group the larger
1/z wins and an exact tie goes to the lower face id; across the groups
(L0, then L1, then L2 + global) only a strictly larger 1/z replaces the
earlier winner.  This is the Pallas kernel's rule; the JAX XLA resolve
differs only on exact ties between an L2 and a global candidate, where
it keeps list order.  With ``s_init``, the level-S sub-tile raster's
(1/z, face) planes (``ops/subtile.py``) seed every pixel's winner, so
an L0+ candidate replaces an S winner only with a strictly larger 1/z.
"""

from __future__ import annotations

from typing import Sequence

import torch

from geograypher_tpu_torch.kernels import build

INT32_MAX = 2**31 - 1

# kernel launches since the last reset (the main path's proof of use)
launches = 0

_MAX_TILE_PIXELS = 1024  # the CUDA kernel's tiles
_WARPS = 8  # the CUDA kernel's warps, one pixel rectangle of the tile each

# The cull rule of both raster kernels (csrc/eval_plane.cuh cull_rule),
# op for op in float32: a face of kind CULL_BOX covers no pixel outside its
# box widened by CULL_MARGIN, one of kind CULL_EXEMPT may cover anything in
# the image, one of kind CULL_NEVER covers nothing.
CULL_NEVER, CULL_BOX, CULL_EXEMPT = 0, 1, 2
CULL_MARGIN = 1
CULL_MAX_COEF = 2.0**18
CULL_TWO_GAMMA = 2.0**-20


def cull_rule(planes: torch.Tensor, image_h: int, image_w: int) -> torch.Tensor:
    """(F,) int64 cull kind of every plane row.

    ``CULL_NEVER`` where an edge plane is a negative constant (the
    sentinel row); ``CULL_EXEMPT`` where a coefficient ``|a_k|``,
    ``|b_k|`` exceeds ``CULL_MAX_COEF`` (a long edge, whose rounding can
    move coverage by pixels) or a vertex is so sharp that the rounding of
    its two edges could carry coverage half a pixel past it; else
    ``CULL_BOX``.  The source note of ``csrc/eval_plane.cuh`` derives the
    bound.
    """
    a, b, c = planes[:, 0:9:3], planes[:, 1:9:3], planes[:, 2:9:3]
    never = ((a == 0) & (b == 0) & (c < 0)).any(dim=1)
    ha, hb = a.abs(), b.abs()
    ext_x, ext_y = hb.amax(dim=1), ha.amax(dim=1)
    big = torch.maximum(ext_x, ext_y) > CULL_MAX_COEF
    x_span = float(2 * (image_w + 1)) + ext_x
    y_span = float(2 * (image_h + 1)) + ext_y
    err = ha * x_span[:, None] + hb * y_span[:, None]
    norm = torch.sqrt(a * a + b * b)
    area2 = (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]).abs()
    sharp = torch.zeros_like(never)
    for i, j in ((0, 1), (1, 2), (0, 2)):
        t = err[:, i] * norm[:, j] + err[:, j] * norm[:, i]
        sharp = sharp | (CULL_TWO_GAMMA * t > area2)
    return torch.where(never, CULL_NEVER,
                       torch.where(big | sharp, CULL_EXEMPT, CULL_BOX))


def cull_boxes(planes: torch.Tensor, bbox: torch.Tensor, image_h: int,
               image_w: int) -> torch.Tensor:
    """(F, 4) int64 rows (y0, x0, y1, x1), inclusive: where each face may
    cover a pixel.  Its box widened by ``CULL_MARGIN``, the whole image
    when exempt, nothing (y0 > y1) when it never covers."""
    kind = cull_rule(planes, image_h, image_w)[:, None]
    m = CULL_MARGIN
    box = bbox.T.long() + torch.tensor([-m, -m, m, m], device=bbox.device)
    full = torch.tensor([0, 0, image_h - 1, image_w - 1], device=bbox.device)
    empty = torch.tensor([1, 1, 0, 0], device=bbox.device)
    return torch.where(kind == CULL_BOX, box,
                       torch.where(kind == CULL_EXEMPT, full, empty))


def warp_split(tile_h: int, tile_w: int):
    """(wy, wx, rh, rw): the tile raster kernel's 8 warps as a wy x wx
    grid of rh x rw pixel rectangles, the split with the smallest
    rectangle (8 x 16 for an 8 x 128 tile).  Mirrors the kernel's host
    code."""
    best = None
    for wy in (1, 2, 4, 8):
        wx = _WARPS // wy
        rh, rw = -(-tile_h // wy), -(-tile_w // wx)
        if best is None or rh * rw < best[2] * best[3]:
            best = (wy, wx, rh, rw)
    return best


def warp_rects(config, image_h: int, image_w: int) -> torch.Tensor:
    """(n_tiles0, 8, 4) int64 rows (y0, x0, y1, x1), inclusive: each warp's
    pixel rectangle in each L0 tile, clipped to the tile and the image
    (y0 > y1 or x0 > x1 when empty)."""
    th, tw = config.tile_h, config.tile_w
    nty, ntx = config.grids(image_h, image_w)[0]
    wy, wx, rh, rw = warp_split(th, tw)
    t = torch.arange(nty * ntx)[:, None]
    w = torch.arange(_WARPS)[None, :]
    ty0, tx0 = t // ntx * th, t % ntx * tw
    y0 = ty0 + w // wx * rh
    x0 = tx0 + w % wx * rw
    y1 = torch.minimum(torch.minimum(y0 + rh, ty0 + th), torch.tensor(image_h)) - 1
    x1 = torch.minimum(torch.minimum(x0 + rw, tx0 + tw), torch.tensor(image_w)) - 1
    return torch.stack([y0, x0, y1, x1], dim=2)


def kernel_cand_pixels(planes, bbox, cand, counts, config, image_h: int,
                       image_w: int) -> int:
    """The candidate-pixels the CUDA tile raster evaluates: for every L0
    tile, group candidate and warp whose rectangle the candidate's
    :func:`cull_boxes` box meets, the rectangle's pixels."""
    boxes = cull_boxes(planes, bbox, image_h, image_w)
    rects = warp_rects(config, image_h, image_w).to(planes.device)
    npix = ((rects[..., 2] - rects[..., 0] + 1).clamp(min=0)
            * (rects[..., 3] - rects[..., 1] + 1).clamp(min=0))  # (T, 8)
    total = torch.zeros((), dtype=torch.int64, device=planes.device)
    for ids, ok in tile_candidate_groups(cand, counts, config, image_h, image_w):
        b = boxes[ids.clamp(min=0).long()]  # (T, C, 4)
        for w in range(_WARPS):
            r = rects[:, w, None, :]
            hit = (ok & (b[..., 0] <= r[..., 2]) & (b[..., 2] >= r[..., 0])
                   & (b[..., 1] <= r[..., 3]) & (b[..., 3] >= r[..., 1]))
            total = total + (hit.sum(dim=1) * npix[:, w]).sum()
    return int(total)


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
    s_init=None,
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
    best_w = torch.full((nty * th, ntx * tw), float("-inf"), dtype=planes.dtype,
                        device=dev)
    best_id = torch.full((nty * th, ntx * tw), -1, dtype=torch.int32, device=dev)
    if s_init is not None:
        best_w[:image_h, :image_w] = s_init[0]
        best_id[:image_h, :image_w] = s_init[1]

    def tiles(img):  # (nty*th, ntx*tw) -> (T, P)
        return img.reshape(nty, th, ntx, tw).permute(0, 2, 1, 3).reshape(
            n_tiles, th * tw)

    best_w, best_id = tiles(best_w), tiles(best_id)
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


def _check(planes, bbox, cand, counts, config, image_h, image_w, s_init):
    if planes.dtype != torch.float32 or planes.ndim != 2 or planes.shape[1] != 12:
        raise ValueError(f"planes must be float32 (F, 12), got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if bbox.dtype != torch.int32 or tuple(bbox.shape) != (4, planes.shape[0]):
        raise ValueError(f"bbox must be int32 (4, {planes.shape[0]}), got "
                         f"{bbox.dtype} {tuple(bbox.shape)}")
    if bbox.device != planes.device or not bbox.is_contiguous():
        raise ValueError(f"bbox must be contiguous on {planes.device}")
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
    if s_init is not None:
        for name, t, dtype in (("s_init[0]", s_init[0], torch.float32),
                               ("s_init[1]", s_init[1], torch.int32)):
            if t.dtype != dtype or tuple(t.shape) != (image_h, image_w):
                raise ValueError(f"{name} must be {dtype} {(image_h, image_w)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
            if t.device != planes.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {planes.device}")


def raster_tiles(
    planes: torch.Tensor,
    bbox: torch.Tensor,
    cand: Sequence[torch.Tensor],
    counts: Sequence[torch.Tensor],
    config,
    image_h: int,
    image_w: int,
    s_init=None,
) -> torch.Tensor:
    """(image_h, image_w) int32 pix2face, -1 for background.

    Args:
        planes: (F, 12) float32 plane rows from ``setup_from_soa``
            (invalid faces carry the coverage-false sentinel row).
        bbox: (4, F) int32 rows of each face's first/last covered row
            and column (``setup.bbox``): the kernel culls each candidate
            against each warp's pixel rectangle with it; the plain version
            does not read it.
        cand: per-level FACE-id lists (after ``expand_block_ids``):
            (n_tiles_l, C_l) int32 for levels 0-2 and (1, C_3) for the
            global list; each tile's list ascending, -1 in empty slots.
        counts: per-level int32 true counts in face slots,
            (n_tiles_l,) for levels 0-2 and (1,) for the global list.
        config: the ``RasterConfig`` the lists were binned with.
        s_init: optional level-S carry ``(best_w, best_id)``, (H, W)
            float32 and int32 from ``ops.subtile.s_raster``.

    A CUDA tensor launches the CUDA kernel (or raises); only a CPU tensor
    runs the plain version.
    """
    global launches
    _check(planes, bbox, cand, counts, config, image_h, image_w, s_init)
    if planes.device.type == "cpu":
        return raster_tiles_plain(planes, cand, counts, config, image_h,
                                  image_w, s_init)
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
    # launched under the tensor's device, whose stream it is given
    with torch.cuda.device(planes.device):
        err = lib.gg_raster_tiles(
            planes.data_ptr(),
            bbox.data_ptr(),
            *[c.data_ptr() for c in cand],
            *[n.data_ptr() for n in counts],
            *((None, None) if s_init is None else (t.data_ptr() for t in s_init)),
            out.data_ptr(),
            planes.shape[0],
            image_h, image_w, th, tw, nty0, ntx0, nty1, ntx1, nty2, ntx2,
            config.level_scales[1], config.level_scales[2],
            *[c.shape[1] for c in cand],
            build.stream_ptr(planes.device),
        )
    build.check(err, "gg_raster_tiles")
    launches += 1
    return out
