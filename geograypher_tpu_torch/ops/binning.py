"""Tile binning: the binning kernels' wrapper and its plain version.

:func:`tile_binning` assigns each face unit of a view to the tile lists
of the finest level whose window covers its box (:class:`BinnedTriangles`),
or returns the census of those lists.  On a CUDA tensor it launches the
hand-written kernels of ``csrc/tile_binning.cu`` through one C entry
point; on a CPU tensor it runs :func:`bin_triangles_plain`.

Kernel source note.  Replaces no TPU kernel: the JAX package's
``bin_triangles`` (``geograypher_tpu/ops/rasterize.py:556``) builds its
keys and cuts its lists in XLA around one ``jnp.sort``; the port's plain
version is about fifty eager launches (key build, ``torch.cat``, the
sort, ``searchsorted`` and per-level gathers).  On the H100 it is bound
by bytes: each unit's box read, the lists written.  A counting binning
with no global sort and no host read, on the caller's stream: a memset
of the tile counts; a count kernel (blocks over contiguous unit ranges,
each unit's window keys merged across the warp and counted in a
shared-memory histogram of every tile, or in global memory past 57,344
tiles); a one-block scan (segment starts, overflow, census: the census
stops here); a scatter kernel (the keys again, each run of equal keys in
a warp claiming its slots in its tile's segment by one atomic); a cut
kernel (a warp a tile: the clipped count, -1 past it, at ``bin_block >
1`` the face-id lists the raster kernel reads, and a segment of up to
256 ids sorted in registers, its smallest ``cap`` unit ids written in
ascending order); and a kernel for the longer segments (up to 512 ids a
warp in registers, then a block a tile that reads a longer one out of
bitmap windows of unit ids, from the smallest up).  Integer work
throughout, and every list is in ascending order when it is written: the
same lists as the plain version's, on every run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from geograypher_tpu_torch.kernels import build
from geograypher_tpu_torch.ops.raster_tiles import INT32_MAX

# kernel launches since the last reset (the main path's proof of use): one
# per tile_binning call that ran the binning kernels
launches = 0


class BinnedTriangles(NamedTuple):
    """Per-level tile candidate lists.

    ``cand[l]`` is (n_tiles_l, cap_l) int32 unit ids (-1 = empty slot)
    and ``counts[l]`` the per-tile count clipped to the cap; level 3 is
    the single global list, (1, cap_3).  ``face_cand`` / ``face_counts``,
    when set, are the same lists in face ids and face slots (what
    ``binned_face_lists`` returns), written by the binning kernel.
    """

    cand: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    counts: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    overflow: torch.Tensor  # () candidates dropped by capacity limits
    face_cand: Optional[Tuple[torch.Tensor, ...]] = None
    face_counts: Optional[Tuple[torch.Tensor, ...]] = None


def bin_triangles_plain(
    setup,
    config,
    image_h: int,
    image_w: int,
    return_census: bool = False,
    exclude_blocks: Optional[torch.Tensor] = None,
):
    """Plain PyTorch binning with one sort (see :func:`tile_binning`)."""
    dev = setup.valid.device
    f_count = setup.valid.shape[0]
    grids = config.grids(image_h, image_w)
    py0, px0, py1, px1 = (setup.bbox[k] for k in range(4))
    valid = setup.valid
    bb = config.bin_block
    if bb > 1:
        if f_count % bb:
            raise ValueError(
                f"face count {f_count} not a multiple of bin_block {bb}; "
                "pad the mesh to a multiple of bin_block"
            )
        py0 = torch.where(valid, py0, INT32_MAX).reshape(-1, bb).amin(1)
        px0 = torch.where(valid, px0, INT32_MAX).reshape(-1, bb).amin(1)
        py1 = torch.where(valid, py1, -1).reshape(-1, bb).amax(1)
        px1 = torch.where(valid, px1, -1).reshape(-1, bb).amax(1)
        valid = valid.reshape(-1, bb).any(1)
        f_count //= bb
    if exclude_blocks is not None:
        valid = valid & ~exclude_blocks
    py0, px0, py1, px1 = (v.long() for v in (py0, px0, py1, px1))

    level_base = []
    base = 0
    for (nty, ntx) in grids:
        level_base.append(base)
        base += nty * ntx
    base3 = base
    total_tiles = base + 1

    w0 = config.l0_window
    wy0, wx0 = (w0, w0) if isinstance(w0, int) else w0
    wy0, wx0 = max(2, int(wy0)), max(2, int(wx0))
    per_level = []  # (ty0, ty1, tx0, tx1, fits) per level
    for lvl, scale in enumerate(config.level_scales):
        th, tw = config.tile_h * scale, config.tile_w * scale
        ty0 = torch.div(py0, th, rounding_mode="floor")
        ty1 = torch.div(py1, th, rounding_mode="floor")
        tx0 = torch.div(px0, tw, rounding_mode="floor")
        tx1 = torch.div(px1, tw, rounding_mode="floor")
        wy, wx = (wy0, wx0) if lvl == 0 else (2, 2)
        per_level.append((ty0, ty1, tx0, tx1, (ty1 - ty0 < wy) & (tx1 - tx0 < wx)))

    fits0, fits1, fits2 = (pl[4] for pl in per_level)
    if config.global_from is not None:
        # units holding any oversized-tail face go global unconditionally
        unit_last = torch.arange(f_count, device=dev) * bb + (bb - 1)
        small = unit_last < config.global_from
        fits0, fits1, fits2 = fits0 & small, fits1 & small, fits2 & small
    at_l3 = ~(fits0 | fits1 | fits2)

    def pick(i):
        a, b, c = (pl[i] for pl in per_level)
        return torch.where(fits0, a, torch.where(fits1, b, c))

    ty0_s, ty1_s, tx0_s, tx1_s = (pick(i) for i in range(4))
    lb = level_base
    base_s = torch.where(fits0, lb[0], torch.where(fits1, lb[1], lb[2]))
    ntx_s = torch.where(
        fits0, grids[0][1], torch.where(fits1, grids[1][1], grids[2][1])
    )

    keys = []
    for dy in range(wy0):
        for dx in range(wx0):
            ty = ty0_s + dy
            tx = tx0_s + dx
            in_window = (ty <= ty1_s) & (tx <= tx1_s)
            key = base_s + ty * ntx_s + tx
            if dy == 0 and dx == 0:
                key = torch.where(at_l3, base3, key)
                ok = valid & (in_window | at_l3)
            else:
                ok = valid & in_window & ~at_l3
            keys.append(torch.where(ok, key, INT32_MAX))

    units = torch.arange(f_count, device=dev)
    combined = torch.cat([k * f_count + units for k in keys])
    combined, _ = torch.sort(combined)
    sorted_keys = torch.div(combined, f_count, rounding_mode="floor")
    sorted_units = (combined - sorted_keys * f_count).to(torch.int32)

    tile_ids = torch.arange(total_tiles + 1, device=dev)
    starts = torch.searchsorted(sorted_keys, tile_ids, side="left")
    tile_counts = starts[1:] - starts[:-1]

    if return_census:
        maxes = []
        for lvl in range(3):
            n_l = grids[lvl][0] * grids[lvl][1]
            maxes.append(tile_counts[level_base[lvl]:level_base[lvl] + n_l].max())
        maxes.append(tile_counts[base3])
        return torch.stack(maxes)

    def gather_level(base, n_tiles_l, cap):
        st = starts[base:base + n_tiles_l]
        cnt = tile_counts[base:base + n_tiles_l]
        offs = torch.arange(cap, device=dev)
        idx = st[:, None] + offs[None, :]
        ok = offs[None, :] < cnt[:, None]
        vals = sorted_units[torch.clamp(idx, 0, sorted_units.shape[0] - 1)]
        over = torch.clamp(cnt - cap, min=0).sum()
        return (
            torch.where(ok, vals, -1),
            torch.clamp(cnt, max=cap).to(torch.int32),
            over,
        )

    cands, cnts, overflow = [], [], torch.zeros((), dtype=torch.int64, device=dev)
    for lvl in range(4):
        base, n_l = (
            (level_base[lvl], grids[lvl][0] * grids[lvl][1])
            if lvl < 3 else (base3, 1)
        )
        c, n, o = gather_level(base, n_l, config.caps[lvl])
        cands.append(c)
        cnts.append(n)
        overflow = overflow + o
    return BinnedTriangles(cand=tuple(cands), counts=tuple(cnts), overflow=overflow)


def expand_block_ids(cand: torch.Tensor, block: int) -> torch.Tensor:
    """(..., C) block-id lists -> (..., C*block) face ids; empty slots
    expand to -1 and ids inside a block stay ascending."""
    if block == 1:
        return cand
    offs = torch.arange(block, dtype=cand.dtype, device=cand.device)
    face = cand[..., None] * block + offs
    face = torch.where((cand >= 0)[..., None], face, -1)
    return face.reshape(cand.shape[:-1] + (cand.shape[-1] * block,))


def _window(config):
    w0 = config.l0_window
    wy0, wx0 = (w0, w0) if isinstance(w0, int) else w0
    return max(2, int(wy0)), max(2, int(wx0))


def tile_binning(
    setup,
    config,
    image_h: int,
    image_w: int,
    return_census: bool = False,
    exclude_blocks: Optional[torch.Tensor] = None,
):
    """Assign triangles to tile candidate lists.

    Each unit (a face, or a block of ``bin_block`` faces whose box is the
    union of its valid members) goes to the finest level whose window
    covers its box -- ``l0_window`` tiles at level 0, 2x2 at levels 1-2
    -- or to the global list (level 3), giving at most wy*wx (tile key,
    unit) pairs.  The plain version sorts them on the combined int64 key
    ``key * n_units + unit``; the card counts them per tile, scatters the
    units into per-tile segments and sorts each segment (or cuts a long
    one by bitmap windows of unit ids).  Both order the units ascending
    inside each tile, as the tie rules need, and give the same lists.

    With ``return_census`` it returns the exact per-level maximum tile
    occupancy (4,) in units instead, independent of the caps.
    ``exclude_blocks`` ((F / bin_block,) bool) drops the blocks that level
    S took (exclusive assignment: no face is resolved or counted twice),
    from the lists and from the census alike.

    A CUDA tensor launches the CUDA kernels (or raises); only a CPU tensor
    runs the plain version.  On the card the result also carries the
    face-id lists (``face_cand``, ``face_counts``).
    """
    dev = setup.valid.device
    if dev.type == "cpu":
        return bin_triangles_plain(setup, config, image_h, image_w,
                                   return_census, exclude_blocks)
    if dev.type != "cuda":
        raise ValueError(f"tile_binning: unsupported device {dev}")
    return _launch(setup, config, image_h, image_w, return_census, exclude_blocks)


def _launch(setup, config, image_h, image_w, return_census, exclude_blocks):
    """Check the inputs, allocate the outputs (one buffer cut into views)
    and the scratch, and run the whole binning through one C entry
    point."""
    global launches
    valid, bbox = setup.valid, setup.bbox
    dev = valid.device
    n_faces = valid.shape[0]
    bb = config.bin_block
    if valid.dtype != torch.bool or valid.ndim != 1 or not valid.is_contiguous():
        raise ValueError(f"setup.valid must be a contiguous bool (F,), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if (bbox.dtype != torch.int32 or tuple(bbox.shape) != (4, n_faces)
            or bbox.device != dev or not bbox.is_contiguous()):
        raise ValueError(f"setup.bbox must be a contiguous int32 (4, {n_faces}) on "
                         f"{dev}, got {bbox.dtype} {tuple(bbox.shape)}")
    if bb < 1 or n_faces % bb:
        raise ValueError(
            f"face count {n_faces} not a multiple of bin_block {bb}; "
            "pad the mesh to a multiple of bin_block"
        )
    n_units = n_faces // bb
    if exclude_blocks is not None and (
            exclude_blocks.dtype != torch.bool
            or tuple(exclude_blocks.shape) != (n_units,)
            or exclude_blocks.device != dev or not exclude_blocks.is_contiguous()):
        raise ValueError(f"exclude_blocks must be a contiguous bool ({n_units},) on "
                         f"{dev}, got {exclude_blocks.dtype} "
                         f"{tuple(exclude_blocks.shape)}")
    grids = config.grids(image_h, image_w)
    n_tiles = [nty * ntx for nty, ntx in grids] + [1]
    total = sum(n_tiles)
    wy0, wx0 = _window(config)
    if total >= INT32_MAX or n_faces >= INT32_MAX or n_units * wy0 * wx0 >= INT32_MAX:
        raise ValueError(f"tile_binning: {total} tiles of {n_units} units "
                         f"({wy0} x {wx0} slots) exceed the int32 keys and lists")
    caps = [int(c) for c in config.caps]
    stats = torch.empty(5, dtype=torch.int64, device=dev)
    # tile counts and the long-segment queue's two counts (padded to 16
    # bytes), cursors; the queue and the segments (none for the census)
    scratch = torch.empty((total + 5) // 4 * 4 + total
                          + (0 if return_census else total + n_units * wy0 * wx0),
                          dtype=torch.int32, device=dev)
    lists, list_ptrs = [], [None] * 16
    if not return_census:
        # per level: unit lists, counts and, at bin_block > 1, face lists
        # and face counts (at bin_block 1 the unit lists are the face lists)
        sizes = []
        for n, cap in zip(n_tiles, caps):
            sizes += [n * cap, n] + ([n * cap * bb, n] if bb > 1 else [])
        parts = iter(torch.empty(sum(sizes), dtype=torch.int32, device=dev).split(sizes))
        for n, cap in zip(n_tiles, caps):
            cand, counts = next(parts).view(n, cap), next(parts)
            face_cand, face_counts = ((next(parts).view(n, cap * bb), next(parts))
                                      if bb > 1 else (cand, counts))
            lists.append((cand, counts, face_cand, face_counts))
        list_ptrs = [t.data_ptr() for level in lists for t in level]
    level_args = []
    for lvl, scale in enumerate(config.level_scales):
        level_args += [config.tile_h * scale, config.tile_w * scale, grids[lvl][1]]
    # no oversized tail: a bound no unit reaches
    global_from = 2**63 - 1 if config.global_from is None else int(config.global_from)
    # launched under the tensor's device, whose stream it is given
    with torch.cuda.device(dev):
        err = build.load().gg_tile_binning(
            bbox.data_ptr(), valid.data_ptr(),
            None if exclude_blocks is None else exclude_blocks.data_ptr(),
            n_units, bb, global_from, *level_args, *n_tiles[:3], wy0, wx0, *caps,
            *list_ptrs, scratch.data_ptr(), int(return_census),
            stats.data_ptr(), build.stream_ptr(dev))
    build.check(err, "gg_tile_binning")
    launches += 1
    if return_census:
        return stats[1:]
    return BinnedTriangles(
        cand=tuple(x[0] for x in lists), counts=tuple(x[1] for x in lists),
        overflow=stats[0], face_cand=tuple(x[2] for x in lists),
        face_counts=tuple(x[3] for x in lists))
