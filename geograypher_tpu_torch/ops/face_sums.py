"""Per-segment float sums in a fixed order: the means path's per-face sum.

:func:`face_sums` turns ``(keys (N,), values (N, C), n_segments)`` into
per-segment sums of the finite values and their counts, both (S, C).  Keys
outside ``[0, n_segments)`` (background pixels, -1) are dropped.

The order is fixed, so two runs give the same bits, on the card as on the
CPU.  The entries are cut into tiles of 1024: 32 x 32 pixels when
``shape=(H, W)`` names the image the entries are the pixels of (tiles
numbered row-major over the tile grid, the last row and column cut by the
image), else runs of 1024 consecutive entries.  A segment's finite values
within one tile are added from 0.0 in the tile's row-major position order,
which is the entries' index order; the segment's per-tile partial sums are
then added from 0.0 in tile order.  Non-finite values are skipped and not
counted.

On a CUDA tensor it launches the hand-written kernels of
``csrc/face_sums.cu`` (tiles staged in shared memory, each tile's keys
grouped by warp matches and a shared-memory hash, partial records merged
in tile order; no sort of the entries, no float atomics); on a CPU tensor
it runs :func:`face_sums_plain`, which adds in the same order and is
bit-equal to the kernels.

Kernel source note.  Replaces no TPU kernel: the JAX package's
``segment_sum`` (``geograypher_tpu/ops/aggregate.py:76``) is an XLA op.
It takes the place of ``index_add``, whose float atomics on the card add
in no fixed order.  Bound by bytes: keys and values read once, the
partial records written and read once, the sums and counts written once
(see the source for the design).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from geograypher_tpu_torch.kernels import build

# kernel launches since the last reset (the main path's proof of use)
launches = 0

TILE = 1024  # entries of a tile
TILE_2D = (32, 32)  # (rows, columns) of an image's tile


def _tiling(n: int, shape: Optional[Tuple[int, int]]):
    """``((H, W), (tile rows, tile columns))``: an image's 32 x 32 tiles,
    or, without a shape, one row of N entries in runs of 1024."""
    if shape is None:
        return (1, n), (1, TILE)
    h, w = (int(s) for s in shape)
    if h < 0 or w < 0 or h * w != n:
        raise ValueError(f"shape {tuple(shape)} does not hold {n} entries")
    return (h, w), TILE_2D


def _ordered_sums(rows: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                  skip_nonfinite: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sums of the runs ``rows[starts[g] : starts[g] + lengths[g]]``, each
    added from 0.0 in row order, one round per position in the runs, and
    the number of values added (non-finite ones skipped when asked)."""
    g, c = starts.shape[0], rows.shape[1]
    sums = torch.zeros((g, c), dtype=torch.float32, device=rows.device)
    counts = torch.zeros((g, c), dtype=torch.int32, device=rows.device)
    live = torch.nonzero(lengths > 0).reshape(-1)
    r = 0
    while live.numel():
        v = rows[starts[live] + r]
        ok = torch.isfinite(v) if skip_nonfinite else torch.ones_like(v, dtype=torch.bool)
        sums[live] = torch.where(ok, sums[live] + v, sums[live])
        counts[live] += ok.to(torch.int32)
        r += 1
        live = live[lengths[live] > r]
    return sums, counts


def face_sums_plain(keys: torch.Tensor, values: torch.Tensor, n_segments: int,
                    shape: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, in the kernels' order: a stable sort by
    (segment, tile) in index order, then the per-(segment, tile) partial
    sums of the finite values, then each segment's partials in tile
    order."""
    n, c = values.shape
    dev = values.device
    sums = torch.zeros((n_segments, c), dtype=torch.float32, device=dev)
    counts = torch.zeros((n_segments, c), dtype=torch.int32, device=dev)
    if n == 0:
        return sums, counts
    (h, w), (th, tw) = _tiling(n, shape)
    ntx = -(-w // tw)
    n_tiles = -(-h // th) * ntx
    idx = torch.arange(n, device=dev)
    tile = (idx // w) // th * ntx + (idx % w) // tw
    k = keys.reshape(-1).long()
    sel = torch.nonzero((k >= 0) & (k < n_segments)).reshape(-1)
    pair = k[sel] * n_tiles + tile[sel]
    pair, perm = torch.sort(pair, stable=True)
    order = sel[perm]
    # level 1: one partial per (segment, tile) run, in index order
    new = torch.ones_like(pair, dtype=torch.bool)
    new[1:] = pair[1:] != pair[:-1]
    g_start = torch.nonzero(new).reshape(-1)
    g_len = torch.diff(g_start, append=torch.tensor([pair.numel()], device=dev))
    part, part_n = _ordered_sums(values[order], g_start, g_len, skip_nonfinite=True)
    # level 2: a segment's partials, consecutive and in tile order
    g_seg = pair[g_start] // n_tiles
    s_new = torch.ones_like(g_seg, dtype=torch.bool)
    s_new[1:] = g_seg[1:] != g_seg[:-1]
    s_start = torch.nonzero(s_new).reshape(-1)
    s_len = torch.diff(s_start, append=torch.tensor([g_seg.numel()], device=dev))
    seg_sums, _ = _ordered_sums(part, s_start, s_len, skip_nonfinite=False)
    sums[g_seg[s_start]] = seg_sums
    counts.index_add_(0, g_seg, part_n)
    return sums, counts


def face_sums(keys: torch.Tensor, values: torch.Tensor, n_segments: int,
              shape: Optional[Tuple[int, int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums (S, C) float32, counts (S, C) int32)`` of ``values`` by key,
    in the fixed two-level order of the module docstring.

    Args:
        keys: (N,) integer segment ids; ids outside ``[0, n_segments)``
            are dropped.
        values: (N, C) float32, contiguous; non-finite values are skipped
            and not counted.
        shape: ``(H, W)`` when the entries are an image's pixels in
            row-major order (32 x 32 tiles); None for a plain list (runs
            of 1024 entries).

    A CUDA tensor launches the CUDA kernels (or raises); only a CPU tensor
    runs the plain version.
    """
    global launches
    if keys.ndim != 1 or keys.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"keys must be (N,) int32 or int64, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if values.dtype != torch.float32 or values.ndim != 2 or not values.is_contiguous():
        raise ValueError(f"values must be contiguous float32 (N, C), got "
                         f"{values.dtype} {tuple(values.shape)}")
    if values.shape[0] != keys.shape[0] or values.device != keys.device:
        raise ValueError(f"values {tuple(values.shape)} on {values.device} for "
                         f"keys {tuple(keys.shape)} on {keys.device}")
    n, c = values.shape
    if not 0 <= n_segments < 2**31 or n >= 2**31:
        raise ValueError(f"need 0 <= n_segments < 2^31 and N < 2^31, got "
                         f"{n_segments}, {n}")
    (h, w), (_, tw) = _tiling(n, shape)
    if keys.device.type == "cpu":
        return face_sums_plain(keys, values, n_segments, shape)
    if keys.device.type != "cuda":
        raise ValueError(f"face_sums: unsupported device {keys.device}")
    sums = torch.empty((n_segments, c), dtype=torch.float32, device=values.device)
    counts = torch.empty((n_segments, c), dtype=torch.int32, device=values.device)
    keys = keys.contiguous()
    lib = build.load()
    scratch = torch.empty(lib.gg_face_sums_scratch_bytes(n, n_segments, c),
                          dtype=torch.uint8, device=values.device)
    # launched under the tensor's device, whose stream it is given
    with torch.cuda.device(values.device):
        err = lib.gg_face_sums(
            keys.data_ptr(), int(keys.dtype == torch.int64), values.data_ptr(), n, h, w,
            tw.bit_length() - 1, n_segments, c, scratch.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), build.stream_ptr(values.device),
        )
    build.check(err, "gg_face_sums")
    launches += 1
    return sums, counts
