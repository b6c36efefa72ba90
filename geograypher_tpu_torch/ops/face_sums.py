"""Per-segment float sums in a fixed order: the means path's per-face sum.

:func:`face_sums` turns ``(keys (N,), values (N, C), n_segments)`` into
per-segment sums of the finite values and their counts, both (S, C).  Keys
outside ``[0, n_segments)`` (background pixels, -1) are dropped.  The sum
order is fixed before any addition: a stable sort of the keys gives every
segment its values in index order, and an integer bincount + cumsum its
bounds.  So two runs give the same bits, on the card as on the CPU, and the
order is the one a sequential ``segment_sum`` adds in.

On a CUDA tensor it launches the hand-written kernel ``csrc/face_sums.cu``
(one thread per (segment, channel), ``__fadd_rn`` in sorted order); on a
CPU tensor it runs :func:`face_sums_plain`, which adds in the same order,
one round per position in the segments, and is bit-equal to the kernel.

Kernel source note.  Replaces no TPU kernel: the JAX package's
``segment_sum`` (``geograypher_tpu/ops/aggregate.py:76``) is an XLA op.
It takes the place of ``index_add``, whose float atomics on the card add
in no fixed order.  Bound by bytes: each value read once, the sums and
counts written once (see the source for the design).
"""

from __future__ import annotations

from typing import Tuple

import torch

from geograypher_tpu_torch.kernels import build

# kernel launches since the last reset (the main path's proof of use)
launches = 0


def segment_order(keys: torch.Tensor, n_segments: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order (N,) int64, bounds (S + 1,) int64)``: the indices of the
    keys in stable key order, those outside ``[0, n_segments)`` last, and
    each segment's start in ``order`` (``bounds[-1]`` is the number of
    valid keys; nothing reads past it).  Integer ops only, so it is the
    same on every run, and nothing is read back to the host."""
    k = keys.reshape(-1).long()
    k = torch.where((k >= 0) & (k < n_segments), k, n_segments)
    order = torch.sort(k, stable=True).indices
    per_segment = torch.bincount(k, minlength=n_segments + 1)[:n_segments]
    bounds = torch.nn.functional.pad(torch.cumsum(per_segment, dim=0), (1, 0))
    return order, bounds


def face_sums_plain(values: torch.Tensor, order: torch.Tensor,
                    bounds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: round r adds every segment's r-th value (in
    ``order``) to its running sum, skipping non-finite values, so each
    segment is summed from 0.0 in sorted order as the kernel sums it."""
    n_segments = bounds.shape[0] - 1
    c = values.shape[1]
    sums = torch.zeros((n_segments, c), dtype=torch.float32, device=values.device)
    counts = torch.zeros((n_segments, c), dtype=torch.int32, device=values.device)
    starts, length = bounds[:-1], bounds[1:] - bounds[:-1]
    live = torch.nonzero(length > 0).reshape(-1)
    r = 0
    while live.numel():
        v = values[order[starts[live] + r]]
        ok = torch.isfinite(v)
        sums[live] = torch.where(ok, sums[live] + v, sums[live])
        counts[live] += ok.to(torch.int32)
        r += 1
        live = live[length[live] > r]
    return sums, counts


def face_sums(keys: torch.Tensor, values: torch.Tensor, n_segments: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums (S, C) float32, counts (S, C) int32)`` of ``values`` by key.

    Args:
        keys: (N,) integer segment ids; ids outside ``[0, n_segments)``
            are dropped.
        values: (N, C) float32, contiguous; non-finite values are skipped
            and not counted.

    A CUDA tensor launches the CUDA kernel (or raises); only a CPU tensor
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
    if n_segments < 0 or keys.shape[0] >= 2**31:
        raise ValueError(f"need n_segments >= 0 and N < 2^31, got {n_segments}, "
                         f"{keys.shape[0]}")
    order, bounds = segment_order(keys, n_segments)
    if keys.device.type == "cpu":
        return face_sums_plain(values, order, bounds)
    if keys.device.type != "cuda":
        raise ValueError(f"face_sums: unsupported device {keys.device}")
    c = values.shape[1]
    sums = torch.empty((n_segments, c), dtype=torch.float32, device=values.device)
    counts = torch.empty((n_segments, c), dtype=torch.int32, device=values.device)
    order32 = order.to(torch.int32)
    lib = build.load()
    err = lib.gg_face_sums(
        values.data_ptr(), order32.data_ptr(), bounds.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), n_segments, c,
        build.stream_ptr(values.device),
    )
    build.check(err, "gg_face_sums")
    launches += 1
    return sums, counts
