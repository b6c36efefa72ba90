"""Census-bucketed aggregation planner, in PyTorch.

Port of ``geograypher_tpu/parallel/planner.py``.  Every static capacity of
a view's chain is the binning caps of its tile lists (``RasterConfig.caps``):
the counts kernel adds int32 atomically into the (F, C) table, so the JAX
planner's fold windows, entry compaction and occupied-pair grids have no
counterpart here, and neither does anything sized from them.

What is kept, and why it matters on the card:

* **Census.**  Each view is binned once with ``return_census`` under the
  same setup as its run (distortion, principal point, ``bin_block``
  padding, the level-S diversion), giving its exact per-level maximum
  tile occupancy.  The per-view maxima stay on the device and come back
  in one fetch.
* **Buckets.**  Caps are the census maxima x ``cap_margin``, 16-aligned,
  rounded up on ``CAP_GRID``; views of equal rounded caps share a bucket,
  and the smallest buckets merge until at most ``max_buckets`` remain.  A
  view's caps size the (tiles x cap) gathers of its binning, so a nadir
  view need not pay for the worst oblique's lists.
* **Overflow gating and retry.**  A view whose lists overflow its
  bucket's caps adds nothing (``torch.where(overflow == 0, ...)``) and
  leaves its overflow scalar on the device; the executor's retry fetches
  them all at once, re-censuses exactly the overflowed views, re-sizes
  their caps and re-runs them.  A survey never raises after partial work
  and never drops a count silently.
* **The one executor.**  ``_DeviceRunner`` runs a plan over a list of
  devices: prefetch workers write each view's labels into a ring of
  pinned step slots, a step goes up in one copy, every view runs the fused
  chain and its gated add, and the retry follows.  The survey pipeline
  (``parallel/pipeline.py``) and :class:`PlannedAggregator` both run on it.

Not ported, as TPU and compiler workarounds: the compiled group programs
and their size ladder, the warm corruption check, the program caches,
the unrolled view loop and the pad view.  ``group`` is the number of views
whose labels go up to the card in one pinned copy; results do not depend
on it.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import logging
import time
import typing

import numpy as np
import torch

from geograypher_tpu_torch.ops.rasterize import (
    RasterConfig,
    bin_triangles,
    fused_view_class_counts,
    setup_from_soa,
)
from geograypher_tpu_torch.ops.subtile import subtile_mask8
from geograypher_tpu_torch.parallel.sharding import sum_over_devices
from geograypher_tpu_torch.utils.profiling import _StageTimer, annotate

logger = logging.getLogger(__name__)

# packed per-view parameter row: [w2c (16), f, dist (8), pcx, pcy, valid]
PROW = 28

CAP_MARGIN = 1.25  # census maxima x margin, before 16-alignment

# rounding grid of the bucket keys: views whose margined caps round to the
# same grid point share a bucket
CAP_GRID = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def pack_view_params(
    world_to_cam: np.ndarray,
    f: np.ndarray,
    distortion: typing.Optional[np.ndarray] = None,
    cx: typing.Optional[np.ndarray] = None,
    cy: typing.Optional[np.ndarray] = None,
    valid: typing.Optional[np.ndarray] = None,
) -> np.ndarray:
    """(N, 28) float32 packed per-view parameter rows, one host -> device
    copy for every camera scalar.  Layout: [w2c (16), f, dist8, pcx, pcy,
    valid]."""
    n = np.asarray(f).shape[0]
    z = np.zeros((n, 1), np.float32)
    return np.concatenate(
        [
            np.asarray(world_to_cam, np.float32).reshape(n, 16),
            np.asarray(f, np.float32).reshape(n, 1),
            (
                np.asarray(distortion, np.float32).reshape(n, 8)
                if distortion is not None
                else np.zeros((n, 8), np.float32)
            ),
            np.asarray(cx, np.float32).reshape(n, 1) if cx is not None else z,
            np.asarray(cy, np.float32).reshape(n, 1) if cy is not None else z,
            (
                np.asarray(valid, np.float32).reshape(n, 1)
                if valid is not None
                else np.ones((n, 1), np.float32)
            ),
        ],
        axis=1,
    )


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def pack_camera_batch(batch, valid: np.ndarray) -> np.ndarray:
    """Pack a ``CameraBatch`` (on any device) into (N, 28) parameter rows."""
    n = valid.shape[0]
    return pack_view_params(
        _host(batch.world_to_cam).astype(np.float32),
        _host(batch.f).astype(np.float32).reshape(n),
        _host(batch.distortion).astype(np.float32).reshape(n, 8),
        _host(batch.cx).astype(np.float32).reshape(n),
        _host(batch.cy).astype(np.float32).reshape(n),
        valid.astype(np.float32).reshape(n),
    )


def unpack_row(row: torch.Tensor, use_dist: bool):
    """One packed parameter row -> (w2c, f, distortion-or-None, valid)."""
    w2c = row[:16].reshape(4, 4)
    f = row[16]
    distortion = (row[17:25], row[25], row[26]) if use_dist else None
    return w2c, f, distortion, row[27]


# ---------------------------------------------------------------------------
# Plan data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One census bucket: its sized config and the views it runs."""

    config: RasterConfig  # caps sized from the census
    view_indices: typing.Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class AggregationPlan:
    """One survey's census-sized aggregation plan."""

    buckets: typing.Tuple[BucketPlan, ...]
    image_h: int
    image_w: int
    n_faces: int
    use_dist: bool
    n_views: int
    plan_seconds: float  # census + sizing wall time
    # built from a sampled census: un-censused views may exceed their
    # bucket's caps, which the runner's gating and retry cover
    sampled: bool = False

    @property
    def cover_config(self) -> RasterConfig:
        """One config whose caps cover every view (elementwise max over
        the buckets), for a consumer that needs a single shape."""
        caps = tuple(
            max(b.config.caps[i] for b in self.buckets) for i in range(4)
        )
        return dataclasses.replace(self.buckets[0].config, caps=caps)


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


def census_view(tri_soa, row, config: RasterConfig, use_dist: bool,
                 image_h: int, image_w: int) -> torch.Tensor:
    """One view's exact per-level maximum tile occupancy (4,), on the
    device, under the setup its run uses (with level S on, of the L0..L3
    lists after the diversion)."""
    w2c, f, dist, _ = unpack_row(row, use_dist)
    setup = setup_from_soa(tri_soa, w2c, f, image_w, image_h, config.znear,
                           distortion=dist)
    exclude = None if config.subtile is None else subtile_mask8(setup, config)
    return bin_triangles(setup, config, image_h, image_w, return_census=True,
                         exclude_blocks=exclude)


def _margin_caps(lvl: np.ndarray, margin: float) -> tuple:
    """Censused per-level maxes -> margined, 16-aligned cap tuple."""
    return tuple(
        int(max(16, -(-int(np.ceil(c * margin)) // 16) * 16)) for c in lvl
    )


def census_caps(census, config: RasterConfig,
                cap_margin: float = CAP_MARGIN) -> RasterConfig:
    """``config`` with caps that hold every census in ``census`` (per-level
    maxima, (4,) or (N, 4)): the elementwise maximum, margined and
    16-aligned as a plan's bucket caps are."""
    lvl = np.asarray(census).reshape(-1, 4).max(axis=0)
    return dataclasses.replace(config, caps=_margin_caps(lvl, cap_margin))


def _bucket_key(caps: tuple) -> tuple:
    return tuple(
        min((g for g in CAP_GRID if g >= c), default=c) for c in caps
    )


def _merge_buckets(buckets: dict, max_buckets: int) -> dict:
    """Merge the smallest buckets until <= max_buckets remain.

    Each merge moves the smallest-view-count bucket into whichever other
    bucket minimizes the added work (sum of elementwise-max caps weighted
    by merged view count)."""
    while len(buckets) > max(1, max_buckets):
        keys = sorted(buckets, key=lambda key: (len(buckets[key]), sum(key)))
        src = keys[0]

        def merge_cost(dst):
            merged = tuple(max(a, b) for a, b in zip(src, dst))
            return sum(merged) * (len(buckets[src]) + len(buckets[dst])) - (
                sum(src) * len(buckets[src]) + sum(dst) * len(buckets[dst])
            )

        dst = min((key for key in keys[1:]), key=merge_cost)
        merged_key = tuple(max(a, b) for a, b in zip(src, dst))
        views_merged = buckets.pop(src) + buckets.pop(dst)
        buckets.setdefault(merged_key, []).extend(views_merged)
    return buckets


def census_config_of(config: RasterConfig) -> RasterConfig:
    """The config the census runs under: same geometry (bin_block,
    windows, levels, sub-tile cells), caps cleared."""
    return dataclasses.replace(config, caps=(8, 8, 8, 8))


@annotate("planner.plan")
def plan_aggregation(
    tri_soa: torch.Tensor,
    params: np.ndarray,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    n_faces: int,
    *,
    use_dist: bool = False,
    max_buckets: int = 4,
    cap_margin: float = CAP_MARGIN,
    census_sample: typing.Optional[int] = None,
    sample_extra_margin: float = 1.4,
) -> AggregationPlan:
    """Census views, bucket them, and size each bucket's caps.

    Args:
        tri_soa: (9, F_pad) coordinate rows on the device (``tri_to_soa``).
        params: (N, 28) packed view rows (:func:`pack_view_params`).
        config: base RasterConfig; its geometry fields are kept, its caps
            replaced per bucket by censused values.
        census_sample: census only this many evenly spaced views (first
            and last included); the others take the caps of their nearest
            censused neighbour by index, every cap gets
            ``sample_extra_margin`` on top, and the runner's overflow
            gating and retry cover the rest.

    ``plan_seconds`` is the census and sizing wall time, the one fetch of
    the census included.
    """
    n_views = params.shape[0]
    if n_views == 0:
        raise ValueError("no views to plan")
    t_plan0 = time.perf_counter()
    census_cfg = census_config_of(config)

    sampled = census_sample is not None and 0 < census_sample < n_views
    if sampled:
        idx = np.unique(
            np.round(np.linspace(0, n_views - 1, census_sample)).astype(int)
        )
        census_idx = [int(i) for i in idx]
        extra = sample_extra_margin
    else:
        census_idx = list(range(n_views))
        extra = 1.0

    params_dev = torch.as_tensor(
        np.asarray(params, np.float32)).to(tri_soa.device)
    # every census is launched before the one fetch of their stacked maxima
    lvls = torch.stack([
        census_view(tri_soa, params_dev[k], census_cfg, use_dist, image_h,
                     image_w)
        for k in census_idx
    ]).cpu().numpy()
    view_caps = {
        k: _margin_caps(lvls[i], cap_margin * extra)
        for i, k in enumerate(census_idx)
    }
    if sampled:
        # nearest censused neighbour by view index: survey views are
        # ordered along flight lines, so adjacent views share a pose regime
        carr = np.asarray(census_idx)
        for k in range(n_views):
            if k not in view_caps:
                view_caps[k] = view_caps[int(carr[np.argmin(np.abs(carr - k))])]

    buckets: dict = {}
    for k in range(n_views):
        buckets.setdefault(_bucket_key(view_caps[k]), []).append(k)
    buckets = _merge_buckets(buckets, max_buckets)
    logger.info(
        "census buckets: %s",
        ", ".join(f"{key} x{len(v)}" for key, v in buckets.items()),
    )
    return AggregationPlan(
        buckets=tuple(
            BucketPlan(config=dataclasses.replace(config, caps=key),
                       view_indices=tuple(idxs))
            for key, idxs in sorted(buckets.items())
        ),
        image_h=image_h,
        image_w=image_w,
        n_faces=n_faces,
        use_dist=use_dist,
        n_views=n_views,
        plan_seconds=time.perf_counter() - t_plan0,
        sampled=sampled,
    )


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

MAX_RETRIES = 2  # re-census rounds before an overflow raises
LOOKAHEAD_STEPS = 3  # steps loading at once: the one waited on and two ahead


def survey_use_dist(batch, apply_distortion: typing.Optional[bool]) -> bool:
    """The lens rule, one lens model for a survey as its census and runs
    must share it: every view rasterizes in its distorted pixel space when
    any sensor of ``batch`` has distortion or a principal-point offset,
    unless ``apply_distortion`` is False."""
    return bool((apply_distortion is None or apply_distortion) and (
        batch.distortion.any() or batch.cx.any() or batch.cy.any()))


def default_class_image_provider(cameras, image_scale: float):
    """The JAX package's default class-image provider: the host argmax of
    each view's image, -1 where a row is not all finite; a 2-D image is
    taken as class ids with NaN -> -1."""

    def provider(i: int) -> np.ndarray:
        img = np.asarray(cameras.get_image_by_index(i, image_scale))
        if img.ndim == 3:
            finite = np.isfinite(img).all(axis=-1)
            cls = np.argmax(np.nan_to_num(img), axis=-1)
            return np.where(finite, cls, -1).astype(np.int32)
        return np.nan_to_num(img, nan=-1).astype(np.int32)

    return provider


def label_dtype(n_classes: int) -> np.dtype:
    """Host dtype of a class-image stack: int8 when class ids fit."""
    return np.dtype(np.int8 if n_classes <= 127 else np.int32)


def as_label_dtype(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """``labels`` in :func:`label_dtype`; a narrowing cast first maps every
    id outside ``[0, n_classes)`` to -1, so that none can wrap into range."""
    labels = np.asarray(labels)
    dtype = label_dtype(n_classes)
    if labels.dtype.itemsize > dtype.itemsize:
        labels = np.where((labels >= 0) & (labels < n_classes), labels, -1)
    return labels.astype(dtype, copy=False)


def write_label_row(row: np.ndarray, labels: np.ndarray, n_classes: int,
                    minus_one: np.ndarray) -> None:
    """``row[...] = as_label_dtype(np.clip(labels, -1, None), n_classes)``:
    ids below -1 become -1, and a narrowing cast first maps every id
    outside ``[0, n_classes)`` to -1.  Labels already in the row's dtype
    take one vectorised pass, ``max(labels, minus_one)`` with ``minus_one``
    -1s of the row's shape and dtype: numpy runs that loop with the
    interpreter lock released, where it holds the lock against a broadcast
    row of -1s and runs a scalar -1 several times slower."""
    if labels.dtype == row.dtype:
        np.maximum(labels, minus_one, out=row)
    else:
        row[...] = as_label_dtype(np.clip(labels, -1, None), n_classes)


def add_view_gated(accs, counts: torch.Tensor, over: torch.Tensor,
                   weighted: bool) -> None:
    """Add one view's (F, C) class counts into the accumulators in place,
    gated on its overflow (a view whose lists dropped candidates adds
    nothing).  Pooled: ``accs = (counts,)``.  Weighted: ``accs =
    (value_sum, view_count)``, the view's per-face class fraction counts /
    total and a 1 for every face it saw."""
    ok = over == 0
    if weighted:
        tot = counts.sum(dim=1, keepdim=True)
        seen = tot > 0
        mean = torch.where(seen, counts / torch.clamp(tot, min=1.0), 0.0)
        accs[0].add_(torch.where(ok, mean, 0.0))
        accs[1].add_((ok & seen[:, 0]).to(torch.float32))
    else:
        accs[0].add_(torch.where(ok, counts, 0.0))


def _deal(runs, n_dev: int, group: int) -> list:
    """``[(config, views)]`` -> steps ``[(config, [views of device d])]``:
    each run's views in steps of ``n_dev * group``, a step's views cut into
    ``n_dev`` contiguous shards (a short last step shares out evenly)."""
    steps = []
    for config, views in runs:
        for s0 in range(0, len(views), n_dev * group):
            step = list(views[s0:s0 + n_dev * group])
            per = -(-len(step) // n_dev)
            steps.append((config, [step[d * per:(d + 1) * per]
                                   for d in range(n_dev)]))
    return steps


class _SlotRing:
    """The step slots of one device, used in turn: ``depth`` buffers of
    ``group`` label images, page-locked on a card.  The prefetch workers
    write each view's labels into its row of a slot (:meth:`take`), and
    :meth:`upload` sends a slot's rows to the device in one copy, issued on
    one copy stream of the device.  The consumer waits on the device, not
    on the host: the caller's current stream waits on the copy's event,
    and the returned tensor is recorded on that stream, so the caching
    allocator does not hand its memory out before the consumer's work on
    it has run.  Each slot keeps the event of the copy that last read it,
    which a worker waits on before it writes there.  On a CPU device a
    slot's rows are the labels, which the chain consumes before it returns:
    no copy and no event."""

    def __init__(self, device, depth: int, group: int, h: int, w: int, dtype):
        self.device = torch.device(device)
        self.slots = torch.empty((depth, group, h, w),
                                 dtype=getattr(torch, np.dtype(dtype).name),
                                 pin_memory=self.device.type == "cuda")
        self.read: list = [None] * depth  # event of the copy out of each slot
        self._next = 0
        self._stream: typing.Optional[torch.cuda.Stream] = None

    def take(self):
        """The next slot: (its index, its rows as numpy, the event of the
        copy that last read it or None)."""
        k = self._next
        self._next = (k + 1) % len(self.read)
        return k, self.slots[k].numpy(), self.read[k]

    def upload(self, k: int, n: int) -> torch.Tensor:
        """The first ``n`` rows of slot ``k`` on the device."""
        host = self.slots[k, :n]
        if self.device.type != "cuda":
            return host
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            # allocated on the copy stream: a block the consumer freed with
            # work still queued is not reused before that work has run
            on_device = torch.empty(host.shape, dtype=host.dtype,
                                    device=self.device)
            on_device.copy_(host, non_blocking=True)
        read = torch.cuda.Event()
        read.record(self._stream)
        consumer.wait_event(read)
        on_device.record_stream(consumer)
        self.read[k] = read
        return on_device


class _DeviceRunner:
    """The one executor of an aggregation plan over a list of devices: the
    per-device triangle rows, packed view parameters, rings of step slots
    and accumulators of one call, the loop that feeds steps of ``group``
    views a device through them, and the overflow retry.  The survey
    pipeline runs it on its device list, :class:`PlannedAggregator` on one.
    ``load(view, row)`` writes a view's labels into its row of a step slot,
    on a prefetch worker; ``weighted`` selects :func:`add_view_gated`'s
    accumulation; ``timer`` times the spans ``pipeline.*``.  Every launch
    comes from the calling thread in one fixed order: two runs give the
    same bits."""

    def __init__(self, device_mesh, tri_soa, params, n_classes, image_h,
                 image_w, n_faces, use_dist, load, group, timer, *,
                 prefetch_workers: int = 4, weighted: bool = True,
                 max_retries: int = MAX_RETRIES):
        self.mesh = device_mesh
        self.soa = {dev: tri_soa.to(dev) for dev in set(device_mesh)}
        self.host_params = np.asarray(params, np.float32)
        p = torch.as_tensor(self.host_params)
        self.params = {dev: p.to(dev) for dev in set(device_mesh)}
        self.n_classes, self.h, self.w = n_classes, image_h, image_w
        self.n_faces, self.use_dist, self.weighted = n_faces, use_dist, weighted
        self.clear()
        self.rings = [_SlotRing(dev, LOOKAHEAD_STEPS + 2, group, image_h,
                                image_w, label_dtype(n_classes))
                      for dev in device_mesh]
        self.group, self.max_retries = group, max_retries
        self.load = load
        self.workers = max(1, int(prefetch_workers))
        self.direct: set = set()  # views a worker wrote into a slot's row
        self.timer = timer  # the call's spans and host times

    def clear(self) -> None:
        """Zeroed accumulators on every device: ``(value_sum,
        view_count)`` weighted, ``(counts,)`` pooled."""
        shapes = ((self.n_faces, self.n_classes), (self.n_faces,))
        self.accs = [tuple(torch.zeros(shape, dtype=torch.float32, device=dev)
                           for shape in shapes[: 2 if self.weighted else 1])
                     for dev in self.mesh]

    def _fill(self, view: int, row: np.ndarray, read) -> None:
        """A worker: wait for the slot's last copy to leave, then load."""
        if read is not None:
            with self.timer("pipeline.slot_wait"):
                read.synchronize()
        self.load(view, row)

    def _submit(self, pool, shards) -> list:
        """A step's views to the workers, each with its row of the next slot
        of its device's ring: ``[(device, views, slot, futures)]``."""
        out = []
        for d, views in enumerate(shards):
            if views:
                k, rows, read = self.rings[d].take()
                out.append((d, views, k, [pool.submit(self._fill, v, rows[i], read)
                                          for i, v in enumerate(views)]))
        return out

    def run(self, runs) -> list:
        """Load, upload and launch every view of ``runs`` (``[(config,
        views)]``, dealt over the devices in steps), the workers loading
        ``LOOKAHEAD_STEPS`` steps at a time; returns ``[(view, overflow on
        its device)]``.  No overflow scalar is read."""
        steps = _deal(runs, len(self.mesh), self.group)
        overs = []
        pool = concurrent.futures.ThreadPoolExecutor(self.workers)
        try:
            loading = collections.deque()
            for s, (config, _) in enumerate(steps):
                while len(loading) < LOOKAHEAD_STEPS and s + len(loading) < len(steps):
                    loading.append(self._submit(pool, steps[s + len(loading)][1]))
                for d, views, k, futures in loading.popleft():
                    with self.timer("pipeline.fetch_wait"):
                        for future in futures:
                            future.result()
                    self.direct.update(views)
                    with self.timer("pipeline.upload"):
                        labels = self.rings[d].upload(k, len(views))
                    for j, view in enumerate(views):
                        overs.append((view, self._view(d, config, view,
                                                       labels[j])))
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        return overs

    def _view(self, d, config: RasterConfig, view: int, labels) -> torch.Tensor:
        with self.timer("pipeline.enqueue"):
            dev = self.mesh[d]
            soa, row = self.soa[dev], self.params[dev][view]
            counts, over, _ = fused_view_class_counts(
                soa, row[:16].reshape(4, 4), row[16], row[17:25], row[25],
                row[26], labels, self.w, self.h, config, self.n_faces,
                self.n_classes, self.use_dist,
            )
            add_view_gated(self.accs[d], counts, over, self.weighted)
        return over

    def retry(self, overs, config: RasterConfig) -> list:
        """Re-run the views that overflowed (they added nothing) until none
        does: a round fetches every overflow at once, re-censuses the
        round's overflowed views into one sub-plan (``config``'s geometry,
        ``cap_margin`` 2.0 x the round) and re-runs them, re-read through
        ``load``.  Returns each round's overflowed views; raises
        ``RuntimeError`` when overflow persists after ``max_retries``
        rounds."""
        rounds: list = []
        while overs:
            with self.timer("pipeline.sync"):  # every overflow in one fetch
                flags = torch.stack([o.to(self.mesh[0])
                                     for _, o in overs]).cpu().numpy()
            bad = [v for (v, _), flag in zip(overs, flags) if flag]
            if not bad:
                break
            if len(rounds) >= self.max_retries:
                raise RuntimeError(
                    f"capacity overflow persisted after {len(rounds)} resize "
                    f"retries: views {bad} contributed nothing")
            rounds.append(bad)
            logger.warning(
                "capacity overflow: %d views exceeded their caps; re-censusing "
                "and re-running them (attempt %d)", len(bad), len(rounds))
            sub_plan = plan_aggregation(
                self.soa[self.mesh[0]], self.host_params[bad],
                census_config_of(config), self.h, self.w, self.n_faces,
                use_dist=self.use_dist, max_buckets=1,
                cap_margin=2.0 * len(rounds),
            )
            overs = self.run([(sub_plan.buckets[0].config, bad)])
        return rounds

    def download(self, n_rows: int) -> tuple:
        """The accumulators summed onto the first device in device order,
        their first ``n_rows`` rows, as numpy."""
        with self.timer("pipeline.sync"):
            totals = [sum_over_devices([acc[i] for acc in self.accs])[:n_rows]
                      for i in range(len(self.accs[0]))]
            return tuple(t.cpu().numpy() for t in totals)


class PlannedAggregator:
    """Executes an :class:`AggregationPlan`: (M, H, W) class images in,
    (n_faces, n_classes) pixel counts out.

    By default the POOLED aggregation (the sum over views of each view's
    per-face per-class pixel counts).  With ``weighted=True`` each view's
    counts are normalised per face (counts / total) and the accumulators
    are (value_sum, view_count): the view-weighted semantics of
    ``TexturedMesh.aggregate_projected_images``; ``finalize()`` then
    returns that pair.

    A face over the survey executor (:class:`_DeviceRunner`) on the device
    of the triangle rows, whose steps are ``group`` views: its ring of
    ``LOOKAHEAD_STEPS + 2`` step slots holds 5 x ``group`` label images of
    page-locked host memory on a card (0.83 GB at ``group`` 20 and 4K
    int8), beside the label stack it copies them from.  A view that
    overflows is re-run by the executor's retry at ``cap_margin`` 2.0 x the
    round; ``retry_margin`` is kept for the JAX class's signature and not
    read (its default gives ``1.25 * retry_margin`` = 2.0, the first
    round's margin).

    Typical use::

        plan = plan_aggregation(tri_soa, params, config, H, W, n_faces)
        agg = PlannedAggregator(plan, n_classes, group=20)
        agg.prepare(tri_soa, params, labels)
        acc = agg.run()                 # launches only, device accumulator
        counts = agg.finalize()         # one overflow fetch, retry, numpy
    """

    def __init__(
        self,
        plan: AggregationPlan,
        n_classes: int,
        group: int = 20,
        max_retries: int = 2,
        retry_margin: float = 1.6,
        weighted: bool = False,
    ):
        self.plan = plan
        self.n_classes = n_classes
        self.group = max(1, int(group))
        self.max_retries = max_retries
        self.retry_margin = retry_margin
        self.weighted = weighted
        self.resizes = 0  # buckets whose views were re-run, over the rounds
        self._runner: typing.Optional[_DeviceRunner] = None
        self._overs: list = []  # (view, overflow on device)

    def prepare(self, tri_soa, params: np.ndarray, labels,
                label_index=None) -> None:
        """Bind the inputs.

        ``labels`` is an (M, H, W) integer class stack, numpy or a tensor.
        It is kept on the host in :func:`label_dtype`; the executor's
        workers copy each view's row into a pinned step slot, and a step
        goes up to the card in one copy.  ``label_index`` maps view id ->
        row of ``labels`` (default: the identity, M == n_views), so views
        can share rows.
        """
        plan = self.plan
        labels = as_label_dtype(_host(labels), self.n_classes)
        if labels.shape[1:] != (plan.image_h, plan.image_w):
            raise ValueError(
                f"labels of {tuple(labels.shape[1:])} for images of "
                f"{(plan.image_h, plan.image_w)}"
            )
        if label_index is None:
            if labels.shape[0] != plan.n_views:
                raise ValueError(
                    f"{labels.shape[0]} label rows for {plan.n_views} views "
                    "without a label_index"
                )
            label_index = np.arange(plan.n_views)
        label_index = np.asarray(label_index, np.int64)

        def load(view: int, row: np.ndarray) -> None:
            row[...] = labels[label_index[view]]

        self._runner = _DeviceRunner(
            [tri_soa.device], tri_soa, params, self.n_classes, plan.image_h,
            plan.image_w, plan.n_faces, plan.use_dist, load, self.group,
            _StageTimer(), weighted=self.weighted, max_retries=self.max_retries)

    def run(self):
        """Launch every view of every bucket; returns the device
        accumulator (callers time this and one sync).  Each view's
        overflow scalar stays on the device for :meth:`finalize`."""
        self._runner.clear()
        self._overs = self._runner.run(
            [(b.config, b.view_indices) for b in self.plan.buckets])
        return self._runner.accs[0][0]

    def finalize(self):
        """Fetch every overflow at once; re-census, re-size and re-run the
        views that overflowed (their contributions were gated to zero),
        then return the (n_faces, n_classes) numpy counts, or with
        ``weighted`` the ``(value_sum, view_count)`` numpy pair.  Raises
        when overflow persists after ``max_retries`` rounds."""
        plan = self.plan
        rounds = self._runner.retry(self._overs, plan.buckets[0].config)
        self._overs = []
        self.resizes += sum(not set(bad).isdisjoint(b.view_indices)
                            for bad in rounds for b in plan.buckets)
        out = self._runner.download(plan.n_faces)
        return out if self.weighted else out[0]

    def close(self) -> None:
        """Drop this aggregator's executor: its labels, parameters,
        accumulators and pinned ring."""
        self._runner = None
        self._overs = []


def _aggregate_planned(weighted, tri_soa, params, labels, config, image_h,
                       image_w, n_faces, n_classes, use_dist, max_buckets,
                       group, census_sample, plan, label_index):
    """The body of the one-call planned aggregations: (finalize's result,
    plan)."""
    if plan is None:
        plan = plan_aggregation(
            tri_soa, params, config, image_h, image_w, n_faces,
            use_dist=use_dist, max_buckets=max_buckets,
            census_sample=census_sample,
        )
    agg = PlannedAggregator(plan, n_classes, group=group, weighted=weighted)
    agg.prepare(tri_soa, params, labels, label_index=label_index)
    agg.run()
    out = agg.finalize()
    agg.close()
    return out, plan


def aggregate_counts_planned(
    tri_soa,
    params: np.ndarray,
    labels,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    n_faces: int,
    n_classes: int,
    *,
    use_dist: bool = False,
    max_buckets: int = 4,
    group: int = 20,
    census_sample: typing.Optional[int] = None,
    plan: typing.Optional[AggregationPlan] = None,
    label_index=None,
) -> typing.Tuple[np.ndarray, AggregationPlan]:
    """One-call planned aggregation: census -> buckets -> gated runs ->
    (n_faces, n_classes) pixel counts after the overflow retry.  Pass
    ``plan`` to reuse a plan of the same cameras and shapes."""
    return _aggregate_planned(
        False, tri_soa, params, labels, config, image_h, image_w, n_faces,
        n_classes, use_dist, max_buckets, group, census_sample, plan,
        label_index)


def aggregate_projected_planned(
    tri_soa,
    params: np.ndarray,
    labels,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    n_faces: int,
    n_classes: int,
    *,
    use_dist: bool = False,
    max_buckets: int = 4,
    group: int = 20,
    census_sample: typing.Optional[int] = None,
    plan: typing.Optional[AggregationPlan] = None,
    label_index=None,
) -> typing.Tuple[np.ndarray, np.ndarray, AggregationPlan]:
    """One-call VIEW-WEIGHTED planned aggregation: per view the per-face
    class distribution counts / total, summed over the views that saw the
    face.  Returns ``(value_sum (F, C), view_count (F,), plan)``; the
    average is ``value_sum / view_count``, NaN where unseen."""
    (value_sum, view_count), plan = _aggregate_planned(
        True, tri_soa, params, labels, config, image_h, image_w, n_faces,
        n_classes, use_dist, max_buckets, group, census_sample, plan,
        label_index)
    return value_sum, view_count, plan
