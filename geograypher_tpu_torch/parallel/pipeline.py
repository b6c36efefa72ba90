"""Survey aggregation with host loading overlapped with device work, over
a list of devices, in PyTorch.

Port of ``geograypher_tpu/parallel/pipeline.py``
``aggregate_class_images_distributed``: the production path of
``aggregate_images`` at survey scale.  Its parts, and what each one
overlaps:

* **Prefetch.**  A pool of ``prefetch_workers`` threads loads each view's
  class image through the provider (by default the host argmax of the
  segmentor's image) ahead of the device, the step being waited on and
  the two after it, and writes it clipped and cast to int8 (int32 past
  127 classes) in one pass straight into the view's row of a step slot
  (:func:`write_label_row`).  Workers run host numpy and, on a card,
  wait on copy events; they launch nothing.
* **Upload.**  Each device has a ring of ``LOOKAHEAD_STEPS + 2`` step
  slots (:class:`_SlotRing`), page-locked on a card.  A worker first waits
  on the event of the copy that last read its slot, captured when the
  view was handed to the pool; the ring is deep enough that the copy has
  long left.  The main thread makes no stack and no staging copy: it
  waits for a step's rows and issues one copy of the slot on a copy
  stream while the device computes the step before, and the compute
  stream waits for it on the device.
* **Compute.**  Each device holds the mesh's (9, F) triangle rows and its
  own accumulators.  Every view runs the fused chain
  (:func:`~geograypher_tpu_torch.ops.rasterize.fused_view_class_counts`:
  setup, binning, the raster kernel, the counts kernel) and adds its
  per-face class fractions, gated on its own overflow.  Every launch
  comes from the main thread in one fixed order, so two runs give the
  same bits.  No overflow scalar is read before the last view.
* **The end.**  One fetch of every overflow; the views that overflowed
  (they added nothing) are re-censused, re-sized and re-run, re-read
  through the provider; then the per-device accumulators are summed onto
  the first device in device order.

Semantics are those of ``TexturedMesh.aggregate_projected_images`` over
one-hot segmentor images: each view contributes its per-face class
fraction (class pixel counts / face pixel count) and the cross-view
result averages those fractions over the views that saw the face.

Not ported, as TPU and compiler workarounds: the jitted step programs and
their caches, the python-unrolled view loop and its pad views, the fold
windows and their auto-sizing probe, the covering config of bucket
tails, the warm-up integrity check (a Mosaic corruption guard), and the
RLE label transport (a workaround for a 40 MB/s host link; an int8 4K
view is 8.3 MB over PCIe here, and the numbers are the same either way).
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import time
import typing

import numpy as np
import torch

from geograypher_tpu_torch.ops.rasterize import RasterConfig, fused_view_class_counts
from geograypher_tpu_torch.parallel import planner as _planner
from geograypher_tpu_torch.parallel.sharding import (
    make_view_mesh,
    sum_over_devices,
)
from geograypher_tpu_torch.utils.profiling import _StageTimer

logger = logging.getLogger(__name__)

LABEL_TRANSPORTS = ("auto", "dense", "rle")
MAX_RETRIES = 2  # re-census rounds before an overflow raises
LOOKAHEAD_STEPS = 3  # steps loading at once: the one waited on and two ahead


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
        row[...] = _planner.as_label_dtype(np.clip(labels, -1, None), n_classes)


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
    """The per-device state of one call: triangle rows, packed view
    parameters, the rings of step slots and the weighted accumulators; and
    the loop that feeds steps of views through them."""

    def __init__(self, device_mesh, tri_soa, params, n_classes, image_h,
                 image_w, use_dist, load, prefetch_workers, group, timer):
        self.mesh = device_mesh
        self.soa = {dev: tri_soa.to(dev) for dev in set(device_mesh)}
        p = torch.as_tensor(np.asarray(params, np.float32))
        self.params = {dev: p.to(dev) for dev in set(device_mesh)}
        f_pad = tri_soa.shape[1]
        self.accs = [(torch.zeros((f_pad, n_classes), dtype=torch.float32,
                                  device=dev),
                      torch.zeros((f_pad,), dtype=torch.float32, device=dev))
                     for dev in device_mesh]
        self.rings = [_SlotRing(dev, LOOKAHEAD_STEPS + 2, group, image_h,
                                image_w, _planner.label_dtype(n_classes))
                      for dev in device_mesh]
        self.n_classes, self.h, self.w = n_classes, image_h, image_w
        self.use_dist = use_dist
        self.load = load  # load(view, row): the view's labels into its row
        self.workers = max(1, int(prefetch_workers))
        self.direct: set = set()  # views a worker wrote into a slot's row
        self.timer = timer  # the call's spans and host times

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

    def run(self, steps) -> list:
        """Load, upload and launch every view of ``steps``, the workers
        loading ``LOOKAHEAD_STEPS`` steps at a time; returns ``[(view,
        overflow on its device)]``."""
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
                row[26], labels, self.w, self.h, config, soa.shape[1],
                self.n_classes, self.use_dist,
            )
            _planner.add_view_gated(self.accs[d], counts, over, weighted=True)
        return over


def aggregate_class_images_distributed(
    mesh,
    cameras,
    n_classes: int,
    class_image_provider: typing.Optional[typing.Callable[[int], np.ndarray]] = None,
    aggregate_img_scale: float = 1.0,
    device_mesh: typing.Optional[typing.Sequence] = None,
    prefetch_workers: int = 4,
    config: typing.Optional[RasterConfig] = None,
    apply_distortion: typing.Optional[bool] = None,
    views_per_step: int = 4,
    integrity_check: bool = True,
    auto_size_fold: bool = True,
    label_transport: str = "auto",
):
    """Aggregate per-view class images onto mesh faces over a list of
    devices, with loading and uploads overlapped with device work.

    Args:
        mesh: TexturedMesh.
        cameras: CameraSet (or SegmentorCameraSet).
        n_classes: number of classes in the label images.
        class_image_provider: ``f(view_index) -> (H, W)`` integer class
            image (negative = unlabeled; ids past ``n_classes`` are
            ignored).  Defaults to the host argmax of
            ``cameras.get_image_by_index`` (segmentor one-hots), -1 where a
            row is not finite.  Called from worker threads.
        device_mesh: the devices views are dealt over
            (:func:`~geograypher_tpu_torch.parallel.sharding.make_view_mesh`;
            default every CUDA device).  A device may appear twice.
        prefetch_workers: host threads loading class images ahead.
        apply_distortion: None (default) rasterizes every view in its
            sensor's distorted pixel space whenever any sensor carries
            distortion or a principal-point offset; False disables.
        views_per_step: views a device takes per step; a step's labels go
            up to each device in one copy of a pinned slot.  Results do not
            depend on it.
        integrity_check: accepted for the JAX package's signature; its
            guard against Mosaic output corruption has no counterpart.
        auto_size_fold: plan the survey (census, cap buckets; the plan is
            cached on the mesh) and run each view at its bucket's caps
            (default).  False runs every view at ``config.caps``.  Either
            way a view that overflows its caps adds nothing, is
            re-censused, re-sized and re-run, and the call raises only
            when overflow persists after ``MAX_RETRIES`` rounds.
        label_transport: "auto", "dense" or "rle", as in the JAX package;
            labels always travel dense (int8 over PCIe), which gives the
            same numbers.  Any other value raises ``ValueError``.

    Returns ``(fraction_sums (F, n_classes), view_counts (F,))`` as float32
    numpy: ``fraction_sums`` is the sum over views of each view's
    per-face class fraction, and ``fraction_sums / view_counts`` (NaN
    where ``view_counts == 0``) is what
    ``TexturedMesh.aggregate_projected_images`` returns.

    One INFO log record of this module's logger carries the run's counts
    and host times as its ``pipeline_stats`` dict: ``views``, ``devices``,
    ``views_per_step``, ``prefetch_workers``, ``retried_views``,
    ``retry_rounds`` and ``direct_views`` (the views whose labels a worker
    wrote straight into a row of a step slot: every view), and these
    seconds, each (but ``seconds``) the time of the span in brackets, which
    a running profiler records too (``utils/profiling.py``):

    * ``seconds``: the whole call;
    * ``prepare_s`` (``pipeline.prepare``): from the call's start up to the
      runner: the rows on the devices, the camera batch, the packed view
      rows, the provider, the accumulators, the slot rings;
    * ``plan_s`` (``planner.plan``): the census and sizing of a plan not
      found in the mesh's cache, its ``plan_seconds`` (the retry rounds'
      re-census is not in it);
    * ``load_s`` (``pipeline.load``): the prefetch workers inside the
      provider and the row write (the clip and the cast), added over the
      workers (they overlap the main thread); ``slot_wait_s``
      (``pipeline.slot_wait``): the workers blocked on a slot's last copy
      before they load, added over the workers;
    * ``fetch_wait_s`` (``pipeline.fetch_wait``): the main thread waiting
      for the workers to fill a step's rows;
    * ``upload_s`` (``pipeline.upload``): the main thread issuing a slot's
      copy to its device;
    * ``enqueue_s`` (``pipeline.enqueue``): the main thread launching the
      views' chains and their gated adds;
    * ``sync_s`` (``pipeline.sync``): the fetches of the overflow flags,
      every retry round's included, and the sum and download of the
      accumulators;
    * ``stack_s``, ``stage_s`` and ``upload_wait_s``: 0.0, the main
      thread's time stacking the labels, copying them into a pinned buffer
      and blocking on that buffer, none of which it does.

    ``prepare_s``, ``plan_s``, ``fetch_wait_s``, ``upload_s``, ``enqueue_s``
    and ``sync_s`` are disjoint parts of ``seconds``.
    """
    del integrity_check  # a Mosaic guard: nothing to check here
    if label_transport not in LABEL_TRANSPORTS:
        raise ValueError(f"unknown label_transport {label_transport!r}")
    t_call = time.perf_counter()
    timer = _StageTimer()
    with timer("pipeline.prepare"):
        device_mesh = make_view_mesh(device_mesh)
        n_dev = len(device_mesh)
        group = max(1, int(views_per_step))
        config = config or mesh.raster_config
        tri_soa = mesh._tri_soa_device(cameras, config.bin_block)
        batch = cameras.get_camera_batch(image_scale=aggregate_img_scale,
                                         device="cpu")
        h, w = batch.image_height, batch.image_width
        if class_image_provider is None:
            class_image_provider = _planner.default_class_image_provider(
                cameras, aggregate_img_scale)
        # one lens model for the whole survey, as the census and the runs
        # share it (the planned paths' rule)
        use_dist = bool(
            (apply_distortion is None or apply_distortion)
            and (bool(batch.distortion.any()) or bool(batch.cx.any())
                 or bool(batch.cy.any()))
        )
        n = len(cameras)
        params = _planner.pack_camera_batch(batch, np.ones(n, np.float32))

        minus_one = np.full((h, w), -1, _planner.label_dtype(n_classes))

        def load(view: int, row: np.ndarray) -> None:
            with timer("pipeline.load"):
                labels = np.asarray(class_image_provider(view))
                if labels.shape != (h, w):
                    raise ValueError(f"view {view}: class image of {labels.shape} "
                                     f"for images of {(h, w)}")
                write_label_row(row, labels, n_classes, minus_one)

        runner = _DeviceRunner(device_mesh, tri_soa, params, n_classes, h, w,
                               use_dist, load, prefetch_workers, group, timer)
    plan_s = 0.0
    if n and auto_size_fold:
        key = ("plan", config, use_dist, w, h, cameras.get_camera_hash())
        plan = mesh._pipeline_cfg_cache.get(key)
        if plan is None:
            plan = _planner.plan_aggregation(
                runner.soa[device_mesh[0]], params, config, h, w,
                tri_soa.shape[1], use_dist=use_dist,
                census_sample=None if n <= 64 else max(12, n // 16),
            )
            mesh._pipeline_cfg_cache[key] = plan
            plan_s = plan.plan_seconds
        runs = [(b.config, b.view_indices) for b in plan.buckets]
    else:
        runs = [(config, range(n))] if n else []
    overs = runner.run(_deal(runs, n_dev, group))

    retried, attempt = 0, 0
    while overs:
        with timer("pipeline.sync"):  # every overflow in one fetch
            flags = torch.stack([o.to(device_mesh[0])
                                 for _, o in overs]).cpu().numpy()
        bad = [v for (v, _), flag in zip(overs, flags) if flag]
        if not bad:
            break
        if attempt >= MAX_RETRIES:
            raise RuntimeError(
                f"capacity overflow persisted after {attempt} resize retries "
                f"(views {bad}); those views contributed nothing")
        attempt += 1
        retried += len(bad)
        logger.warning(
            "capacity overflow: %d views exceeded their caps; re-censusing "
            "and re-running them (attempt %d)", len(bad), attempt)
        sub_plan = _planner.plan_aggregation(
            runner.soa[device_mesh[0]], params[bad],
            _planner.census_config_of(config), h, w, tri_soa.shape[1],
            use_dist=use_dist, max_buckets=1, cap_margin=2.0 * attempt,
        )
        overs = runner.run(_deal([(sub_plan.buckets[0].config, bad)], n_dev, group))

    with timer("pipeline.sync"):
        fracs = sum_over_devices([acc[0] for acc in runner.accs])[: mesh.n_faces]
        views = sum_over_devices([acc[1] for acc in runner.accs])[: mesh.n_faces]
        fracs, views = fracs.cpu().numpy(), views.cpu().numpy()
    stats = dict(
        views=n, devices=[str(d) for d in device_mesh], views_per_step=group,
        prefetch_workers=runner.workers, seconds=time.perf_counter() - t_call,
        plan_s=plan_s, retried_views=retried, retry_rounds=attempt,
        direct_views=len(runner.direct),
        # the workers write each view into its slot's row: the main thread
        # makes no stack, no staging copy and never blocks on a slot
        stack_s=0.0, stage_s=0.0, upload_wait_s=0.0,
        **{f"{key}_s": timer.seconds(f"pipeline.{key}") for key in (
            "prepare", "load", "slot_wait", "fetch_wait", "upload", "enqueue",
            "sync")},
    )
    logger.info("pipeline: %d views on %d devices in %.3f s, %d re-run",
                n, n_dev, stats["seconds"], retried,
                extra={"pipeline_stats": stats})
    return fracs, views
