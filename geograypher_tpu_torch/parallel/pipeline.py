"""Survey aggregation with host loading overlapped with device work, over
a list of devices, in PyTorch.

Port of ``geograypher_tpu/parallel/pipeline.py``
``aggregate_class_images_distributed``: the production path of
``aggregate_images`` at survey scale.  Its parts, and what each one
overlaps:

* **Prefetch.**  A pool of ``prefetch_workers`` threads loads each view's
  class image through the provider (by default the host argmax of the
  segmentor's image), clips it and casts it to int8 (int32 past 127
  classes), ahead of the device.  Workers run host numpy only.
* **Upload.**  The main thread stages each step's labels, one stack a
  device, through that device's two-slot pinned upload
  (:class:`~geograypher_tpu_torch.utils.device.PinnedUpload`): the copy
  runs on a copy stream while the device computes the step before, and
  the compute stream waits for it on the device.
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
from geograypher_tpu_torch.utils.device import PinnedUpload
from geograypher_tpu_torch.utils.profiling import _StageTimer

logger = logging.getLogger(__name__)

LABEL_TRANSPORTS = ("auto", "dense", "rle")
MAX_RETRIES = 2  # re-census rounds before an overflow raises


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


class _DeviceRunner:
    """The per-device state of one call: triangle rows, packed view
    parameters, the two-slot upload and the weighted accumulators; and
    the loop that feeds steps of views through them."""

    def __init__(self, device_mesh, tri_soa, params, n_classes, image_h,
                 image_w, use_dist, load, prefetch_workers, timer):
        self.mesh = device_mesh
        self.soa = {dev: tri_soa.to(dev) for dev in set(device_mesh)}
        p = torch.as_tensor(np.asarray(params, np.float32))
        self.params = {dev: p.to(dev) for dev in set(device_mesh)}
        f_pad = tri_soa.shape[1]
        self.accs = [(torch.zeros((f_pad, n_classes), dtype=torch.float32,
                                  device=dev),
                      torch.zeros((f_pad,), dtype=torch.float32, device=dev))
                     for dev in device_mesh]
        self.uploads = [PinnedUpload(dev) for dev in device_mesh]
        self.n_classes, self.h, self.w = n_classes, image_h, image_w
        self.use_dist = use_dist
        self.load = load
        self.workers = max(1, int(prefetch_workers))
        self.timer = timer  # the call's spans and host times

    def run(self, steps) -> list:
        """Load, upload and launch every view of ``steps``, prefetching two
        steps ahead; returns ``[(view, overflow on its device)]``."""
        order = [v for _, shards in steps for shard in shards for v in shard]
        lookahead = 3 * max((sum(len(s) for s in shards) for _, shards in steps),
                            default=1)
        overs = []
        pool = concurrent.futures.ThreadPoolExecutor(self.workers)
        try:
            futures: dict = {}
            pos = 0
            for config, shards in steps:
                for j in range(len(futures) + pos, min(pos + lookahead, len(order))):
                    futures[j] = pool.submit(self.load, order[j])
                for d, views in enumerate(shards):
                    if not views:
                        continue
                    with self.timer("pipeline.fetch_wait"):
                        loaded = [futures.pop(pos + j).result()
                                  for j in range(len(views))]
                        with self.timer("pipeline.stack"):
                            stack = np.stack(loaded)
                        del loaded  # the workers' arrays go before the upload
                    pos += len(views)
                    with self.timer("pipeline.upload"):
                        labels = self.uploads[d](stack)
                    for k, view in enumerate(views):
                        overs.append((view, self._view(d, config, view,
                                                       labels[k])))
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
            up to each device in one pinned copy.  Results do not depend on
            it.
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
    ``views_per_step``, ``prefetch_workers``, ``retried_views`` and
    ``retry_rounds``, and these seconds, each (but ``seconds``) the time
    of the span in brackets, which a running profiler records too
    (``utils/profiling.py``):

    * ``seconds``: the whole call;
    * ``prepare_s`` (``pipeline.prepare``): from the call's start up to the
      runner: the rows on the devices, the camera batch, the packed view
      rows, the provider, the accumulators;
    * ``plan_s`` (``planner.plan``): the census and sizing of a plan not
      found in the mesh's cache, its ``plan_seconds`` (the retry rounds'
      re-census is not in it);
    * ``load_s`` (``pipeline.load``): the prefetch workers inside the
      provider, the clip and the cast, added over the workers (they
      overlap the main thread);
    * ``fetch_wait_s`` (``pipeline.fetch_wait``): the main thread taking a
      step's class images from the workers and stacking them; ``stack_s``
      (``pipeline.stack``): the stack alone;
    * ``upload_s`` (``pipeline.upload``): the main thread inside the
      two-slot pinned upload; ``upload_wait_s`` (``upload.wait``): inside
      it, blocked on a slot's last copy; ``stage_s`` (``upload.stage``):
      inside it, the copy into the pinned buffer;
    * ``enqueue_s`` (``pipeline.enqueue``): the main thread launching the
      views' chains and their gated adds;
    * ``sync_s`` (``pipeline.sync``): the fetches of the overflow flags,
      every retry round's included, and the sum and download of the
      accumulators.

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

        def load(view: int) -> np.ndarray:
            with timer("pipeline.load"):
                labels = np.clip(np.asarray(class_image_provider(view)), -1, None)
                if labels.shape != (h, w):
                    raise ValueError(f"view {view}: class image of {labels.shape} "
                                     f"for images of {(h, w)}")
                return _planner.as_label_dtype(labels, n_classes)

        runner = _DeviceRunner(device_mesh, tri_soa, params, n_classes, h, w,
                               use_dist, load, prefetch_workers, timer)
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
        upload_wait_s=sum(u.wait_s for u in runner.uploads),
        stage_s=sum(u.stage_s for u in runner.uploads),
        **{f"{key}_s": timer.seconds(f"pipeline.{key}") for key in (
            "prepare", "load", "fetch_wait", "stack", "upload", "enqueue",
            "sync")},
    )
    logger.info("pipeline: %d views on %d devices in %.3f s, %d re-run",
                n, n_dev, stats["seconds"], retried,
                extra={"pipeline_stats": stats})
    return fracs, views
