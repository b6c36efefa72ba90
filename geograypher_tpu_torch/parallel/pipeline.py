"""Survey aggregation with host loading overlapped with device work, over
a list of devices, in PyTorch.

Port of ``geograypher_tpu/parallel/pipeline.py``
``aggregate_class_images_distributed``: the production path of
``aggregate_images`` at survey scale.  This module is the provider-driven
call: its load function, its plan from the mesh's one plan cache and its
``pipeline_stats`` record.  What follows the plan is the one executor of
an aggregation plan, ``_DeviceRunner`` in ``parallel/planner.py``, which
:class:`~geograypher_tpu_torch.parallel.planner.PlannedAggregator` runs
too.  Its parts, and what each one overlaps:

* **Prefetch.**  A pool of ``prefetch_workers`` threads loads each view's
  class image through the provider (by default the host argmax of the
  segmentor's image) ahead of the device, the step being waited on and
  the two after it, and writes it clipped and cast to int8 (int32 past
  127 classes) in one pass straight into the view's row of a step slot
  (``planner.write_label_row``).  Workers run host numpy and, on a card,
  wait on copy events; they launch nothing.
* **Upload.**  Each device has a ring of ``LOOKAHEAD_STEPS + 2`` step
  slots (``planner._SlotRing``), page-locked on a card.  A worker first waits
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

import logging
import time
import typing

import numpy as np

from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.parallel import planner as _planner
from geograypher_tpu_torch.parallel.sharding import make_view_mesh
from geograypher_tpu_torch.utils.profiling import _StageTimer

logger = logging.getLogger(__name__)

LABEL_TRANSPORTS = ("auto", "dense", "rle")


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
            when overflow persists after ``planner.MAX_RETRIES`` rounds.
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
        use_dist = _planner.survey_use_dist(batch, apply_distortion)
        n = len(cameras)
        params = _planner.pack_camera_batch(batch, np.ones(n, np.float32))

        minus_one = np.full((h, w), -1, _planner.label_dtype(n_classes))

        def load(view: int, row: np.ndarray) -> None:
            with timer("pipeline.load"):
                labels = np.asarray(class_image_provider(view))
                if labels.shape != (h, w):
                    raise ValueError(f"view {view}: class image of {labels.shape} "
                                     f"for images of {(h, w)}")
                _planner.write_label_row(row, labels, n_classes, minus_one)

        runner = _planner._DeviceRunner(
            device_mesh, tri_soa, params, n_classes, h, w, tri_soa.shape[1],
            use_dist, load, group, timer, prefetch_workers=prefetch_workers,
            max_retries=_planner.MAX_RETRIES)
    plan_s = 0.0
    if n and auto_size_fold:
        plan, planned = mesh._survey_plan(
            cameras, runner.soa[device_mesh[0]], params, config, h, w,
            use_dist, census_sample=None if n <= 64 else max(12, n // 16))
        plan_s = plan.plan_seconds if planned else 0.0
        runs = [(b.config, b.view_indices) for b in plan.buckets]
    else:
        runs = [(config, range(n))] if n else []
    rounds = runner.retry(runner.run(runs), config)
    fracs, views = runner.download(mesh.n_faces)
    stats = dict(
        views=n, devices=[str(d) for d in device_mesh], views_per_step=group,
        prefetch_workers=runner.workers, seconds=time.perf_counter() - t_call,
        plan_s=plan_s, retried_views=sum(len(bad) for bad in rounds),
        retry_rounds=len(rounds),
        direct_views=len(runner.direct),
        # the workers write each view into its slot's row: the main thread
        # makes no stack, no staging copy and never blocks on a slot
        stack_s=0.0, stage_s=0.0, upload_wait_s=0.0,
        **{f"{key}_s": timer.seconds(f"pipeline.{key}") for key in (
            "prepare", "load", "slot_wait", "fetch_wait", "upload", "enqueue",
            "sync")},
    )
    logger.info("pipeline: %d views on %d devices in %.3f s, %d re-run",
                n, n_dev, stats["seconds"], stats["retried_views"],
                extra={"pipeline_stats": stats})
    return fracs, views
