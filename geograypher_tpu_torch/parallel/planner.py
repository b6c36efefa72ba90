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
  leaves its overflow scalar on the device; :meth:`PlannedAggregator.finalize`
  fetches them all at once, re-censuses exactly the overflowed views,
  re-sizes their caps and re-runs them.  A survey never raises after
  partial work and never drops a count silently.

Not ported, as TPU and compiler workarounds: the compiled group programs
and their size ladder, the warm corruption check, the program caches,
the unrolled view loop and the pad view.  ``group`` is the number of views
whose labels go up to the card in one pinned copy; results do not depend
on it.
"""

from __future__ import annotations

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
from geograypher_tpu_torch.utils.device import PinnedUpload
from geograypher_tpu_torch.utils.profiling import annotate

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


class PlannedAggregator:
    """Executes an :class:`AggregationPlan`: (M, H, W) class images in,
    (n_faces, n_classes) pixel counts out.

    By default the POOLED aggregation (the sum over views of each view's
    per-face per-class pixel counts).  With ``weighted=True`` each view's
    counts are normalised per face (counts / total) and the accumulators
    are (value_sum, view_count): the view-weighted semantics of
    ``TexturedMesh.aggregate_projected_images``; ``finalize()`` then
    returns that pair.

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
        self.resizes = 0  # buckets re-sized by the overflow retry
        self._accs = None
        self._overs: list = []  # (bucket position, view, overflow on device)

    def prepare(self, tri_soa, params: np.ndarray, labels,
                label_index=None) -> None:
        """Bind the inputs.

        ``labels`` is an (M, H, W) integer class stack, numpy or a tensor.
        It is kept on the host in :func:`label_dtype` and goes up a group of
        views at a time through one pinned staging buffer, widened to int32
        on the card.  ``label_index`` maps view id -> row of ``labels``
        (default: the identity, M == n_views), so views can share rows.
        """
        plan = self.plan
        self.tri_soa = tri_soa
        self._params = np.asarray(params, np.float32)
        self._params_dev = torch.as_tensor(self._params).to(tri_soa.device)
        labels = as_label_dtype(_host(labels), self.n_classes)
        if labels.shape[1:] != (plan.image_h, plan.image_w):
            raise ValueError(
                f"labels of {tuple(labels.shape[1:])} for images of "
                f"{(plan.image_h, plan.image_w)}"
            )
        self._labels = labels
        if label_index is None:
            if labels.shape[0] != plan.n_views:
                raise ValueError(
                    f"{labels.shape[0]} label rows for {plan.n_views} views "
                    "without a label_index"
                )
            label_index = np.arange(plan.n_views)
        self._lidx = np.asarray(label_index, np.int64)
        self._upload = PinnedUpload(tri_soa.device)

    def _init_accs(self):
        plan = self.plan
        dev = self.tri_soa.device
        acc = torch.zeros((plan.n_faces, self.n_classes), dtype=torch.float32,
                          device=dev)
        if self.weighted:
            return (acc, torch.zeros((plan.n_faces,), dtype=torch.float32,
                                     device=dev))
        return (acc,)

    def _run_views(self, config: RasterConfig, views, pos: int) -> list:
        """Run ``views`` under ``config`` a group at a time, each view's
        contribution gated on its own overflow (the accumulators are
        updated in place); returns [(pos, view, overflow)]."""
        plan = self.plan
        overs = []
        for start in range(0, len(views), self.group):
            group = views[start:start + self.group]
            labels = self._upload(self._labels[self._lidx[group]])
            for k, view in enumerate(group):
                row = self._params_dev[view]
                counts, over, _ = fused_view_class_counts(
                    self.tri_soa, row[:16].reshape(4, 4), row[16], row[17:25],
                    row[25], row[26], labels[k], plan.image_w, plan.image_h,
                    config, plan.n_faces, self.n_classes, plan.use_dist,
                )
                add_view_gated(self._accs, counts, over, self.weighted)
                overs.append((pos, view, over))
        return overs

    def run(self):
        """Launch every view of every bucket; returns the device
        accumulator (callers time this and one sync).  Each view's
        overflow scalar stays on the device for :meth:`finalize`."""
        self._accs = self._init_accs()
        self._overs = []
        for pos, bucket in enumerate(self.plan.buckets):
            self._overs += self._run_views(bucket.config,
                                           list(bucket.view_indices), pos)
        return self._accs[0]

    def finalize(self):
        """Fetch every overflow at once; re-census, re-size and re-run the
        views that overflowed (their contributions were gated to zero),
        then return the (n_faces, n_classes) numpy counts, or with
        ``weighted`` the ``(value_sum, view_count)`` numpy pair.  Raises
        when overflow persists after ``max_retries`` rounds."""
        plan = self.plan
        retries = 0
        while self._overs:
            flags = torch.stack([o for _, _, o in self._overs]).cpu().numpy()
            bad: dict = {}
            for (pos, view, _), flag in zip(self._overs, flags):
                if flag:
                    bad.setdefault(pos, []).append(view)
            if not bad:
                break
            if retries >= self.max_retries:
                raise RuntimeError(
                    "aggregation overflow persisted after "
                    f"{self.max_retries} resize retries (buckets "
                    f"{[plan.buckets[p].config.caps for p in bad]}, views "
                    f"{sorted(v for vs in bad.values() for v in vs)})"
                )
            retries += 1
            self.resizes += len(bad)
            new_overs = []
            for pos, views in bad.items():
                bucket = plan.buckets[pos]
                logger.warning(
                    "bucket %s: %d views overflowed their caps; re-censusing "
                    "and re-running them", bucket.config.caps, len(views),
                )
                sub_plan = plan_aggregation(
                    self.tri_soa, self._params[views],
                    census_config_of(bucket.config), plan.image_h,
                    plan.image_w, plan.n_faces, use_dist=plan.use_dist,
                    max_buckets=1, cap_margin=1.25 * self.retry_margin,
                )
                new_overs += self._run_views(sub_plan.buckets[0].config,
                                             views, pos)
            # only the re-run views can still overflow
            self._overs = new_overs
        if self.weighted:
            return self._accs[0].cpu().numpy(), self._accs[1].cpu().numpy()
        return self._accs[0].cpu().numpy()

    def close(self) -> None:
        """Drop this aggregator's buffers (labels, parameters,
        accumulators, the pinned staging buffer)."""
        self._labels = self._params = self._params_dev = None
        self._accs = None
        self._overs = []
        self._upload = None
        self.tri_soa = None  # shared with the caller: drop the reference only


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
    if plan is None:
        plan = plan_aggregation(
            tri_soa, params, config, image_h, image_w, n_faces,
            use_dist=use_dist, max_buckets=max_buckets,
            census_sample=census_sample,
        )
    agg = PlannedAggregator(plan, n_classes, group=group)
    agg.prepare(tri_soa, params, labels, label_index=label_index)
    agg.run()
    counts = agg.finalize()
    agg.close()
    return counts, plan


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
    if plan is None:
        plan = plan_aggregation(
            tri_soa, params, config, image_h, image_w, n_faces,
            use_dist=use_dist, max_buckets=max_buckets,
            census_sample=census_sample,
        )
    agg = PlannedAggregator(plan, n_classes, group=group, weighted=True)
    agg.prepare(tri_soa, params, labels, label_index=label_index)
    agg.run()
    value_sum, view_count = agg.finalize()
    agg.close()
    return value_sum, view_count, plan
