"""The port's survey pipeline (``geograypher_tpu_torch/parallel/
pipeline.py``) and view sharding (``parallel/sharding.py``) against the
JAX package's on CPU devices (JAX Pallas in interpret mode, its view mesh
on 2-3 of the suite's virtual CPU devices; the port's device list
``["cpu", ...]``), on ``tests/test_sharding.py``'s tiny scenes: a pinhole
sensor, a distorted sensor and a level-S configuration.  Also the port's
own guarantees: the pipeline equals its streaming path, any device count
gives the same sums to f32 rounding, an undersized cap is gated and
re-run, and a port version of ``__graft_entry__.dryrun_multichip``."""

import dataclasses
import logging
import re
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops import rasterize as jr
from geograypher_tpu.parallel import pipeline as jpipeline
from geograypher_tpu.parallel import sharding as jsharding
from geograypher_tpu.predictors.segmentors import ArraySegmentor
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.meshes import chunked as tchunked
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops import face_counts, face_sums, onehot, raster_tiles, subtile
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.parallel import pipeline as tpipeline
from geograypher_tpu_torch.parallel import planner as tplanner
from geograypher_tpu_torch.parallel import sharding as tsharding
from geograypher_tpu_torch.utils.device import PinnedUpload
from geograypher_tpu_torch.utils.fixtures import (
    gather_tri_verts,
    make_grid_mesh,
    nadir_camera,
    oblique_camera,
)
from tests.test_sharding import _pipeline_scene
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
N_CLASSES = 3
FRAC_ATOL = 1e-5  # per-view fractions summed in another order
# the JAX pipeline's smallest programs: one view a device a step, and no
# warm-up check (a second program); results do not depend on either
JAX_FEWEST = dict(views_per_step=1, integrity_check=False)
S_CFG = dict(bin_block=8, l0_window=(5, 2), subtile=(8, 16), s_window=(3, 2),
             s_block=4)


def jax_view_mesh(n):
    return jsharding.make_view_mesh(jax.devices()[:n])


def use_dist_of(batch):
    return bool(np.any(np.asarray(batch.distortion)) or np.any(np.asarray(batch.cx))
                or np.any(np.asarray(batch.cy)))


def swapped_faces(jmesh, jcams, tmesh, tcams, jcfg):
    """The faces touched by a pixel that the JAX raster (``jcfg``'s
    backend) and the port's give to different faces, in any view, in the
    lens model the pipelines rasterize every view in.  Both rasters meet
    the knife-edge contract (``tests/test_pallas_raster.py``: such pixels
    are face-to-face swaps); only counts and fractions of these faces may
    differ.  Also returns the share of pixels that differ."""
    jb = jcams.get_camera_batch()
    tb = tcams.get_camera_batch(device="cpu")
    h, w = tb.image_height, tb.image_width
    use_dist = use_dist_of(jb)
    tcfg = interop.raster_config_from_jax(jcfg)
    jsoa = jmesh._tri_soa_device(jcams)
    tsoa = tmesh._tri_soa_device(tcams, tcfg.bin_block)

    @jax.jit
    def jax_p2f(w2c, f, d8, cx, cy):
        setup = jr.setup_from_soa(jsoa, w2c, f, w, h, jcfg.znear,
                                  distortion=(d8, cx, cy) if use_dist else None)
        return jr.rasterize_setup(setup, dataclasses.replace(jcfg, subtile=None),
                                  h, w)[0]

    swapped = np.zeros(max(jsoa.shape[1], tsoa.shape[1]) + 1, bool)
    differ = 0
    for k in range(len(tcams)):
        pj = np.asarray(jax_p2f(jb.world_to_cam[k], jb.f[k], jb.distortion[k],
                                jb.cx[k], jb.cy[k]))
        setup = tr.setup_from_soa(
            tsoa, tb.world_to_cam[k], tb.f[k], w, h, tcfg.znear,
            distortion=(tb.distortion[k], tb.cx[k], tb.cy[k]) if use_dist else None)
        pt = tr.rasterize_setup(setup, dataclasses.replace(tcfg, subtile=None),
                                h, w)[0].numpy()
        d = pj != pt
        assert (pj[d] >= 0).all() and (pt[d] >= 0).all(), "face vs background"
        differ += int(d.sum())
        swapped[pj[d]] = swapped[pt[d]] = True
    return swapped[: tmesh.n_faces], differ / (len(tcams) * h * w)


def assert_pipelines_agree(port, want, swapped):
    """View counts equal and fractions within ``FRAC_ATOL`` on every face
    no swap touched; the swapped faces are a small share."""
    (ft, vt), (fj, vj) = port, want
    assert ft.shape == fj.shape and vt.shape == vj.shape
    keep = ~swapped
    np.testing.assert_array_equal(vt[keep], vj[keep])
    seen = keep & (vj > 0)
    assert seen.sum() > 0.3 * len(vj)
    np.testing.assert_allclose(ft[seen] / vt[seen, None], fj[seen] / vj[seen, None],
                               atol=FRAC_ATOL)
    np.testing.assert_array_equal(ft[keep & (vj == 0)], 0)


def stream_reference(tmesh, tseg, **kwargs):
    """The port's streaming path: (value_sum, view_count)."""
    _, info = tmesh.aggregate_projected_images(tseg, use_planned=False, **kwargs)
    return info["summed_projections"], info["projection_counts"]


def assert_equals_stream(port, stream):
    (ft, vt), (fs, vs) = port, stream
    np.testing.assert_array_equal(vt, vs)
    seen = vs > 0
    np.testing.assert_allclose(ft[seen] / vt[seen, None], fs[seen] / vs[seen, None],
                               atol=FRAC_ATOL)


# -- the pinhole scene: tests/test_sharding.py:63-160 ---------------------------


@pytest.fixture(scope="module")
def pinhole():
    """``_pipeline_scene``'s mesh and 5 nadir views (labels rendered from
    the face texture, served as one-hot stacks), on both packages, the
    JAX pipeline's result over 2 devices and the swapped faces."""
    jmesh, jcams, jseg, labels = _pipeline_scene(backend="pallas")
    tmesh = interop.mesh_from_jax(jmesh, device="cpu")
    tseg = interop.cameras_from_jax(jseg)
    want = jpipeline.aggregate_class_images_distributed(
        jmesh, jseg, n_classes=N_CLASSES, device_mesh=jax_view_mesh(2), **JAX_FEWEST)
    swapped, share = swapped_faces(jmesh, jcams, tmesh, interop.cameras_from_jax(jcams),
                                   jmesh.raster_config)
    return tmesh, tseg, labels, want, swapped, share


def test_pinhole_equals_jax_and_stream(pinhole):
    tmesh, tseg, labels, want, swapped, share = pinhole
    port = tpipeline.aggregate_class_images_distributed(
        tmesh, tseg, N_CLASSES, device_mesh=["cpu", "cpu"])
    # the scene's nadir cameras put pixel centres on shared edges
    assert share < 0.03 and swapped.mean() < 0.4
    assert_pipelines_agree(port, want, swapped)
    assert_equals_stream(port, stream_reference(tmesh, tseg))
    # the argmax recovers the rendered labels
    seen = port[1] > 0
    np.testing.assert_array_equal(np.argmax(port[0], axis=1)[seen], labels[seen])


@pytest.mark.parametrize("n_dev,views_per_step,workers", [
    (1, 4, 4), (2, 1, 1), (3, 2, 4), (2, 4, 2)])
def test_device_count_changes_only_rounding(pinhole, n_dev, views_per_step, workers):
    """One device, or two or three (a short last step), any step size and
    any number of prefetch workers: view counts exactly, the fraction sums
    to f32 rounding; the same call twice: the same bits."""
    tmesh, tseg, *_ = pinhole
    ref = tpipeline.aggregate_class_images_distributed(
        tmesh, tseg, N_CLASSES, device_mesh=["cpu"], views_per_step=1)
    run = lambda: tpipeline.aggregate_class_images_distributed(  # noqa: E731
        tmesh, tseg, N_CLASSES, device_mesh=["cpu"] * n_dev,
        views_per_step=views_per_step, prefetch_workers=workers)
    (f1, v1), (f2, v2) = run(), run()
    assert np.array_equal(f1, f2) and np.array_equal(v1, v2)
    np.testing.assert_array_equal(v1, ref[1])
    np.testing.assert_allclose(f1, ref[0], rtol=1e-6, atol=1e-6)


def test_label_transport(pinhole):
    """"auto", "dense" and "rle" are accepted and give the same numbers
    (labels travel dense); anything else raises as in the JAX package."""
    tmesh, tseg, *_ = pinhole
    out = [tpipeline.aggregate_class_images_distributed(
        tmesh, tseg, N_CLASSES, device_mesh=["cpu"], label_transport=lt)
        for lt in ("auto", "dense", "rle")]
    for f, v in out[1:]:
        assert np.array_equal(f, out[0][0]) and np.array_equal(v, out[0][1])
    with pytest.raises(ValueError, match="unknown label_transport"):
        tpipeline.aggregate_class_images_distributed(
            tmesh, tseg, N_CLASSES, device_mesh=["cpu"], label_transport="zip")


def test_plan_cached_on_the_mesh_and_dropped_on_edit(pinhole):
    tmesh, tseg, *_ = pinhole
    mesh = TexturedMesh((tmesh.verts, tmesh.faces),
                        raster_config=tmesh.raster_config, device="cpu")
    tpipeline.aggregate_class_images_distributed(mesh, tseg, N_CLASSES,
                                                 device_mesh=["cpu"])
    (key, plan), = mesh._plan_cache.items()
    assert key[-1] == tseg.get_camera_hash() and plan.n_views == len(tseg)
    tpipeline.aggregate_class_images_distributed(mesh, tseg, N_CLASSES,
                                                 device_mesh=["cpu"])
    assert mesh._plan_cache[key] is plan
    mesh.spatial_sort_faces()
    assert not mesh._plan_cache


def run_logged(caplog, **kwargs):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="geograypher_tpu_torch.parallel.pipeline"):
        out = tpipeline.aggregate_class_images_distributed(**kwargs)
    stats, = [r.pipeline_stats for r in caplog.records
              if hasattr(r, "pipeline_stats")]
    return out, stats, [r.message for r in caplog.records
                        if r.levelno == logging.WARNING]


# the record's disjoint parts of ``seconds``, and its times nested in them
DISJOINT = ("prepare_s", "plan_s", "fetch_wait_s", "upload_s", "enqueue_s", "sync_s")
INNER = ("load_s", "slot_wait_s", "stack_s", "stage_s", "upload_wait_s")


@pytest.mark.parametrize("caps", [None, (16, 16, 16, 16)], ids=["planned", "retried"])
def test_pipeline_stats_parts_nest_and_add_up(pinhole, caplog, caps):
    """Every host time of the record is there and non-negative, and the
    disjoint parts add to no more than the call; the workers write every
    view into its row, so the main thread's stack, staging copy and slot
    wait read 0; a planned call on a fresh mesh plans, a call whose views
    all overflow re-runs them."""
    tmesh, tseg, *_ = pinhole
    mesh = TexturedMesh((tmesh.verts, tmesh.faces),
                        raster_config=tmesh.raster_config, device="cpu")
    kwargs = {} if caps is None else dict(
        auto_size_fold=False,
        config=dataclasses.replace(tmesh.raster_config, caps=caps))
    _, stats, _ = run_logged(caplog, mesh=mesh, cameras=tseg, n_classes=N_CLASSES,
                             device_mesh=["cpu", "cpu"], **kwargs)
    assert all(stats[k] >= 0 for k in DISJOINT + INNER + ("seconds",))
    # only a plan not in the mesh's cache is timed; a CPU slot has no copy
    # for a worker to wait on
    assert all(stats[k] > 0 for k in DISJOINT + ("load_s",) if k != "plan_s")
    assert stats["stack_s"] == stats["stage_s"] == stats["upload_wait_s"] == 0.0
    assert stats["slot_wait_s"] == 0.0
    assert stats["direct_views"] == stats["views"] == len(tseg)
    assert (stats["plan_s"] > 0) == (caps is None)
    assert stats["retried_views"] == (0 if caps is None else len(tseg))
    assert sum(stats[k] for k in DISJOINT) <= stats["seconds"]


def raw_labels(dtype, n_classes, n_views, seed=3):
    """Seeded (n_views, 80, 80) class images of ``dtype`` with ids below -1
    and at or past ``n_classes`` beside every class."""
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -300), min(info.max, n_classes + 300)
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, n_classes, (n_views, 80, 80))
    wild = rng.random(labels.shape) < 0.2
    labels[wild] = rng.integers(lo, hi, int(wild.sum()))
    return labels.astype(dtype)


def as_uploaded_before(monkeypatch):
    """The labels as the pipeline uploaded them before its workers wrote
    into pinned rows: ``as_label_dtype(np.clip(...))`` as written, a stack
    of a step's images, the two-slot upload."""
    def rule(row, labels, n_classes, minus_one):
        row[...] = tplanner.as_label_dtype(np.clip(labels, -1, None), n_classes)

    uploads = {}

    def upload(ring, k, n):
        up = uploads.setdefault(id(ring), PinnedUpload(ring.device))
        return up(np.stack(list(ring.slots[k, :n].numpy())))

    monkeypatch.setattr(tplanner, "write_label_row", rule)
    monkeypatch.setattr(tplanner._SlotRing, "upload", upload)


@pytest.mark.parametrize("dtype,n_classes,n_dev,views_per_step,caps", [
    (np.int8, N_CLASSES, 1, 5, None),
    (np.int64, N_CLASSES, 1, 5, None),
    (np.int32, 200, 1, 5, None),
    (np.int8, N_CLASSES, 1, 2, None),
    (np.int16, N_CLASSES, 2, 4, None),
    (np.int8, N_CLASSES, 1, 4, (16, 16, 16, 16)),
], ids=["int8", "int64", "int32_rows", "short_last_step", "two_devices", "retried"])
def test_rows_written_by_the_workers_equal_the_old_upload(
        pinhole, monkeypatch, dtype, n_classes, n_dev, views_per_step, caps):
    """The workers' row writes give the bits of labels clipped, cast,
    stacked and staged as before: int8 images (ids below -1 clipped, ids
    past the classes kept), int64 and int16 ones narrowed (ids out of range
    to -1), int32 rows past 127 classes, a short last step, two devices,
    and a retry round whose views all overflow."""
    tmesh, tseg, *_ = pinhole
    labels = raw_labels(dtype, n_classes, len(tseg))
    kwargs = dict(class_image_provider=lambda i: labels[i],
                  device_mesh=["cpu"] * n_dev, views_per_step=views_per_step)
    if caps is not None:
        kwargs.update(auto_size_fold=False,
                      config=dataclasses.replace(tmesh.raster_config, caps=caps))
    fracs, views = tpipeline.aggregate_class_images_distributed(
        tmesh, tseg, n_classes, **kwargs)
    with monkeypatch.context() as m:
        as_uploaded_before(m)
        want_fracs, want_views = tpipeline.aggregate_class_images_distributed(
            tmesh, tseg, n_classes, **kwargs)
    assert views.max() > 0
    assert np.array_equal(fracs, want_fracs) and np.array_equal(views, want_views)
    row = np.empty((80, 80), tplanner.label_dtype(n_classes))
    minus_one = np.full_like(row, -1)
    for image in labels:  # the rows themselves, where negative ids count alike
        tplanner.write_label_row(row, image, n_classes, minus_one)
        assert np.array_equal(
            row, tplanner.as_label_dtype(np.clip(image, -1, None), n_classes))


def test_workers_wait_for_a_slots_last_copy(monkeypatch, caplog):
    """Stub copy events that complete only when a worker waits on one: no
    worker writes into a slot before the copy that last read it has
    completed; each ring holds ``LOOKAHEAD_STEPS + 2`` slots, at most
    ``LOOKAHEAD_STEPS`` of them taken and not yet uploaded; 16 one-view
    steps reuse every slot, and the result is the run's without stubs."""
    rings, early = [], []

    class StubEvent:
        done = False

        def synchronize(self):
            time.sleep(0.002)
            self.done = True

    class Ring(tplanner._SlotRing):
        def __init__(self, *args):
            super().__init__(*args)
            self.taken = self.most_taken = 0
            rings.append(self)

        def take(self):
            self.taken += 1
            self.most_taken = max(self.most_taken, self.taken)
            return super().take()

        def upload(self, k, n):
            self.taken -= 1
            self.read[k] = StubEvent()
            return super().upload(k, n)

    write = tplanner.write_label_row

    def checked(row, labels, n_classes, minus_one):
        for ring in rings:
            for k, read in enumerate(ring.read):
                if np.shares_memory(row, ring.slots[k].numpy()) and not (
                        read is None or read.done):
                    early.append(k)
        write(row, labels, n_classes, minus_one)

    n = 16
    verts, faces = make_grid_mesh(n=13, size=4.0)
    mesh = TexturedMesh((verts, faces), raster_config=tr.RasterConfig(),
                        device="cpu")
    c2ws = []
    for k in range(n):
        c2w = nadir_camera(4.0, 40.0, 80)
        c2w[:3, 3] += (0.05 * k + 0.0123, -0.0217, 0.0)
        c2ws.append(c2w)
    cams = CameraSet(c2ws, {0: {"f": 40.0, "image_width": 80, "image_height": 80}},
                     sensor_IDs=[0] * n)
    labels = raw_labels(np.int8, N_CLASSES, n)
    kwargs = dict(mesh=mesh, cameras=cams, n_classes=N_CLASSES,
                  class_image_provider=lambda i: labels[i], device_mesh=["cpu"],
                  views_per_step=1, prefetch_workers=4)
    want = tpipeline.aggregate_class_images_distributed(**kwargs)
    monkeypatch.setattr(tplanner, "_SlotRing", Ring)
    monkeypatch.setattr(tplanner, "write_label_row", checked)
    (fracs, views), stats, _ = run_logged(caplog, **kwargs)
    ring, = rings
    assert not early
    assert len(ring.read) == tplanner.LOOKAHEAD_STEPS + 2
    assert ring.most_taken == tplanner.LOOKAHEAD_STEPS
    assert stats["slot_wait_s"] > 0 and stats["direct_views"] == n
    assert np.array_equal(fracs, want[0]) and np.array_equal(views, want[1])


def test_undersized_caps_gated_then_equal(pinhole, caplog):
    """Caps every view overflows (JAX :163): each view adds nothing, is
    re-censused, re-sized and re-run, re-read through the provider, and
    the result equals the planned run."""
    tmesh, tseg, *_ = pinhole
    reads = []
    provider = tplanner.default_class_image_provider(tseg, 1.0)

    def counted(i):
        reads.append(i)
        return provider(i)

    ref = tpipeline.aggregate_class_images_distributed(
        tmesh, tseg, N_CLASSES, device_mesh=["cpu", "cpu"])
    small = dataclasses.replace(tmesh.raster_config, caps=(16, 16, 16, 16))
    (f, v), stats, warnings = run_logged(
        caplog, mesh=tmesh, cameras=tseg, n_classes=N_CLASSES,
        class_image_provider=counted, device_mesh=["cpu", "cpu"],
        auto_size_fold=False, config=small)
    assert any("re-censusing" in m for m in warnings)
    assert stats["retried_views"] == len(tseg) and stats["retry_rounds"] == 1
    assert sorted(reads) == sorted(list(range(len(tseg))) * 2)
    np.testing.assert_array_equal(v, ref[1])
    np.testing.assert_allclose(f, ref[0], rtol=1e-6, atol=1e-6)


def test_benign_first_hostile_later(caplog):
    """8 nadir views, then 4 obliques whose lists exceed caps the nadir
    views fit (JAX :194): only the 4 are re-run, and the result equals a
    run at caps that fit every view."""
    verts, faces = make_grid_mesh(n=13, size=4.0,
                                  z_fn=lambda x, y: 0.1 * np.sin(3 * x))
    mesh = TexturedMesh((verts, faces), raster_config=tr.RasterConfig(),
                        device="cpu")
    c2ws = []
    for k in range(8):
        c2w = nadir_camera(4.0, 40.0, 80)
        c2w[:3, 3] += (0.1 * k + 0.0123, -0.0217, 0.0)
        c2ws.append(c2w)
    c2ws += [oblique_camera(4.0, 55.0, 80, pitch_deg=42.0, azimuth_deg=90.0 * k)
             for k in range(4)]
    sensor = {"f": 40.0, "image_width": 80, "image_height": 80}
    cams = CameraSet(c2ws, {0: sensor, 1: dict(sensor, f=55.0)},
                     sensor_IDs=[0] * 8 + [1] * 4)
    labels = np.random.default_rng(7).integers(-1, N_CLASSES, (12, 80, 80))
    soa = mesh._tri_soa_device(cams)
    b = cams.get_camera_batch(device="cpu")
    cfg = tr.RasterConfig(caps=(8, 8, 8, 8))
    census = np.stack([tr.bin_triangles(
        tr.setup_from_soa(soa, b.world_to_cam[k], b.f[k], 80, 80), cfg, 80, 80,
        return_census=True).numpy() for k in range(12)])
    nadir = np.maximum(census[:8].max(axis=0), 1)
    assert (census[8:].max(axis=0) > nadir).any()
    between = tr.RasterConfig(caps=tuple(int(c) for c in nadir))
    kwargs = dict(mesh=mesh, cameras=cams, n_classes=N_CLASSES,
                  class_image_provider=lambda i: labels[i], device_mesh=["cpu"] * 2)
    (f, v), stats, warnings = run_logged(caplog, auto_size_fold=False,
                                         config=between, **kwargs)
    assert stats["retried_views"] == 4
    assert any("4 views exceeded" in m for m in warnings)
    fit = tr.RasterConfig(caps=tuple(int(c) for c in census.max(axis=0)))
    (f_fit, v_fit), stats_fit, _ = run_logged(caplog, auto_size_fold=False,
                                              config=fit, **kwargs)
    assert stats_fit["retried_views"] == 0
    np.testing.assert_array_equal(v, v_fit)
    np.testing.assert_allclose(f, f_fit, rtol=1e-6, atol=1e-6)


def test_overflow_that_persists_raises(pinhole, monkeypatch):
    tmesh, tseg, *_ = pinhole
    monkeypatch.setattr(tplanner, "MAX_RETRIES", 0)
    with pytest.raises(RuntimeError, match="overflow persisted"):
        tpipeline.aggregate_class_images_distributed(
            tmesh, tseg, N_CLASSES, device_mesh=["cpu"], auto_size_fold=False,
            config=dataclasses.replace(tmesh.raster_config, caps=(16, 16, 16, 16)))


# -- the distorted sensor and level S: tests/test_sharding.py:313 and
# __graft_entry__.py:131-160 ----------------------------------------------------


def distorted_scene(n_views=6):
    """The dryrun's scene: a 7 x 7 grid, views shifted along x through a
    Brown-Conrady sensor with a principal-point offset, seeded labels."""
    verts, faces = make_grid_mesh(n=7, size=4.0)
    c2ws = []
    for k in range(n_views):
        c2w = nadir_camera(4.0, 16.0, 32)
        c2w[0, 3] += 0.2 * k
        c2ws.append(c2w)
    sensor = {"f": 40.0, "cx": 0.5, "cy": -0.5, "image_width": 80,
              "image_height": 80,
              "distortion_params": {"k1": 0.02, "k2": -0.01, "p1": 1e-3}}
    rng = np.random.default_rng(0)
    labels = rng.integers(0, N_CLASSES, (n_views, 80, 80)).astype(np.int32)
    return verts, faces, c2ws, sensor, labels


@pytest.fixture(scope="module")
def distorted():
    verts, faces, c2ws, sensor, labels = distorted_scene()
    jcfg = jr.RasterConfig(caps=(128, 32, 16, 16), backend="pallas")
    jmesh = JaxTexturedMesh((verts, faces), raster_config=jcfg)
    jcams = JaxCameraSet(c2ws, {0: sensor})
    tmesh = interop.mesh_from_jax(jmesh, device="cpu")
    tcams = interop.cameras_from_jax(jcams)
    out = {}
    for name, cfg in (("tile", jcfg),
                      ("s", dataclasses.replace(jcfg, **S_CFG))):
        out[name] = jpipeline.aggregate_class_images_distributed(
            jmesh, jcams, n_classes=N_CLASSES, class_image_provider=lambda i: labels[i],
            device_mesh=jax_view_mesh(3), config=cfg, **JAX_FEWEST)
    swapped, share = swapped_faces(jmesh, jcams, tmesh, tcams, jcfg)
    return jmesh, tmesh, tcams, labels, out, swapped, share


def test_distorted_equals_jax_and_stream(distorted):
    jmesh, tmesh, tcams, labels, want, swapped, share = distorted
    port = tpipeline.aggregate_class_images_distributed(
        tmesh, tcams, N_CLASSES, class_image_provider=lambda i: labels[i],
        device_mesh=["cpu"] * 3)
    # the two float32 distortion polynomials round apart by ~1e-3 px
    assert share < 0.01
    assert_pipelines_agree(port, want["tile"], swapped)
    seg = interop.cameras_from_jax(JaxSegmentorCameraSet(
        JaxCameraSet(tcams.cam_to_world_transforms, tcams.sensors),
        ArraySegmentor(labels, N_CLASSES)))
    assert_equals_stream(port, stream_reference(tmesh, seg))


def test_level_s_against_jax_and_tiles(distorted):
    """Level S (the sub-tile raster, ``bin_block=8``) on the distorted
    sensor: against the port's own streaming S path exactly; against the
    JAX package's S pipeline and the port's tile pipeline as the JAX test
    of it holds them (exact 1/z ties may go to another face): the same
    fraction mass, the same view counts on nearly every face."""
    jmesh, tmesh, tcams, labels, want, _, _ = distorted
    s_cfg = interop.raster_config_from_jax(
        dataclasses.replace(jmesh.raster_config, **S_CFG))
    port = tpipeline.aggregate_class_images_distributed(
        tmesh, tcams, N_CLASSES, class_image_provider=lambda i: labels[i],
        device_mesh=["cpu"] * 3, config=s_cfg)
    tiles = tpipeline.aggregate_class_images_distributed(
        tmesh, tcams, N_CLASSES, class_image_provider=lambda i: labels[i],
        device_mesh=["cpu"] * 3)
    seg = interop.cameras_from_jax(JaxSegmentorCameraSet(
        JaxCameraSet(tcams.cam_to_world_transforms, tcams.sensors),
        ArraySegmentor(labels, N_CLASSES)))
    assert_equals_stream(port, stream_reference(tmesh, seg, config=s_cfg))
    for (f, v) in (want["s"], tiles):
        assert abs(port[0].sum() - f.sum()) <= 0.005 * f.sum() + 1
        assert (port[1] == v).mean() >= 0.99
    assert (port[1] > 0).mean() > 0.5


# -- view sharding: tests/test_sharding.py:27-60 ----------------------------------


def shard_scene():
    verts, faces = make_grid_mesh(n=15, size=4.0)
    labels = np.random.default_rng(1).integers(0, 4, len(faces)).astype(np.float32)
    w2cs = []
    for k in range(11):  # not a device multiple
        c2w = nadir_camera(4.0, 40.0, 80)
        c2w[0, 3] += 0.1 * (k - 5)
        c2w[2, 3] += 0.05 * k
        w2cs.append(np.linalg.inv(c2w))
    return gather_tri_verts(verts, faces), labels, np.stack(w2cs), np.full(11, 40.0)


def port_sharded(tri, labels, w2c, f, devices, cfg):
    mesh = tsharding.make_view_mesh(devices)
    w2c_s, f_s, valid_s = tsharding.shard_views_for_mesh(w2c, f, mesh)
    vsum, vcount = tsharding.sharded_render_aggregate(
        tri, labels[:, None], w2c_s, f_s, valid_s, image_w=80, image_h=80,
        n_faces=len(labels), config=cfg, mesh=mesh)
    assert vsum.device == mesh[0] and vcount.device == mesh[0]
    return vsum.numpy(), vcount.numpy()


def test_sharded_render_aggregate_matches_jax():
    """Three devices, 11 views: the render -> aggregate round trip gives
    back every seen face's label in both packages, view counts equal on
    all but the faces a knife-edge swap hides or shows; padding views add
    nothing; one device gives the same view counts and sums to f32
    rounding."""
    tri, labels, w2c, f = shard_scene()
    jcfg = jr.RasterConfig(caps=(256, 64, 32, 16))
    jmesh = jax_view_mesh(3)
    jw2c, jf, jvalid = jsharding.shard_views_for_mesh(w2c, f, jmesh)
    jsum, jcount = jsharding.sharded_render_aggregate(
        jax.numpy.asarray(tri, jax.numpy.float32), jax.numpy.asarray(labels)[:, None],
        jw2c, jf, jvalid, image_w=80, image_h=80, n_faces=len(labels),
        config=jcfg, mesh=jmesh)
    jsum, jcount = np.asarray(jsum), np.asarray(jcount)
    cfg = interop.raster_config_from_jax(jcfg)
    tsum, tcount = port_sharded(tri, labels, w2c, f, ["cpu"] * 3, cfg)
    assert tcount.max() <= 11 and (tcount > 0).mean() > 0.5
    assert (tcount == jcount).mean() >= 0.99
    for s, c in ((tsum, tcount), (jsum, jcount)):
        seen = c > 0
        np.testing.assert_allclose(s[seen, 0] / c[seen], labels[seen], rtol=1e-6)
    one_sum, one_count = port_sharded(tri, labels, w2c, f, ["cpu"], cfg)
    np.testing.assert_array_equal(one_count, tcount)
    np.testing.assert_allclose(one_sum, tsum, rtol=1e-6)


def test_shard_views_pads_and_masks():
    w2c = np.stack([np.eye(4)] * 5)
    w2c[:, 0, 3] = np.arange(5)
    w2c_s, f_s, valid_s = tsharding.shard_views_for_mesh(
        w2c, np.arange(5.0) + 1, ("cpu", "cpu", "cpu"))
    assert [len(x) for x in f_s] == [2, 2, 2] and tsharding.pad_views(5, 3) == 6
    assert torch.cat(valid_s).tolist() == [1, 1, 1, 1, 1, 0]
    assert torch.cat(f_s).tolist() == [1, 2, 3, 4, 5, 1]
    assert torch.equal(w2c_s[2][1], torch.eye(4))
    if not torch.cuda.is_available():  # the default never falls back to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tsharding.make_view_mesh()


# -- the port's dryrun: __graft_entry__.dryrun_multichip on CPU devices ---------


def test_dryrun_multichip_on_cpu_devices():
    """The dryrun's checks over 3 CPU devices: the sharded round trip on
    n + 3 views, the pipeline through the level-S configuration on a
    distorted sensor, and its chunked form (two camera clusters whose
    buffers cover the scene) equal to it wherever both saw faces."""
    n_dev = 3
    devices = ["cpu"] * n_dev
    verts, faces, c2ws, sensor, labels = distorted_scene(n_dev + 3)
    w2cs = [np.linalg.inv(c) for c in c2ws]
    mesh = tsharding.make_view_mesh(devices)
    w2c, f, valid = tsharding.shard_views_for_mesh(np.stack(w2cs),
                                                   np.full(len(w2cs), 16.0), mesh)
    vsum, vcount = tsharding.sharded_render_aggregate(
        gather_tri_verts(verts, faces),
        (np.arange(len(faces), dtype=np.float32) % 5.0)[:, None], w2c, f, valid,
        image_w=32, image_h=32, n_faces=len(faces),
        config=tr.RasterConfig(caps=(128, 32, 16, 16)), mesh=mesh)
    assert float(vcount.max()) > 0

    tmesh = TexturedMesh((verts, faces), device="cpu")
    cams = CameraSet(c2ws, {0: sensor})
    config = tr.RasterConfig(caps=(128, 32, 16, 16), **S_CFG)
    fracs, views = tpipeline.aggregate_class_images_distributed(
        tmesh, cams, n_classes=3, class_image_provider=lambda i: labels[i],
        device_mesh=devices, config=config)
    assert float(views.max()) > 0
    cfracs, cviews = tchunked.aggregate_class_images_chunked_distributed(
        tmesh, cams, n_classes=3, n_clusters=2, buffer_meters=3.0,
        class_image_provider=lambda i: labels[i], device_mesh=devices,
        config=config)
    assert float(cviews.max()) > 0
    both = (views > 0) & (cviews > 0)
    assert both.any()
    np.testing.assert_allclose(cviews[both], views[both], atol=1e-5)


# -- the two-slot upload, the launch guard, the image cache ---------------------


def test_pinned_upload_wraps_on_cpu():
    upload = PinnedUpload("cpu")
    a = np.arange(12, dtype=np.int8).reshape(3, 4)
    for _ in range(3):
        out = upload(a)
        assert out.device.type == "cpu" and np.array_equal(out.numpy(), a)
    assert upload.wait_s == 0.0 and upload._stage == [None, None]
    assert upload.stage_s > 0  # the wrap, timed as the staging copy


WRAPPERS = {
    "raster_tiles.py": "gg_raster_tiles",
    "subtile.py": "gg_s_raster",
    "face_counts.py": "gg_face_class_counts",
    "onehot.py": "gg_onehot_class",
    "face_sums.py": "gg_face_sums",
}


@pytest.mark.parametrize("source,entry", sorted(WRAPPERS.items()))
def test_kernel_launch_under_the_tensors_device(source, entry):
    """Each wrapper calls its C entry point inside ``torch.cuda.device``
    of its tensors (a launch on a second card runs there, on the stream
    it is given)."""
    text = (ROOT / "geograypher_tpu_torch/ops" / source).read_text()
    assert re.search(r"with torch\.cuda\.device\(\w+\.device\):\n\s+err = lib\."
                     + entry + r"\(", text), source


def test_launch_guard_leaves_the_plain_path(monkeypatch):
    """On CPU tensors the wrappers never enter the guard: with
    ``torch.cuda.device`` made to raise they still return their plain
    versions' results."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path entered torch.cuda.device")

    monkeypatch.setattr(torch.cuda, "device", refuse)
    verts, faces = make_grid_mesh(n=9, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x))
    tri = torch.as_tensor(gather_tri_verts(verts, faces), dtype=torch.float32)
    w2c = torch.as_tensor(np.linalg.inv(oblique_camera(4.0, 40.0, 64, pitch_deg=20.0)),
                          dtype=torch.float32)
    cfg = tr.RasterConfig(caps=(64, 32, 16, 16), bin_block=8, subtile=(8, 16))
    soa = tr.tri_to_soa(torch.cat([tri, tri[:-len(tri) % 8]]))
    setup = tr.setup_from_soa(soa, w2c, torch.tensor(40.0), 64, 48)
    binned, su = tr.bin_all(setup, cfg, 48, 64)
    cand, counts = tr.binned_face_lists(binned, cfg)
    s_init = subtile.s_raster(su, setup, cfg, 48, 64)
    p2f = raster_tiles.raster_tiles(setup.planes, setup.bbox, cand, counts, cfg, 48, 64,
                                    s_init=s_init)
    assert torch.equal(p2f, raster_tiles.raster_tiles_plain(
        setup.planes, cand, counts, cfg, 48, 64, s_init))
    cls = torch.as_tensor(np.random.default_rng(0).integers(0, 3, (48, 64)),
                          dtype=torch.int32)
    assert torch.equal(face_counts.face_class_counts(p2f, cls, soa.shape[1], 3),
                       face_counts.face_class_counts_plain(p2f, cls, soa.shape[1], 3))
    img = torch.eye(3)[cls.long()]
    assert torch.equal(onehot.onehot_to_class(img)[0], cls)
    values = img.reshape(-1, 3).contiguous()
    got = face_sums.face_sums(p2f.reshape(-1), values, soa.shape[1], shape=(48, 64))
    want = face_sums.face_sums_plain(p2f.reshape(-1), values, soa.shape[1], (48, 64))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[1].sum()) == int((p2f >= 0).sum()) * 3


def test_image_cache_under_concurrent_readers(tmp_path):
    """More worker threads than cores read a camera set's images through
    its small LRU cache at a short switch interval: every read returns
    its own image."""
    n = 12
    files = []
    for i in range(n):
        files.append(tmp_path / f"img_{i:02d}.npy")
        np.save(files[-1], np.full((4, 5), i, np.int16))
    cams = CameraSet([np.eye(4)] * n, image_filenames=files)
    cams.image_cache_size = 3
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in rng.integers(0, n, 200):
                if not (cams.get_image_by_index(int(i)) == i).all():
                    errors.append(f"view {i}")
        except Exception as exc:  # noqa: BLE001 - any failure fails the test
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert len(cams._image_cache) <= 3
