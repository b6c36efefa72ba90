"""Prediction metrics, indexing and profiling of the PyTorch port
(``utils/prediction_metrics.py``, ``utils/indexing.py``,
``utils/profiling.py``) against the JAX package on the CPU.

Vector-vector confusion matrices: the raster mode equal to the JAX
package's on axis-aligned squares (where the two polygon fills agree,
ROADMAP C4), the exact mode within 1e-9 relative on any polygons.
Raster-raster: equal at two resolutions either way round, with the class
list the JAX package builds (-1 and the nodata value included) or a
given one.  The comprehensive metrics equal, NaNs included; the indexing
helpers equal; the stage timer's report in the JAX format; the plots run
with this machine's matplotlib and raise naming it without.  The port's
spans: a small survey aggregation and a small ``save_renders`` under a
profiler export every span of the hot paths, nested on the main thread,
and open nothing without one."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from geograypher_tpu.utils import indexing as jindexing
from geograypher_tpu.utils import prediction_metrics as jm
from geograypher_tpu.utils import profiling as jprofiling
from geograypher_tpu.utils.raster import Raster as JaxRaster
from geograypher_tpu.utils.raster import write_geotiff as jax_write_geotiff
from geograypher_tpu.utils.vector import Polygon as JaxPolygon
from geograypher_tpu.utils.vector import VectorData as JaxVectorData
from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value
from geograypher_tpu_torch.parallel import pipeline
from geograypher_tpu_torch.utils import indexing, profiling
from geograypher_tpu_torch.utils.fixtures import make_grid_mesh, nadir_camera
from geograypher_tpu_torch.utils import prediction_metrics as tm
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

EXACT_RTOL = 1e-9


def _square(x0, y0, size):
    return JaxPolygon(np.array([[x0, y0], [x0 + size, y0], [x0 + size, y0 + size],
                                [x0, y0 + size]], float))


def _star(rng, cx, cy, r):
    ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
    radius = rng.uniform(0.6, 1.0, (9, 1)) * r
    return JaxPolygon(np.array([cx, cy]) + radius * np.stack([np.cos(ang), np.sin(ang)], 1))


def _layers(tmp_path, kind):
    """(predicted, true) GeoJSON files in UTM: axis-aligned squares on a
    metre grid, or seeded stars; a class only one layer has, a polygon
    without a class, overlaps between classes."""
    rng = np.random.default_rng(2)
    x0, y0 = 500000.0, 4000000.0
    if kind == "squares":
        pred = [_square(x0 + a, y0 + b, s) for a, b, s in
                ((0, 0, 10), (20, 0, 8), (5, 4, 10), (40, 40, 6))]
        true = [_square(x0 + a, y0 + b, s) for a, b, s in
                ((1, 1, 10), (20, 2, 8), (30, 30, 5), (0, 30, 12))]
    else:
        pred = [_star(rng, x0 + 10 * k, y0 + 7 * (k % 2), 8) for k in range(5)]
        true = [_star(rng, x0 + 10 * k + 2, y0 + 7 * (k % 3), 7) for k in range(5)]
    names = ["oak", "pine", "oak", None, "fir"]
    JaxVectorData(pred, {"species": names[:len(pred)]}, epsg=32611).to_file(
        tmp_path / "pred.geojson")
    JaxVectorData(true, {"species": ["oak", "pine", "cedar", "oak", "pine"][:len(true)]},
                  epsg=32611).to_file(tmp_path / "true.geojson")
    return tmp_path / "pred.geojson", tmp_path / "true.geojson"


@pytest.mark.parametrize("include_unlabeled", [True, False])
@pytest.mark.parametrize("class_names", [None, ["pine", "oak"]])
def test_vector_raster_mode_equals_jax_on_squares(tmp_path, include_unlabeled, class_names):
    pred, true = _layers(tmp_path, "squares")
    kw = dict(class_names=class_names, include_unlabeled=include_unlabeled, grid=256)
    want, want_names = jm.cf_from_vector_vector(pred, true, "species", **kw)
    got, names = tm.cf_from_vector_vector(pred, true, "species", **kw)
    assert names == want_names
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    # the dispatcher takes two vector files to the same matrix
    if class_names is None and include_unlabeled:
        cf, _ = tm.compute_confusion_matrix_from_geospatial(pred, true, "species", grid=256)
        np.testing.assert_array_equal(cf, want)


@pytest.mark.parametrize("kind", ["squares", "stars"])
@pytest.mark.parametrize("include_unlabeled", [True, False])
def test_vector_exact_mode_matches_jax(tmp_path, kind, include_unlabeled):
    pred, true = _layers(tmp_path, kind)
    want, want_names = jm.cf_from_vector_vector(pred, true, "species", mode="exact",
                                                include_unlabeled=include_unlabeled)
    got, names = tm.cf_from_vector_vector(pred, true, "species", mode="exact",
                                          include_unlabeled=include_unlabeled)
    assert names == want_names
    np.testing.assert_allclose(got, want, rtol=EXACT_RTOL, atol=0)
    assert np.trace(got) > 0


def _rasters(tmp_path, nodata_pred=255, nodata_true=255):
    """A class raster at 1 m and a perturbed copy at 0.5 m offset by a
    fraction of a pixel, with nodata rows and a margin outside the
    other."""
    rng = np.random.default_rng(7)
    truth = rng.integers(0, 4, (60, 80)).astype(np.uint8)
    truth[:5] = 255
    pred = np.repeat(np.repeat(truth, 2, 0), 2, 1)
    flip = rng.random(pred.shape) < 0.2
    pred[flip] = rng.integers(0, 5, flip.sum())
    pred[-7:] = 255
    jax_write_geotiff(tmp_path / "true.tif", JaxRaster(
        truth, (1.0, 0, 500000.0, 0, -1.0, 4000000.0), epsg=32611, nodata=nodata_true))
    jax_write_geotiff(tmp_path / "pred.tif", JaxRaster(
        pred[:, 6:], (0.5, 0, 500003.3, 0, -0.5, 4000000.2), epsg=32611,
        nodata=nodata_pred))
    return tmp_path / "pred.tif", tmp_path / "true.tif"


@pytest.mark.parametrize("class_names", [None, [0, 1, 2, 3], [3, 1, 1.0, "x", -1]])
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("nodata", [255, None])
def test_raster_confusion_equals_jax(tmp_path, class_names, swap, nodata):
    pred, true = _rasters(tmp_path, nodata, nodata)
    if swap:
        pred, true = true, pred
    want, want_names = jm.compute_confusion_matrix_from_geospatial(
        pred, true, "species", class_names=class_names)
    got, names = tm.compute_confusion_matrix_from_geospatial(
        pred, true, "species", class_names=class_names, device="cpu")
    assert list(names) == list(want_names)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and np.trace(got) > 0
    if class_names is None and nodata == 255:
        assert -1 in names and 255 in names


def test_raster_confusion_through_a_rotated_grid(tmp_path):
    """A transform that is not north-up takes ``Raster.sample``'s path."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 3, (30, 40)).astype(np.uint8)
    jax_write_geotiff(tmp_path / "a.tif", JaxRaster(
        data, (1.0, 0, 500000.0, 0, -1.0, 4000000.0), epsg=32611))
    jax_write_geotiff(tmp_path / "b.tif", JaxRaster(
        np.repeat(np.repeat(data, 2, 0), 2, 1), (0.5, 0, 500000.0, 0, -0.5, 4000000.0),
        epsg=32611))
    from geograypher_tpu_torch.utils import raster as traster

    rotated = traster.read_geotiff(tmp_path / "a.tif")
    rotated.transform = (1.0, 0.01, 500000.0, 0.01, -1.0, 4000000.0)
    fine = traster.read_geotiff(tmp_path / "b.tif")
    got = tm._fine_values(rotated, fine)
    cc, rr = np.meshgrid(np.arange(40) + 0.5, np.arange(30) + 0.5)
    xs, ys = rotated.pixel_to_world(cc.ravel(), rr.ravel())
    want = fine.sample(xs, ys).reshape(30, 40)
    np.testing.assert_array_equal(got, np.where(np.isnan(want), -1, want).astype(int))
    north_up = traster.read_geotiff(tmp_path / "a.tif")
    assert (tm._fine_values(north_up, fine) == data).all()


def test_raster_confusion_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    pred, true = _rasters(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.compute_confusion_matrix_from_geospatial(pred, true, "species")
    with pytest.raises(NotImplementedError):
        tm.compute_confusion_matrix_from_geospatial(pred, tmp_path / "x.geojson", "c")


@pytest.mark.parametrize("cf", [
    np.array([[5, 1, 0], [2, 7, 1], [0, 0, 0]]),
    np.zeros((2, 2)),
    np.array([[0, 3], [0, 4]]),
    np.random.default_rng(0).integers(0, 9, (6, 6)),
])
def test_comprehensive_metrics_equal_jax(cf):
    want = jm.compute_comprehensive_metrics(cf)
    got = tm.compute_comprehensive_metrics(cf)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("name", ["a.tif", "b.TIFF", "c.geojson", "d.gpkg", "e.shp",
                                  "f.json", "g.png"])
def test_check_if_raster_equals_jax(name):
    try:
        want = jm.check_if_raster(name)
    except ValueError:
        with pytest.raises(ValueError, match="Unknown geodata extension"):
            tm.check_if_raster(name)
        return
    assert tm.check_if_raster(name) == want


@pytest.mark.parametrize("use_labels_from", ["both", "pred", "gt"])
def test_compute_and_show_cf_equals_jax(use_labels_from, tmp_path):
    rng = np.random.default_rng(4)
    pred = rng.choice(["oak", "pine", "fir"], 50)
    gt = rng.choice(["oak", "pine", "cedar"], 50)
    want = jm.compute_and_show_cf(pred, gt, use_labels_from=use_labels_from)
    got = tm.compute_and_show_cf(pred, gt, use_labels_from=use_labels_from,
                                 savefile=tmp_path / "cf.png")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert (tmp_path / "cf.png").stat().st_size > 0


def test_plot_geodata_runs(tmp_path):
    pred, true = _rasters(tmp_path)
    vec, _ = _layers(tmp_path, "squares")
    for name, kw in ((pred, {}), (vec, dict(class_column="species")), (vec, {})):
        ax = tm.plot_geodata(name, **kw)
        assert len(ax.get_images()) == 1


def test_plots_name_matplotlib_when_it_is_missing(tmp_path, monkeypatch):
    pred, _ = _rasters(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tm.plot_geodata(pred)
    with pytest.raises(ImportError, match="matplotlib"):
        tm.compute_and_show_cf([1, 2], [1, 1], vis=True)
    # without a plot no matplotlib is needed
    assert tm.compute_and_show_cf([1, 2], [1, 1])[2] == 0.5


@pytest.mark.parametrize("texture", [
    np.array([3, 1, 1, 7, np.nan]),
    np.array([0.5, 1.0]),
    np.array(["b", "a", "b"]),
    np.array([[2, 2], [5, 0]]),
])
@pytest.mark.parametrize("kw", [{}, dict(background_ID=1),
                                dict(all_discrete_texture_values=[9, 4, 4])])
def test_determine_IDs_to_labels_equals_jax(texture, kw):
    assert indexing.determine_IDs_to_labels(texture, **kw) == (
        jindexing.determine_IDs_to_labels(texture, **kw))


@pytest.mark.parametrize("downsample", [1, 2])
def test_inverse_map_interpolation_equals_jax(downsample):
    i, j = np.mgrid[:12, :15].astype(float)
    ijmap = np.stack([i + 0.3 * np.sin(j / 3), j + 0.2 * np.cos(i / 4)])
    np.testing.assert_array_equal(
        indexing.inverse_map_interpolation(ijmap, downsample=downsample),
        jindexing.inverse_map_interpolation(ijmap, downsample=downsample))


def test_find_argmax_nonzero_value_is_the_ports_tensor_version():
    assert indexing.find_argmax_nonzero_value is find_argmax_nonzero_value
    a = np.array([[0.0, 2.0, 1.0], [0.0, 0.0, 0.0], [1.0, np.nan, 3.0], [4.0, 4.0, 1.0]])
    np.testing.assert_array_equal(
        indexing.find_argmax_nonzero_value(torch.as_tensor(a)).numpy(),
        jindexing.find_argmax_nonzero_value(a))


def test_stage_timer_reports_as_jax(tmp_path):
    timer = profiling._StageTimer()
    jax_timer = jprofiling._StageTimer()
    for t in (timer, jax_timer):
        for name in ("b", "a", "b"):
            with t(name):
                pass
        t.totals.update(a=0.5, b=2.0)
    assert timer.report() == jax_timer.report()
    assert timer.counts == {"a": 1, "b": 2}
    with timer("a", log=True):
        pass
    assert timer.counts["a"] == 2
    timer.reset()
    assert not timer.totals and not timer.counts
    assert isinstance(profiling.stage_timer, profiling._StageTimer)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace"):
        with profiling.annotate("a_named_region"):
            torch.ones(8).sum()
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "a_named_region" in text and "traceEvents" in text
    with profiling.device_trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()


# -- the port's spans -----------------------------------------------------------

# the spans each path opens on its main thread; ``pipeline.load`` and
# ``pipeline.slot_wait`` (only where a card's copy read the slot) run on the
# prefetch workers and the mask writer's ``io.encode`` / ``io.write`` on its
# pool's threads
AGG_SPANS = ("pipeline.prepare", "planner.plan", "pipeline.fetch_wait",
             "pipeline.upload", "pipeline.enqueue", "pipeline.sync")
RENDER_SPANS = ("render.view", "render.overflow_read", "render.download")
WRITER_WAIT = "render.writer_wait"
WRITER_SPANS = ("io.encode", "io.write")
N_VIEWS = 6


def small_survey(tmp_path):
    """A textured 288-face grid and 6 nadir 80 x 80 views, each named after
    an image under ``tmp_path``, with seeded class images: a fresh mesh, so
    the pipeline's plan cache misses."""
    verts, faces = make_grid_mesh(n=13, size=4.0,
                                  z_fn=lambda x, y: 0.1 * np.sin(3 * x))
    mesh = TexturedMesh((verts, faces), device="cpu")
    mesh.set_texture(np.arange(mesh.n_faces) % 3, is_vertex=False)
    c2ws = []
    for k in range(N_VIEWS):
        c2w = nadir_camera(4.0, 40.0, 80)
        c2w[:3, 3] += (0.1 * k + 0.0123, -0.0217, 0.0)
        c2ws.append(c2w)
    cams = CameraSet(c2ws, {0: {"f": 40.0, "image_width": 80, "image_height": 80}},
                     sensor_IDs=[0] * N_VIEWS)
    cams.image_filenames = [tmp_path / f"v{k}.png" for k in range(N_VIEWS)]
    labels = np.random.default_rng(7).integers(-1, 3, (N_VIEWS, 80, 80))
    return mesh, cams, labels


def aggregate_and_render(tmp_path):
    mesh, cams, labels = small_survey(tmp_path)
    out = pipeline.aggregate_class_images_distributed(
        mesh, cams, 3, class_image_provider=lambda i: labels[i], device_mesh=["cpu"])
    mesh.save_renders(cams, output_folder=tmp_path / "masks")
    return out


def spans_of(events) -> dict:
    """{name: [(tid, start, end)]} of a Chrome trace's annotations."""
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            start = float(e["ts"])
            spans.setdefault(e["name"], []).append(
                (e["tid"], start, start + float(e["dur"])))
    return spans


def inside(inner, outer) -> bool:
    """Every ``inner`` span lies in an ``outer`` span of its thread."""
    return all(any(t == to and s0 >= so and e0 <= eo for to, so, eo in outer)
               for t, s0, e0 in inner)


def test_spans_on_the_trace_nested_on_the_main_thread(tmp_path):
    with profiling.device_trace(tmp_path / "trace"):
        aggregate_and_render(tmp_path)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = spans_of(events)
    main_spans = AGG_SPANS + RENDER_SPANS + (WRITER_WAIT,)
    assert set(main_spans) <= set(spans), sorted(spans)
    main = {t for name in main_spans for t, _, _ in spans[name]}
    assert main == {threading.get_native_id()}
    for name in ("pipeline.fetch_wait", "pipeline.upload"):
        assert len(spans[name]) == 2, name  # a step of 4 views and one of 2
    assert len(spans["pipeline.enqueue"]) == N_VIEWS
    for name in RENDER_SPANS:
        assert len(spans[name]) == N_VIEWS, name
    # 6 masks never fill the writer's bound: the one wait is the last drain
    assert len(spans[WRITER_WAIT]) == 1
    assert spans[WRITER_WAIT][0][1] >= max(e for _, _, e in spans["render.download"])
    for name in WRITER_SPANS:  # the pool's threads are not recorded here
        assert not {t for t, _, _ in spans.get(name, [])} & main, name
    # the workers write the labels into the slots: no stack, no staging copy
    assert not {"pipeline.stack", "upload.stage", "upload.wait"} & set(spans)


def test_load_spans_on_the_prefetch_threads(tmp_path):
    """A profiler that records every thread shows ``pipeline.load`` on the
    workers' threads, one a view, and never on the main thread."""
    mesh, cams, labels = small_survey(tmp_path)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(experimental_config=config) as prof:
        pipeline.aggregate_class_images_distributed(
            mesh, cams, 3, class_image_provider=lambda i: labels[i],
            device_mesh=["cpu"], prefetch_workers=2)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = spans_of(json.loads((tmp_path / "trace.json").read_text())["traceEvents"])
    loads = {t for t, _, _ in spans["pipeline.load"]}
    assert len(spans["pipeline.load"]) == N_VIEWS
    assert threading.get_native_id() not in loads and 1 <= len(loads) <= 2


def test_writer_spans_on_the_pool_threads(tmp_path):
    """A profiler that records every thread shows ``io.encode`` and
    ``io.write`` on the mask writer's threads, one a mask, each inside no
    span of the main thread."""
    mesh, cams, _ = small_survey(tmp_path)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(experimental_config=config) as prof:
        mesh.save_renders(cams, output_folder=tmp_path / "masks")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = spans_of(json.loads((tmp_path / "trace.json").read_text())["traceEvents"])
    for name in WRITER_SPANS:
        writers = {t for t, _, _ in spans[name]}
        assert len(spans[name]) == N_VIEWS, name
        assert threading.get_native_id() not in writers, name
    assert len(list((tmp_path / "masks").iterdir())) == N_VIEWS


def test_no_span_opens_without_a_profiler(tmp_path, monkeypatch):
    """With no profiler recording, no span enters ``record_function``: the
    aggregation, the mask writer and a timer run with it raising."""
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not profiling.profiler_recording()
    fracs, views = aggregate_and_render(tmp_path)
    assert views.max() > 0 and len(list((tmp_path / "masks").iterdir())) == N_VIEWS
    timer = profiling._StageTimer()
    with timer("a"), profiling.annotate("b"):
        pass
    assert timer.counts == {"a": 1}
    with torch.profiler.profile():  # the gate opens under a profiler
        assert profiling.profiler_recording()
        with pytest.raises(AssertionError, match="entered"):
            with profiling.annotate("b"):
                pass
    assert not profiling.profiler_recording()


def test_stage_timer_threads_lose_no_update():
    """More threads than cores adding to one name, switching every few
    microseconds: every entry is counted."""
    timer = profiling._StageTimer()
    threads, per = 16, 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with timer("shared"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert timer.counts["shared"] == threads * per
    assert timer.seconds("shared") > 0 and timer.seconds("never") == 0.0
