"""The port's census-bucketed planner (``geograypher_tpu_torch/parallel/
planner.py``) against the JAX package's on ``tests/test_planner.py``'s
6-view nadir/oblique scene (CPU; JAX Pallas in interpret mode), the
planned route of ``TexturedMesh.aggregate_projected_images``, and two
listed faults: ``save_renders`` with an overflowing view, and
``get_image_by_index`` enlarging as cv2 does."""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.parallel import planner as jplanner
from geograypher_tpu.predictors.segmentors import ArraySegmentor
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.ops.face_counts import face_class_counts_plain
from geograypher_tpu_torch.ops.rasterize import rasterize_setup, setup_from_soa
from geograypher_tpu_torch.parallel import pipeline as tpipeline
from geograypher_tpu_torch.parallel import planner as tplanner
from geograypher_tpu_torch.utils.fixtures import (
    make_grid_mesh,
    nadir_camera,
    oblique_camera,
)
from tests.test_planner import BASE, H, N_CLASSES, N_VIEWS, W, scene  # noqa: F401
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

CFG = interop.raster_config_from_jax(BASE)


@pytest.fixture(scope="module")
def port_scene(scene):
    """The scene's triangles, parameters and labels as the port takes
    them, its plan (2 buckets), and each view's pix2face."""
    tri, f_pad, params, labels = scene
    tri = torch.tensor(np.asarray(tri))
    plan = tplanner.plan_aggregation(tri, params, CFG, H, W, f_pad, max_buckets=2)
    p2f = []
    for k in range(N_VIEWS):
        w2c, f, _, _ = tplanner.unpack_row(torch.as_tensor(params[k]), False)
        setup = setup_from_soa(tri, w2c, f, W, H)
        p2f.append(rasterize_setup(setup, plan.cover_config, H, W)[0])
    return tri, f_pad, params, labels, plan, p2f


def streaming_counts(p2f, labels, f_pad):
    """Per-view counts of the port's streaming chain (its raster's
    pix2face, the counts), in view order."""
    return [face_class_counts_plain(p, torch.as_tensor(lab, dtype=torch.int32),
                                    f_pad, N_CLASSES).numpy().astype(np.float32)
            for p, lab in zip(p2f, labels)]


@pytest.fixture(scope="module")
def port_pooled(port_scene):
    tri, f_pad, params, labels, plan, _ = port_scene
    return tplanner.aggregate_counts_planned(
        tri, params, labels, CFG, H, W, f_pad, N_CLASSES, group=3, plan=plan)[0]


@pytest.fixture(scope="module")
def port_weighted(port_scene):
    tri, f_pad, params, labels, plan, _ = port_scene
    return tplanner.aggregate_projected_planned(
        tri, params, labels, CFG, H, W, f_pad, N_CLASSES, group=3, plan=plan)[:2]


@pytest.fixture(scope="module")
def jax_pooled(scene):
    """JAX ``aggregate_counts_planned``: (counts, plan)."""
    tri, f_pad, params, labels = scene
    # one bucket, one view a group: the JAX planner's fewest compiles
    return jplanner.aggregate_counts_planned(
        tri, params, labels, BASE, H, W, f_pad, N_CLASSES, max_buckets=1,
        group=1)


@pytest.fixture(scope="module")
def jax_weighted(scene):
    """JAX ``aggregate_projected_planned``: (value_sum, view_count)."""
    tri, f_pad, params, labels = scene
    value_sum, view_count, _ = jplanner.aggregate_projected_planned(
        tri, params, labels, BASE, H, W, f_pad, N_CLASSES, max_buckets=1,
        group=1)
    return value_sum, view_count


def test_census_equals_jax(port_scene, scene):
    """Each view's exact per-level tile occupancy, the port's against the
    JAX census program's."""
    tri, _, params, _, _, _ = port_scene
    census = jplanner._build_census(jplanner.census_config_of(BASE), False, W, H)
    cfg = tplanner.census_config_of(CFG)
    for k in range(N_VIEWS):
        want = np.asarray(census(scene[0], params[k])[0])
        got = tplanner.census_view(tri, torch.as_tensor(params[k]), cfg, False,
                                    H, W)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.sum() > 0


@pytest.mark.parametrize("max_buckets", [1, 2, 4])
def test_buckets_equal_jax(port_scene, scene, max_buckets):
    """The port's buckets (caps and views) are the JAX planner's."""
    tri, f_pad, params, _, _, _ = port_scene
    want = jplanner.plan_aggregation(scene[0], params, BASE, H, W, f_pad,
                                     max_buckets=max_buckets)
    got = tplanner.plan_aggregation(tri, params, CFG, H, W, f_pad,
                                    max_buckets=max_buckets)
    assert [(b.config.caps, b.view_indices) for b in got.buckets] == [
        (b.config.caps, b.view_indices) for b in want.buckets]
    assert got.plan_seconds > 0 and not got.sampled
    assert got.cover_config.caps == want.cover_config.caps
    assert len(got.buckets) <= max_buckets


def face_swaps(got, want, max_share=1e-4):
    """The faces whose counts differ between the port's raster and the JAX
    package's.  Their float32 setups round apart at a few pixel centres on
    a shared edge (2 of the scene's 147,456 pixels), where each picks
    another face: the raster contract (``tests/test_pallas_raster.py``,
    face-to-face swaps only) allows that.  So every class's total is
    equal, and the counts that moved are a few."""
    np.testing.assert_array_equal(got.sum(axis=0), want.sum(axis=0))
    assert np.abs(got - want).sum() / 2 <= max_share * want.sum()
    return (got != want).any(axis=1)


def test_pooled_equals_jax_and_streaming(port_scene, port_pooled, jax_pooled):
    """Exactly the port's streaming counts, summed; the JAX planner's
    exactly but for the raster's knife-edge swaps."""
    _, f_pad, _, labels, _, p2f = port_scene
    want, _ = jax_pooled
    counts = port_pooled
    assert counts.shape == (f_pad, N_CLASSES) and counts.dtype == np.float32
    assert counts.sum() > 0
    np.testing.assert_array_equal(counts, sum(streaming_counts(p2f, labels, f_pad)))
    swapped = face_swaps(counts, want)
    np.testing.assert_array_equal(counts[~swapped], want[~swapped])
    assert swapped.sum() <= 8


def test_weighted_equals_jax(port_scene, port_pooled, port_weighted,
                             jax_pooled, jax_weighted):
    """``view_count`` exactly and ``value_sum`` to f32 rounding against
    the JAX planner on every face the rasters agree on (see
    :func:`face_swaps`), and against the streaming chain's means."""
    _, f_pad, _, labels, _, p2f = port_scene
    value_sum, view_count = port_weighted
    keep = ~face_swaps(port_pooled, jax_pooled[0])
    want_sum, want_count = jax_weighted
    np.testing.assert_array_equal(view_count, want_count)
    assert view_count.max() >= 2
    np.testing.assert_allclose(value_sum[keep], want_sum[keep], rtol=1e-6, atol=1e-7)
    # per view counts / total, summed in view order, as the stream sums
    mean_sum = np.zeros_like(value_sum)
    for one in streaming_counts(p2f, labels, f_pad):
        tot = one.sum(axis=1, keepdims=True)
        mean_sum += np.where(tot > 0, one / np.maximum(tot, 1), 0).astype(np.float32)
    np.testing.assert_allclose(value_sum, mean_sum, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(view_count, sum(
        (one.sum(axis=1) > 0).astype(np.float32)
        for one in streaming_counts(p2f, labels, f_pad)))


def forced_plan(plan, caps=(16, 16, 16, 16), views=None):
    """``plan`` with every view (or ``views``) in one bucket of ``caps``."""
    views = tuple(range(plan.n_views)) if views is None else tuple(views)
    return dataclasses.replace(plan, buckets=(tplanner.BucketPlan(
        config=dataclasses.replace(plan.buckets[0].config, caps=caps),
        view_indices=views),))


@pytest.mark.parametrize("weighted,how", [(False, "forced_caps"),
                                          (True, "forced_caps"),
                                          (False, "census_sample")])
def test_overflow_retry_ends_exact(port_scene, port_pooled, port_weighted,
                                   weighted, how):
    """A view whose caps overflow adds nothing, is re-censused and re-run:
    the result equals the run whose plan fit, with the retry counted (a
    weighted sum adds the re-run views last: f32 rounding)."""
    tri, f_pad, params, labels, plan, _ = port_scene
    if how == "forced_caps":
        plan = forced_plan(plan)
    else:
        # view 0 alone is censused (nadir); the obliques overflow its caps
        plan = tplanner.plan_aggregation(tri, params, CFG, H, W, f_pad,
                                         max_buckets=1, census_sample=1,
                                         sample_extra_margin=1.0)
        assert plan.sampled
    agg = tplanner.PlannedAggregator(plan, N_CLASSES, group=4, weighted=weighted)
    agg.prepare(tri, params, labels)
    agg.run()
    got = agg.finalize()
    assert agg.resizes >= 1
    if weighted:
        np.testing.assert_array_equal(got[1], port_weighted[1])
        np.testing.assert_allclose(got[0], port_weighted[0], rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, port_pooled)


def test_overflow_without_retries_raises(port_scene):
    tri, _, params, labels, plan, _ = port_scene
    agg = tplanner.PlannedAggregator(forced_plan(plan, caps=(4, 4, 4, 4), views=[1]),
                                     N_CLASSES, max_retries=0)
    agg.prepare(tri, params, labels)
    agg.run()
    with pytest.raises(RuntimeError, match=r"overflow persisted .* views \[1\]"):
        agg.finalize()


def test_inputs_label_index_group_and_plan_reuse(port_scene, port_pooled):
    """Views mapped onto shared label rows equal the expanded stack; the
    group size and a tensor stack change nothing; a plan serves other
    labels of the same cameras; class ids past int8 never wrap."""
    tri, f_pad, params, labels, plan, p2f = port_scene
    index = np.arange(N_VIEWS)[::-1] % 4
    shared, _ = tplanner.aggregate_counts_planned(
        tri, params, labels[:4], CFG, H, W, f_pad, N_CLASSES, group=3,
        plan=plan, label_index=index)
    np.testing.assert_array_equal(
        shared, sum(streaming_counts(p2f, labels[index], f_pad)))
    one, plan2 = tplanner.aggregate_counts_planned(
        tri, params, torch.as_tensor(labels), CFG, H, W, f_pad, N_CLASSES,
        group=1, plan=plan)
    assert plan2 is plan
    np.testing.assert_array_equal(one, port_pooled)
    wide = labels.astype(np.int32)
    wide[:, :4] = 256 + 1  # int8 would wrap it to class 1
    got, _ = tplanner.aggregate_counts_planned(
        tri, params, wide, CFG, H, W, f_pad, N_CLASSES, plan=plan)
    cut = labels.copy()
    cut[:, :4] = -1
    np.testing.assert_array_equal(got, sum(streaming_counts(p2f, cut, f_pad)))


# -- the mesh's planned route -------------------------------------------------


@pytest.fixture(scope="module")
def survey():
    """``tests/test_planner.py``'s mesh-level scene: the grid mesh and 4
    views (two nadir, two oblique) with seeded one-hot labels, a few
    pixels unlabelled."""
    verts, faces = make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y))
    c2ws = [nadir_camera(4.0, 100.0, W),
            oblique_camera(4.0, 130.0, W, pitch_deg=25.0, azimuth_deg=90.0),
            nadir_camera(4.0, 100.0, W),
            oblique_camera(4.0, 130.0, W, pitch_deg=25.0, azimuth_deg=270.0)]
    # off the pixel grid: a nadir camera centred on the grid mesh puts
    # pixel centres on shared edges, where float32 rounding picks the face
    c2ws[0][:3, 3] += (0.0123, -0.0217, 0.031)
    c2ws[2][:3, 3] += (0.3061, -0.1987, 0.0)
    sensors = {si: {"f": f, "cx": 0.0, "cy": 0.0, "image_width": W,
                    "image_height": H} for si, f in enumerate((100.0, 130.0))}
    labels = np.random.default_rng(0).integers(-1, N_CLASSES, (4, H, W))
    jmesh = JaxTexturedMesh((verts, faces), raster_config=BASE)
    jcams = JaxSegmentorCameraSet(
        JaxCameraSet(c2ws, sensors, sensor_IDs=[0, 1, 0, 1]),
        ArraySegmentor(labels, N_CLASSES))
    return jmesh, jcams, labels


@pytest.fixture(scope="module")
def jax_mesh_planned(survey):
    """The JAX mesh's ``aggregate_class_images_planned``: pooled counts."""
    jmesh, jcams, labels = survey
    return jmesh.aggregate_class_images_planned(
        jcams, N_CLASSES, class_image_provider=lambda i: labels[i],
        max_buckets=1, group=1)[0]


def test_mesh_planned_route(survey, jax_mesh_planned):
    """``use_planned=True`` on one-hot views equals the streaming path
    (view counts exactly, means to f32 rounding, NaN on the same faces);
    the mesh's pooled counts equal the streaming chain's summed and the
    JAX mesh's planned method's but for knife-edge swaps; the plan is
    cached."""
    jmesh, jcams, labels = survey
    mesh = interop.mesh_from_jax(jmesh, device="cpu")
    cams = interop.cameras_from_jax(jcams)
    avg, info = mesh.aggregate_projected_images(cams, use_planned=True)
    ref, ref_info = mesh.aggregate_projected_images(cams, use_planned=False)
    assert "plan" in info and "plan" not in ref_info
    np.testing.assert_array_equal(info["projection_counts"],
                                  ref_info["projection_counts"])
    np.testing.assert_array_equal(np.isnan(avg), np.isnan(ref))
    np.testing.assert_allclose(avg, ref, rtol=1e-6, atol=1e-7, equal_nan=True)
    seen = info["projection_counts"] > 0
    assert seen.mean() > 0.5 and info["projection_counts"].max() >= 2
    counts, plan = mesh.aggregate_class_images_planned(
        cams, N_CLASSES, class_image_provider=lambda i: labels[i])
    assert plan is info["plan"]  # the route's plan, from the mesh's cache
    per_view = sum(s for s, _ in mesh.project_images(cams, config=plan.cover_config))
    np.testing.assert_array_equal(counts, per_view.numpy())
    swapped = face_swaps(counts, jax_mesh_planned)
    np.testing.assert_array_equal(counts[~swapped], jax_mesh_planned[~swapped])


@pytest.mark.parametrize("retry", [False, True], ids=["planned", "retried"])
def test_planned_aggregator_equals_the_pipeline(survey, retry):
    """One plan and one label stack on one CPU device: the pipeline fed the
    rows through a provider finds the planned path's plan in the mesh's
    one cache, and ``PlannedAggregator`` weighted gives its bits, view
    counts and sums, also through a forced retry (caps every view
    overflows, one sub-plan a round); pooled, the retry changes no count
    and the faces seen are the pipeline's."""
    jmesh, jcams, labels = survey
    mesh = interop.mesh_from_jax(jmesh, device="cpu")
    cams = interop.cameras_from_jax(jcams)
    tri, params, rows, _, _, _, plan, config = mesh._planned_inputs(
        cams, N_CLASSES, None, 1.0, None, None, 4, None, labels)
    kwargs = dict(class_image_provider=lambda i: labels[i],
                  device_mesh=["cpu"], views_per_step=3)
    fitted = plan
    if retry:
        plan = forced_plan(plan, caps=(4, 4, 4, 4))
        kwargs.update(auto_size_fold=False, config=plan.buckets[0].config)
    fracs, views = tpipeline.aggregate_class_images_distributed(
        mesh, cams, N_CLASSES, **kwargs)
    assert list(mesh._plan_cache.values()) == [fitted]
    out, resizes = {}, {}
    for name, p, weighted in (("weighted", plan, True), ("pooled", plan, False),
                              ("fitted", fitted, False)):
        agg = tplanner.PlannedAggregator(p, N_CLASSES, group=3, weighted=weighted)
        agg.prepare(tri, params, rows)
        assert agg.run().shape == (p.n_faces, N_CLASSES)
        out[name], resizes[name] = agg.finalize(), agg.resizes
        agg.close()
    assert resizes == dict(weighted=int(retry), pooled=int(retry), fitted=0)
    value_sum, view_count = (a[: mesh.n_faces] for a in out["weighted"])
    assert view_count.max() >= 2
    np.testing.assert_array_equal(view_count, views)
    np.testing.assert_array_equal(value_sum, fracs)
    pooled = out["pooled"]
    np.testing.assert_array_equal(pooled, out["fitted"])
    np.testing.assert_array_equal(pooled[: mesh.n_faces].sum(axis=1) > 0, views > 0)


def test_mesh_planned_refuses_and_auto_streams(survey, monkeypatch):
    jmesh, jcams, labels = survey
    mesh = interop.mesh_from_jax(jmesh, device="cpu")
    cams = interop.cameras_from_jax(jcams)
    soft = JaxSegmentorCameraSet(jcams.base, ArraySegmentor(labels, N_CLASSES))
    soft.segmentor.segment_image = lambda image, index=None, **kw: np.full(
        (H, W, N_CLASSES), 1.0 / N_CLASSES)
    with pytest.raises(ValueError, match="not an exact one-hot"):
        mesh.aggregate_projected_images(interop.cameras_from_jax(soft),
                                        use_planned=True)
    with pytest.raises(ValueError, match="unsupported project_images kwargs"):
        mesh.aggregate_projected_images(cams, use_planned=True,
                                        check_null_image=True)

    def refuse(*args, **kwargs):
        raise AssertionError("a survey below the threshold took the planner")

    monkeypatch.setattr(mesh, "aggregate_projected_images_planned", refuse)
    assert len(cams) * H * W < mesh._PLANNED_MIN_PIXELS
    avg, info = mesh.aggregate_projected_images(cams)
    assert "plan" not in info and np.isfinite(avg).any()


# -- faults: C2 (save_renders) and C5 (enlarging) --------------------------------


def test_save_renders_writes_no_file_of_an_overflowed_view(survey, tmp_path):
    """A view whose tile lists overflow writes no file; the call raises
    after the last view and names it."""
    jmesh, jcams, _ = survey
    mesh = interop.mesh_from_jax(jmesh, device="cpu")
    mesh.set_texture(np.arange(mesh.n_faces) % 3, is_vertex=False)
    cams = interop.cameras_from_jax(jcams.base)
    cams.image_filenames = [tmp_path / f"v{k}.png" for k in range(len(cams))]
    # the views' L0 census at bin_block=8 is [6, 8, 6, 8]
    small = dataclasses.replace(CFG, caps=(7, 8, 8, 8))
    tight = [mesh.check_raster_capacity(cams, k, config=small)
             for k in range(len(cams))]
    assert [bool(t) for t in tight] == [False, True, False, True]
    with pytest.raises(RuntimeError, match=r"overflow in views \[1, 3\]"):
        mesh.save_renders(cams, output_folder=tmp_path / "out", config=small)
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == ["v0.png", "v2.png"]


@pytest.mark.parametrize("src,dst", [((20, 30), (40, 60)), ((20, 30), (47, 61)),
                                     ((20, 30), (10, 61)), ((20, 30), (45, 11)),
                                     ((5, 5), (13, 5))])
def test_resize_area_enlarges_as_cv2(src, dst):
    """Enlarging (on one axis or both) as cv2's INTER_AREA does: uint8 to
    +-1 (cv2 works in fixed point), float32 to 1e-4."""
    from geograypher_tpu_torch.utils.io import resize_area

    rng = np.random.default_rng(src[0] * dst[1])
    for img in (rng.integers(0, 256, src, dtype=np.uint8),
                rng.integers(0, 256, src + (3,), dtype=np.uint8)):
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
        got = resize_area(img, dst[1], dst[0])
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    img = rng.random(src + (4,)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(resize_area(img, dst[1], dst[0]), want,
                               atol=1e-4, rtol=0)


def test_get_image_by_index_enlarges_as_jax(tmp_path):
    from geograypher_tpu_torch.utils.io import write_image

    img = np.random.default_rng(1).integers(0, 256, (12, 17, 3), dtype=np.uint8)
    write_image(tmp_path / "a.png", img)
    c2w = [np.eye(4)]
    sensors = {0: {"f": 10.0, "image_width": 17, "image_height": 12}}
    jcams = JaxCameraSet(c2w, sensors, image_filenames=[tmp_path / "a.png"])
    cams = interop.cameras_from_jax(jcams)
    for scale in (2.0, 1.5):
        want = jcams.get_image_by_index(0, scale)
        got = cams.get_image_by_index(0, scale)
        assert got.shape == want.shape == (int(12 * scale), int(17 * scale), 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
