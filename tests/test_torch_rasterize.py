"""The PyTorch port's triangle setup, binning and raster against the JAX
package on the same inputs (CPU: the port runs its plain versions, JAX
its XLA path and its Pallas kernel in interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.ops import rasterize as jr
from geograypher_tpu.utils.fixtures import (
    gather_tri_verts,
    make_grid_mesh,
    nadir_camera,
    oblique_camera,
)
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.ops.raster_tiles import raster_tiles_plain

DIST8 = np.array([0.02, -0.01, 0.0, 0.0, 1e-3, 0.0, 0.0, 0.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tests run small tensors through many short ops: one
    intra-op thread each, so that parallel test workers do not
    oversubscribe the cores (other files import this fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def knife_edge(a, b, min_agree=0.99):
    """The raster contract of tests/test_pallas_raster.py: >= 99% of
    pixels agree and every disagreement is a face<->face swap."""
    agree = a == b
    assert agree.mean() >= min_agree, f"agreement {agree.mean():.4f}"
    bad = ~agree
    assert (a[bad] >= 0).all() and (b[bad] >= 0).all()


def oblique_scene():
    verts, faces = make_grid_mesh(
        n=25, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y)
    )
    c2w = oblique_camera(3.0, 90.0, 160, pitch_deg=32.0, azimuth_deg=135.0)
    tri = gather_tri_verts(verts, faces).astype(np.float32)
    return tri, np.linalg.inv(c2w).astype(np.float32), 90.0, 160, 96


EDGE_W, EDGE_H, EDGE_F = 160, 96, 90.0


def edge_scene(seed=3, n=400):
    """(F, 3, 3) float32 camera-frame faces, most in front of a camera at
    the origin, with eighths that straddle the near plane, repeat a vertex
    (degenerate), lie off screen, have a vertex 1e-6 past ``znear`` (its
    projection past 2^30 px), lie behind the camera, and have a vertex a
    million times off axis (past the lens' injective domain)."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.6, 0.6, n),
                  rng.uniform(1, 4, n)], 1)
    tri = c[:, None, :] + rng.normal(0, 0.15, (n, 3, 3))
    k = n // 8
    tri[:k, 0, 2] = -0.5
    tri[k:2 * k, 2] = tri[k:2 * k, 1]
    tri[2 * k:3 * k, :, 0] += 50.0
    tri[3 * k:4 * k, 0, 2] = 2e-6
    tri[3 * k:4 * k, 0, 0] = 100.0
    tri[4 * k:5 * k, :, 2] = -2.0
    tri[5 * k:6 * k, 1, :2] *= 1e6
    return tri.astype(np.float32)


def both_setups(tri, w2c, f, w, h, distorted):
    """(JAX setup, port setup) of one view.  The JAX side runs op by op:
    under jit XLA fuses the distortion polynomial and contracts its
    multiply-adds into FMAs, a rounding the port's eager ops never make."""
    dist = (jnp.asarray(DIST8), jnp.float32(1.5), jnp.float32(-2.0))
    with jax.disable_jit():
        js = jr.setup_from_soa(
            jr.tri_to_soa(jnp.asarray(tri)), jnp.asarray(w2c), jnp.float32(f),
            w, h, distortion=dist if distorted else None,
        )
    ts = tr.setup_from_soa(
        tr.tri_to_soa(torch.as_tensor(tri)), torch.as_tensor(w2c),
        torch.tensor(f), w, h,
        distortion=(torch.as_tensor(DIST8), torch.tensor(1.5), torch.tensor(-2.0))
        if distorted else None,
    )
    return js, ts


def screen_xy(tri, w2c, f, w, h, distorted):
    """float64 screen coordinates (F, 3) of the setup's vertices."""
    cam = tri.astype(np.float64) @ w2c[:3, :3].T.astype(np.float64) + w2c[:3, 3]
    xn, yn = cam[..., 0] / cam[..., 2], cam[..., 1] / cam[..., 2]
    if not distorted:
        return xn * f + w / 2.0, yn * f + h / 2.0
    k1, k2, k3, k4, p1, p2, b1, b2 = DIST8.astype(np.float64)
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = xn * radial + (p1 * (r2 + 2 * xn * xn) + 2 * p2 * xn * yn)
    yd = yn * radial + (p2 * (r2 + 2 * yn * yn) + 2 * p1 * xn * yn)
    return w / 2.0 + 1.5 + xd * (f + b1) + yd * b2, h / 2.0 - 2.0 + yd * f


def as_torch_setup(js):
    return tr.TriangleSetup(
        planes=torch.tensor(np.asarray(js.planes)),
        bbox=torch.tensor(np.asarray(js.bbox)),
        valid=torch.tensor(np.asarray(js.valid)),
    )


@pytest.mark.parametrize("distorted,scene", [
    pytest.param(False, "oblique", id="False"), pytest.param(True, "oblique", id="True"),
    pytest.param(False, "edge", id="edge-False"), pytest.param(True, "edge", id="edge-True"),
])
def test_setup_from_soa_matches_jax(distorted, scene):
    if scene == "oblique":
        tri, w2c, f, w, h = oblique_scene()
    else:  # near-plane straddlers, degenerate, off-screen, past 2^30 px
        tri, w2c, f = edge_scene(), np.eye(4, dtype=np.float32), EDGE_F
        w, h = EDGE_W, EDGE_H
    js, ts = both_setups(tri, w2c, f, w, h, distorted)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert ts.valid.any() and not ts.valid.all()
    np.testing.assert_allclose(
        ts.planes.numpy(), np.asarray(js.planes), rtol=1e-5
    )
    # a bbox edge within 1e-3 px of a pixel centre may round either way
    # between XLA and torch float32: only such faces may differ, by one
    # pixel, and they must stay at most 0.1% of the faces
    jb, tb = np.asarray(js.bbox), ts.bbox.numpy()
    differ = (jb != tb).any(axis=0)
    sx, sy = screen_xy(tri, w2c, f, w, h, distorted)
    edges = np.stack([sy.min(1), sx.min(1), sy.max(1), sx.max(1)]) - 0.5
    near = (np.abs(edges - np.round(edges)) < 1e-3).any(axis=0)
    assert not (differ & ~near).any()
    assert np.abs(jb.astype(np.int64) - tb).max() <= 1
    assert differ.sum() <= 1e-3 * differ.size, f"{differ.sum()} bboxes differ"


@pytest.mark.parametrize(
    "bin_block,global_from,l0_window",
    [(1, None, 2), (8, None, (5, 2)), (8, 600, 2), (1, None, (5, 2)), (1, 601, 3)],
)
def test_bin_triangles_matches_jax(bin_block, global_from, l0_window):
    tri, w2c, f, w, h = oblique_scene()
    js, _ = both_setups(tri, w2c, f, w, h, False)
    jcfg = jr.RasterConfig(caps=(96, 32, 16, 24), bin_block=bin_block,
                           global_from=global_from, l0_window=l0_window)
    tcfg = interop.raster_config_from_jax(jcfg)
    jb = jr.bin_triangles(js, jcfg, h, w)
    tb = tr.bin_triangles(as_torch_setup(js), tcfg, h, w)
    for lvl in range(4):
        np.testing.assert_array_equal(tb.cand[lvl].numpy(), np.asarray(jb.cand[lvl]))
        np.testing.assert_array_equal(tb.counts[lvl].numpy(),
                                      np.asarray(jb.counts[lvl]))
    assert int(tb.overflow) == int(jb.overflow)
    np.testing.assert_array_equal(
        tr.bin_triangles(as_torch_setup(js), tcfg, h, w, return_census=True).numpy(),
        np.asarray(jr.bin_triangles(js, jcfg, h, w, return_census=True)),
    )
    if global_from is not None:
        assert int(tb.counts[3][0]) > 0 and int(tb.overflow) > 0
    np.testing.assert_array_equal(
        tr.concat_candidates_for_tiles(tb, tcfg, h, w).numpy(),
        np.asarray(jr.concat_candidates_for_tiles(jb, jcfg, h, w)),
    )


def bumpy_grid():
    verts, faces = make_grid_mesh(
        n=15, size=4.0, z_fn=lambda x, y: 0.25 * np.sin(2 * x) * np.cos(y)
    )
    w2c = np.linalg.inv(nadir_camera(4.0, 50.0, 80))
    return verts, faces, w2c, 50.0, 80, 80, (256, 64, 32, 32)


def mixed_sizes():
    rng = np.random.default_rng(11)
    n = 50
    centers = np.concatenate(
        [rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(2, 6, (n, 1))], axis=1
    )
    sizes = rng.choice([0.02, 0.15, 1.0], n)[:, None]
    offs = rng.uniform(-1, 1, (n, 3, 2))
    tris = np.zeros((n, 3, 3))
    tris[:, :, :2] = centers[:, None, :2] + offs * sizes[:, None]
    tris[:, :, 2] = centers[:, None, 2]
    verts = tris.reshape(-1, 3)
    faces = np.arange(3 * n).reshape(n, 3)
    return verts, faces, np.eye(4), 60.0, 256, 64, (256, 64, 32, 32)


def occlusion_multichunk():
    v_lo, f_lo = make_grid_mesh(n=17, size=1.2)
    v_hi, f_hi = make_grid_mesh(n=3, size=0.5, offset=(0.0, 0.0, 1.0))
    verts = np.concatenate([v_lo, v_hi], axis=0)
    faces = np.concatenate([f_lo, f_hi + v_lo.shape[0]], axis=0)
    w2c = np.linalg.inv(nadir_camera(4.0, 100.0, 200))
    return verts, faces, w2c, 100.0, 200, 200, (768, 64, 32, 16)


@pytest.mark.parametrize(
    "scene", [bumpy_grid, mixed_sizes, occlusion_multichunk],
    ids=["bumpy_grid", "mixed_sizes", "occlusion_multichunk"],
)
def test_rasterize_triangles_matches_jax(scene):
    verts, faces, w2c, f, w, h, caps = scene()
    tri = gather_tri_verts(verts, faces)
    tri_cam = np.asarray(
        jr.transform_to_camera(jnp.asarray(tri, jnp.float32),
                               jnp.asarray(w2c, jnp.float32))
    )
    port = tr.rasterize_triangles(
        torch.tensor(tri_cam), torch.tensor(f), w, h, tr.RasterConfig(caps=caps)
    ).numpy()
    for backend in ("xla", "pallas"):
        ref = np.asarray(jr.rasterize_triangles(
            jnp.asarray(tri_cam), jnp.float32(f), image_w=w, image_h=h,
            config=jr.RasterConfig(caps=caps, backend=backend),
        ))
        knife_edge(port, ref)
    assert (port >= 0).any()
    if scene is occlusion_multichunk:
        assert port[100, 100] >= 512  # the raised plane wins depth


def test_transform_to_camera_matches_jax():
    verts, faces, w2c, *_ = bumpy_grid()
    tri = gather_tri_verts(verts, faces).astype(np.float32)
    np.testing.assert_allclose(
        tr.transform_to_camera(torch.as_tensor(tri),
                               torch.as_tensor(w2c, dtype=torch.float32)).numpy(),
        np.asarray(jr.transform_to_camera(jnp.asarray(tri),
                                          jnp.asarray(w2c, jnp.float32))),
        rtol=1e-6, atol=1e-6,
    )


def test_raster_tie_rules():
    """Coplanar duplicates: inside the merged L2 + global group the lower
    face id wins even when it sits in the global list; across groups an
    equal 1/z never replaces the earlier group's winner."""
    cfg = tr.RasterConfig(caps=(4, 4, 4, 4))
    h, w = 8, 128
    # three identical full-screen planes: every pixel covered, w = 1
    row = torch.tensor([0, 0, 1.0, 0, 0, 1.0, 0, 0, 1.0, 0, 0, 1.0])
    planes = row.repeat(6, 1)
    empty = torch.full((1, 4), -1, dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)

    def run(c0, c1, c2, c3):
        lists = [torch.tensor([c], dtype=torch.int32) if c else empty
                 for c in (c0, c1, c2, c3)]
        lists = [torch.nn.functional.pad(x, (0, 4 - x.shape[1]), value=-1)
                 for x in lists]
        counts = [torch.tensor([len(c)], dtype=torch.int32) if c else zero
                  for c in (c0, c1, c2, c3)]
        return raster_tiles_plain(planes, lists, counts, cfg, h, w)

    assert (run([], [], [4, 5], [2]) == 2).all()  # merged group: lowest id
    assert (run([], [3], [1], [0]) == 3).all()  # earlier group keeps ties
    assert (run([5], [], [], []) == 5).all()
    assert (run([], [], [], []) == -1).all()


def test_subtile_config_refused():
    """A level-S config is carried across (the TPU's S capacities are
    dropped); one whose bin_block is not a multiple of s_block is refused."""
    cfg = dataclasses.replace(jr.RasterConfig(), bin_block=8, subtile=(8, 16),
                              s_window=(2, 3), s_block=2, s_cap_chunks=16)
    got = interop.raster_config_from_jax(cfg)
    assert (got.subtile, got.s_window, got.s_block) == ((8, 16), (2, 3), 2)
    with pytest.raises(ValueError, match="multiple of s_block"):
        interop.raster_config_from_jax(dataclasses.replace(cfg, bin_block=1))


def test_raster_tiles_checks_inputs():
    tri, w2c, f, w, h = oblique_scene()
    _, ts = both_setups(tri, w2c, f, w, h, False)
    cfg = tr.RasterConfig(caps=(96, 32, 16, 24))
    cand, counts = tr.binned_face_lists(tr.bin_triangles(ts, cfg, h, w), cfg)
    from geograypher_tpu_torch.ops.raster_tiles import raster_tiles

    with pytest.raises(ValueError, match="planes"):
        raster_tiles(ts.planes.double(), ts.bbox, cand, counts, cfg, h, w)
    with pytest.raises(ValueError, match="bbox"):
        raster_tiles(ts.planes, ts.bbox[:, :-1], cand, counts, cfg, h, w)
    with pytest.raises(ValueError, match="cand"):
        raster_tiles(ts.planes, ts.bbox, (cand[0].long(),) + cand[1:], counts,
                     cfg, h, w)
    with pytest.raises(ValueError, match="counts"):
        raster_tiles(ts.planes, ts.bbox, cand, counts[:3] + (counts[3][:0],),
                     cfg, h, w)
