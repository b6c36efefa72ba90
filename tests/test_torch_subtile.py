"""The port's level-S sub-tile raster against the JAX package's on the
same inputs (CPU: the port runs its plain versions, JAX its Pallas kernels
in interpret mode).  The scene is the JAX level-S tests' fixture: a 41-grid
seen obliquely at 256x96, ``bin_block=8``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.ops import rasterize as jr
from geograypher_tpu.ops import subtile as js
from geograypher_tpu.utils.fixtures import gather_tri_verts, make_grid_mesh, oblique_camera
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.ops import subtile as ts
from geograypher_tpu_torch.ops.face_counts import face_class_counts_plain
from geograypher_tpu_torch.ops.raster_tiles import raster_tiles_plain
from geograypher_tpu_torch.utils.fixtures import brute_force_pix2face
from tests.test_subtile import CFG as JCFG
from tests.test_subtile import _setup, _sized_config
from tests.test_torch_rasterize import as_torch_setup, one_torch_thread  # noqa: F401

N_CLASSES = 5
TCFG = interop.raster_config_from_jax(JCFG)
TCFG_OFF = dataclasses.replace(TCFG, subtile=None)


@pytest.fixture(scope="module")
def scene():
    """(JAX setup, port setup, w, h): one setup, carried across exactly."""
    jsetup, w, h = _setup()
    return jsetup, as_torch_setup(jsetup), w, h


def swaps_or_knife_edges(got, want, planes, min_agree):
    """The level-S contract of tests/test_subtile.py: agreement at least
    ``min_agree``, and every disagreement a face<->face swap or a pixel
    whose edge value lies within 1e-2 of zero (knife edge)."""
    agree = got == want
    assert agree.mean() >= min_agree, f"agreement {agree.mean():.5f}"
    for y, x in zip(*np.nonzero(~agree)):
        fa, fb = int(got[y, x]), int(want[y, x])
        if fa >= 0 and fb >= 0:
            continue
        f = max(fa, fb)
        ev = min(planes[f, 3 * k] * (x + 0.5) + planes[f, 3 * k + 1] * (y + 0.5)
                 + planes[f, 3 * k + 2] for k in range(3))
        assert abs(ev) < 1e-2, (y, x, fa, fb, ev)


def jax_pairs(setup, w, h):
    """JAX bin_subtiles' (s_mask8, {(cy, cx, unit)}) decoded from its
    chunk layout (units per 32-slot quarter, qsub per quarter)."""
    pair, _, ntx0p = jr.l0_geometry(JCFG, h, w)
    tot, _ = js.subtile_counts_census(setup, JCFG, h, w, ntx0p, pair)
    sb = js.bin_subtiles(setup, JCFG, h, w, ntx0p, pair, cap_chunks=int(tot))
    assert int(sb.overflow) == 0
    ntx_s = ntx0p * (JCFG.tile_w // JCFG.subtile[1])
    upq = js.QUARTER // JCFG.s_block
    units, qsub = np.asarray(sb.units), np.asarray(sb.qsub)
    pairs = set()
    for q in range(int(sb.n_chunks) * 4):
        for u in units[q * upq:(q + 1) * upq]:
            if u >= 0:
                pairs.add((int(qsub[q]) // ntx_s, int(qsub[q]) % ntx_s, int(u)))
    return np.asarray(sb.s_mask8), pairs


def test_bin_subtiles_matches_jax(scene):
    jsetup, tsetup, w, h = scene
    want_mask, want_pairs = jax_pairs(jsetup, w, h)
    sb = ts.bin_subtiles(tsetup, TCFG, h, w)
    np.testing.assert_array_equal(sb.s_mask8.numpy(), want_mask)
    np.testing.assert_array_equal(ts.subtile_mask8(tsetup, TCFG).numpy(), want_mask)
    assert 0 < want_mask.sum() < want_mask.size
    _, nsx = ts.subtile_grid(TCFG, h, w)
    got_pairs = set()
    units = sb.units.numpy()
    for sub, start, count in zip(sb.sub_ids.tolist(), sb.sub_start.tolist(),
                                 sb.sub_count.tolist()):
        lst = units[start:start + count]
        assert count > 0 and (np.diff(lst) > 0).all()  # ascending, unique
        got_pairs.update((sub // nsx, sub % nsx, int(u)) for u in lst)
    assert got_pairs == want_pairs
    assert sb.units.shape[0] == len(want_pairs)
    assert (np.diff(sb.sub_ids.numpy()) > 0).all()
    census = ts.subtile_counts_census(tsetup, TCFG, h, w).tolist()
    assert census[0] == len(want_pairs) and census[1] == int(sb.sub_count.max())


@pytest.mark.parametrize("census", [False, True])
def test_excluded_tile_lists_match_jax(scene, census):
    jsetup, tsetup, w, h = scene
    mask = js.subtile_mask8(jsetup, JCFG)
    jb = jr.bin_triangles(jsetup, JCFG, h, w, exclude_blocks=mask,
                          return_census=census)
    binned, su = tr.bin_all(tsetup, TCFG, h, w)
    if census:
        got = tr.bin_triangles(tsetup, TCFG, h, w, return_census=True,
                               exclude_blocks=su.s_mask8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jb))
        full = tr.bin_triangles(tsetup, TCFG, h, w, return_census=True)
        assert int(got.sum()) < int(full.sum())  # level S took units away
        return
    for lvl in range(4):
        np.testing.assert_array_equal(binned.cand[lvl].numpy(), np.asarray(jb.cand[lvl]))
        np.testing.assert_array_equal(binned.counts[lvl].numpy(),
                                      np.asarray(jb.counts[lvl]))
    assert int(binned.overflow) == int(jb.overflow)


def test_s_raster_plain_matches_jax_kernel(scene):
    jsetup, tsetup, w, h = scene
    cfg = _sized_config(jsetup, w, h)
    pair, _, ntx0p = jr.l0_geometry(cfg, h, w)
    sb_j = js.bin_subtiles(jsetup, cfg, h, w, ntx0p, pair,
                           cap_chunks=cfg.s_cap_chunks)
    _, bid = js.s_raster_pallas(sb_j, jsetup.planes, cfg, h, w, ntx0p, pair)
    bid = np.asarray(bid)
    want = bid.reshape(bid.shape[0] * bid.shape[1], -1)[:h, :w]
    sb = ts.bin_subtiles(tsetup, TCFG, h, w)
    best_w, best_id = ts.s_raster(ts.subtile_units(tsetup, TCFG), tsetup, TCFG, h, w)
    assert best_w.dtype == torch.float32 and best_id.dtype == torch.int32
    got = best_id.numpy()
    assert (got >= 0).sum() > 1000
    np.testing.assert_array_equal(got < 0, np.isneginf(best_w.numpy()))
    planes = tsetup.planes.numpy().astype(np.float64)
    swaps_or_knife_edges(got, want, planes, 0.995)
    # only diverted faces win at level S
    diverted = np.repeat(sb.s_mask8.numpy(), TCFG.bin_block)
    assert diverted[got[got >= 0]].all()


def test_subtile_pix2face_matches_jax(scene):
    jsetup, tsetup, w, h = scene
    want, _ = jr.rasterize_setup(jsetup, _sized_config(jsetup, w, h), h, w)
    got, binned = tr.rasterize_setup(tsetup, TCFG, h, w)
    got, want = got.numpy(), np.asarray(want)
    planes = tsetup.planes.numpy().astype(np.float64)
    swaps_or_knife_edges(got, want, planes, 0.99)
    assert int(binned.overflow) == 0 and (got >= 0).mean() > 0.3
    # the port with level S on against the port with it off: coverage and
    # depth are bit-identical, so only exact cross-group 1/z ties differ
    off, _ = tr.rasterize_setup(tsetup, TCFG_OFF, h, w)
    off = off.numpy()
    assert (got == off).mean() >= 0.999
    bad = got != off
    assert (got[bad] >= 0).all() and (off[bad] >= 0).all()


def test_s_counts_equal_jax_rasterize_and_count(scene):
    """B6's function: the counts over the S-seeded pix2face, exactly."""
    jsetup, tsetup, w, h = scene
    cfg = _sized_config(jsetup, w, h)
    n_faces = jsetup.valid.shape[0]
    cls = np.random.default_rng(3).integers(-1, N_CLASSES, (h, w)).astype(np.int32)
    want, over = jr.rasterize_and_count(jsetup, jnp.asarray(cls), cfg, h, w,
                                        n_faces, N_CLASSES, return_overflow=True)
    assert int(over) == 0
    p2f_j, _ = jr.rasterize_setup(jsetup, cfg, h, w)
    got = face_class_counts_plain(torch.tensor(np.asarray(p2f_j)),
                                  torch.as_tensor(cls), n_faces, N_CLASSES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want).sum() > 1000
    # and the port's own rasterize_and_count is the counts of its pix2face
    p2f, _ = tr.rasterize_setup(tsetup, TCFG, h, w)
    np.testing.assert_array_equal(
        tr.rasterize_and_count(tsetup, torch.as_tensor(cls), TCFG, h, w,
                               n_faces, N_CLASSES).numpy(),
        face_class_counts_plain(p2f, torch.as_tensor(cls), n_faces, N_CLASSES).numpy(),
    )


def fused_inputs():
    verts, faces = make_grid_mesh(
        n=41, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y))
    tri = gather_tri_verts(verts, faces).astype(np.float32)
    pad = -len(tri) % TCFG.bin_block
    tri = np.concatenate([tri, np.broadcast_to(tri[:1].mean(1, keepdims=True),
                                               (pad, 3, 3))])
    c2w = oblique_camera(3.0, 90.0, 256, pitch_deg=32.0, azimuth_deg=135.0)
    return tr.tri_to_soa(torch.as_tensor(tri)), torch.as_tensor(
        np.linalg.inv(c2w), dtype=torch.float32)


@pytest.mark.parametrize("use_dist", [False, True])
def test_fused_counts_with_s_equal_plain_counts(use_dist):
    soa, w2c = fused_inputs()
    w, h, n_faces = 256, 96, soa.shape[1]
    dist = (torch.tensor([0.02, -0.01, 0, 0, 1e-3, 0, 0, 0]), torch.tensor(0.5),
            torch.tensor(-0.5))
    cls = torch.as_tensor(
        np.random.default_rng(4).integers(0, N_CLASSES, (h, w)).astype(np.int32))
    counts, over, ncand = tr.fused_view_class_counts(
        soa, w2c, torch.tensor(90.0), *dist, cls, w, h, TCFG, n_faces,
        N_CLASSES, use_dist)
    setup = tr.setup_from_soa(soa, w2c, torch.tensor(90.0), w, h, TCFG.znear,
                              distortion=dist if use_dist else None)
    p2f, binned = tr.rasterize_setup(setup, TCFG, h, w)
    sb = ts.bin_subtiles(setup, TCFG, h, w)
    np.testing.assert_array_equal(
        counts.numpy(),
        face_class_counts_plain(p2f, cls, n_faces, N_CLASSES).float().numpy())
    assert int(over) == 0 and counts.sum() > 1000
    assert int(ncand) == sum(int(c.sum()) for c in binned.counts) + sb.units.shape[0]
    assert sb.units.shape[0] > 0


def test_s_seeded_raster_matches_float64_oracle():
    """The S-seeded tile raster against the float64 brute force: the S
    winners carried in, the tile lists resolved on top of them."""
    verts, faces = make_grid_mesh(
        n=41, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y))
    c2w = oblique_camera(3.0, 90.0, 256, pitch_deg=32.0, azimuth_deg=135.0)
    c2w[:3, 3] += (0.0123, -0.0217, 0.031)  # off the pixel grid
    w2c = np.linalg.inv(c2w)
    tri = gather_tri_verts(verts, faces)
    tri_cam = (tri.reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]).reshape(tri.shape)
    pad = -len(tri_cam) % TCFG.bin_block
    tri32 = np.concatenate([tri_cam, np.broadcast_to(
        tri_cam[:1].mean(1, keepdims=True), (pad, 3, 3))]).astype(np.float32)
    w, h = 256, 96
    setup = tr.setup_triangles(torch.as_tensor(tri32), torch.tensor(90.0), w, h)
    binned, su = tr.bin_all(setup, TCFG, h, w)
    cand, counts = tr.binned_face_lists(binned, TCFG)
    planes = setup.planes.contiguous()
    s_init = ts.s_raster(su, setup, TCFG, h, w)
    got = raster_tiles_plain(planes, cand, counts, TCFG, h, w, s_init=s_init).numpy()
    want = brute_force_pix2face(tri_cam, 90.0, w, h)
    agree = got == want
    assert agree.mean() >= 0.99, agree.mean()
    assert ((got[~agree] >= 0) & (want[~agree] >= 0)).all()
    # S winners survive where no tile-list face covers the pixel
    s_won = s_init[1].numpy()
    assert ((s_won >= 0) & (got == s_won)).sum() > 1000


def test_s_carry_is_replaced_only_strictly():
    """A tile-list candidate with the S winner's exact 1/z does not
    replace it; a larger one does."""
    cfg = tr.RasterConfig(caps=(4, 4, 4, 4))
    h, w = 8, 128
    row = torch.tensor([0, 0, 1.0, 0, 0, 1.0, 0, 0, 1.0, 0, 0, 1.0])
    planes = torch.stack([row, row, row + torch.tensor([0.0] * 11 + [1.0])])
    lists = [torch.full((1, 4), -1, dtype=torch.int32) for _ in range(4)]
    counts = [torch.zeros(1, dtype=torch.int32) for _ in range(4)]
    lists[0][0, 0] = 0
    counts[0][0] = 1
    s_init = (torch.full((h, w), 1.0), torch.full((h, w), 1, dtype=torch.int32))
    assert (raster_tiles_plain(planes, lists, counts, cfg, h, w, s_init) == 1).all()
    lists[0][0, 0] = 2
    assert (raster_tiles_plain(planes, lists, counts, cfg, h, w, s_init) == 2).all()


def test_mesh_aggregation_with_s_matches_jax():
    """``aggregate_projected_images`` with level S on, port against the
    JAX mesh with level S on, on the geo-referenced grid survey."""
    from tests.test_mesh import local_camera_set, make_geo_mesh

    jmesh, _ = make_geo_mesh()
    jcams = local_camera_set(jmesh)
    jcfg = jr.RasterConfig(caps=(64, 16, 16, 16), backend="pallas", bin_block=8,
                           l0_window=(5, 2), subtile=(8, 16), s_window=(3, 2),
                           s_block=4)
    n = 100  # local_camera_set's sensor size
    imgs = [np.eye(4, dtype=np.float32)[
        np.random.default_rng(10 + i).integers(0, 4, (n, n))] for i in range(len(jcams))]
    jcams.get_image_by_index = lambda i, s=1.0: imgs[i]
    want = list(jmesh.project_images(jcams, config=jcfg))
    mesh = interop.mesh_from_jax(jmesh, device="cpu")
    cams = interop.cameras_from_jax(jcams)
    cams.get_image_by_index = lambda i, s=1.0: imgs[i]
    tcfg = interop.raster_config_from_jax(jcfg)
    got = list(mesh.project_images(cams, config=tcfg))
    assert len(got) == len(want) == len(jcams)
    for (_, c_t), (_, c_j) in zip(got, want):
        c_t, c_j = c_t.numpy(), np.asarray(c_j)
        assert abs(c_t.sum() - c_j.sum()) <= 0.005 * c_j.sum()
        assert (c_t == c_j).all(axis=1).mean() >= 0.99
        assert c_j.sum() > 1000
    assert mesh.check_raster_capacity(cams, config=tcfg) == 0
    avg, info = mesh.aggregate_projected_images(cams, config=tcfg)
    seen = info["projection_counts"] > 0
    np.testing.assert_allclose(avg[seen].sum(axis=1), 1.0, atol=1e-5)
    assert np.isnan(avg[~seen]).all() and seen.mean() > 0.5


def test_subtile_config_checks():
    with pytest.raises(ValueError, match="multiple of s_block"):
        tr.RasterConfig(bin_block=2, subtile=(8, 16), s_block=4)
    cfg = dataclasses.replace(JCFG, s_cap_chunks=64, s_pair_chunks=8, s_kb=8)
    got = interop.raster_config_from_jax(cfg)
    assert (got.subtile, got.s_window, got.s_block) == ((8, 16), (3, 2), 4)
    assert not hasattr(got, "s_cap_chunks")
