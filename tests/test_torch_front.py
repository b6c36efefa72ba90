"""The raster chain's front end (triangle setup and tile binning) against
the JAX package, and its wrappers' rules, on the CPU.

On CPU tensors ``setup_from_soa`` and ``bin_triangles`` run their plain
versions (``ops/tri_setup.py``, ``ops/binning.py``) and launch nothing;
on the card they launch ``csrc/triangle_setup.cu`` and
``csrc/tile_binning.cu`` (held bit-equal to the plain versions in
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``).  The wrappers'
input checks for the card are reached here through their launch paths
(``_launch``), which raise before anything is built."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.ops import rasterize as jr
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.ops import binning, tri_setup
from geograypher_tpu_torch.ops import rasterize as tr
from tests.test_torch_rasterize import (  # noqa: F401
    DIST8,
    EDGE_F,
    EDGE_H,
    EDGE_W,
    as_torch_setup,
    edge_scene,
    oblique_scene,
    one_torch_thread,
)

def scene(name):
    """(tri, w2c, f, w, h) of a named scene."""
    if name == "oblique":
        return oblique_scene()
    return edge_scene(), np.eye(4, dtype=np.float32), EDGE_F, EDGE_W, EDGE_H


def setups(name, distorted):
    """(JAX setup, port setup) of a scene; the JAX side op by op (jit
    would contract the lens polynomial into FMAs)."""
    tri, w2c, f, w, h = scene(name)
    dist = (jnp.asarray(DIST8), jnp.float32(1.5), jnp.float32(-2.0))
    with jax.disable_jit():
        js = jr.setup_from_soa(jr.tri_to_soa(jnp.asarray(tri)), jnp.asarray(w2c),
                               jnp.float32(f), w, h,
                               distortion=dist if distorted else None)
    ts = tr.setup_from_soa(
        tr.tri_to_soa(torch.as_tensor(tri)), torch.as_tensor(w2c), torch.tensor(f),
        w, h, distortion=(torch.as_tensor(DIST8), torch.tensor(1.5),
                          torch.tensor(-2.0)) if distorted else None)
    return js, ts, w, h


@pytest.mark.parametrize("distorted", [False, True])
def test_edge_scene_setup_matches_jax(distorted):
    """Near-plane straddlers, degenerate, off-screen and behind-camera
    faces are invalid in both packages; faces past 2^30 px keep their
    clamped boxes; every valid face's planes and box agree."""
    js, ts, _, _ = setups("edge", distorted)
    valid = np.asarray(js.valid)
    np.testing.assert_array_equal(ts.valid.numpy(), valid)
    k = 400 // 8
    assert not valid[:k].any() and not valid[k:2 * k].any()
    assert not valid[2 * k:3 * k].any() and not valid[4 * k:5 * k].any()
    assert valid[6 * k:].mean() > 0.5
    if not distorted:  # off the lens' domain, these faces are invalid
        # a vertex at x = 4.5e9 px: the box is clamped to the image
        past = valid[3 * k:4 * k]
        assert past.any() and (ts.bbox.numpy()[3, 3 * k:4 * k][past] == EDGE_W - 1).all()
    np.testing.assert_allclose(ts.planes.numpy()[valid], np.asarray(js.planes)[valid],
                               rtol=1e-5)
    np.testing.assert_array_equal(ts.planes.numpy()[~valid],
                                  np.asarray(js.planes)[~valid])
    np.testing.assert_array_equal(ts.bbox.numpy()[:, valid], np.asarray(js.bbox)[:, valid])


@pytest.mark.parametrize("name", ["oblique", "edge"])
@pytest.mark.parametrize("bin_block,l0_window,global_from", [
    (1, 2, None), (1, (5, 2), None), (8, 2, None), (8, (5, 2), None),
    (8, (5, 2), 200), (1, 3, 201),
])
@pytest.mark.parametrize("census", [False, True])
def test_bin_triangles_matches_jax(name, bin_block, l0_window, global_from, census):
    """The tile lists, counts and overflow (tight caps: overflow > 0 on the
    edge scene), or the census, equal the JAX package's on the same
    setup."""
    js, _, w, h = setups(name, False)
    jcfg = jr.RasterConfig(caps=(24, 16, 8, 12), bin_block=bin_block,
                           l0_window=l0_window, global_from=global_from)
    tcfg = interop.raster_config_from_jax(jcfg)
    jb = jr.bin_triangles(js, jcfg, h, w, return_census=census)
    tb = tr.bin_triangles(as_torch_setup(js), tcfg, h, w, return_census=census)
    if census:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        return
    for lvl in range(4):
        np.testing.assert_array_equal(tb.cand[lvl].numpy(), np.asarray(jb.cand[lvl]))
        np.testing.assert_array_equal(tb.counts[lvl].numpy(), np.asarray(jb.counts[lvl]))
    assert int(tb.overflow) == int(jb.overflow)
    if name == "edge" and bin_block == 1:
        assert int(tb.overflow) > 0


@pytest.mark.parametrize("census", [False, True])
def test_excluded_blocks_match_jax(census):
    """``exclude_blocks`` drops its blocks from the lists and the census
    in both packages."""
    js, _, w, h = setups("oblique", False)
    mask = np.random.default_rng(5).random(js.valid.shape[0] // 8) < 0.4
    jcfg = jr.RasterConfig(caps=(96, 32, 16, 24), bin_block=8, l0_window=(5, 2))
    tcfg = interop.raster_config_from_jax(jcfg)
    jb = jr.bin_triangles(js, jcfg, h, w, exclude_blocks=jnp.asarray(mask),
                          return_census=census)
    tb = tr.bin_triangles(as_torch_setup(js), tcfg, h, w, return_census=census,
                          exclude_blocks=torch.as_tensor(mask))
    if census:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        return
    for lvl in range(4):
        np.testing.assert_array_equal(tb.cand[lvl].numpy(), np.asarray(jb.cand[lvl]))
    assert int(tb.overflow) == int(jb.overflow)


@pytest.mark.parametrize("distorted", [False, True])
@pytest.mark.parametrize("bin_block", [1, 8])
def test_wrappers_on_cpu_run_the_plain_versions(distorted, bin_block):
    """On CPU tensors the wrappers return the plain versions' results and
    launch no kernel; the lists at ``bin_block`` 8 expand as before."""
    tri, w2c, f, w, h = scene("edge")
    soa = tr.tri_to_soa(torch.as_tensor(tri))
    dist = ((torch.as_tensor(DIST8), torch.tensor(1.5), torch.tensor(-2.0))
            if distorted else None)
    before = (tri_setup.launches, binning.launches)
    got = tr.setup_from_soa(soa, torch.as_tensor(w2c), torch.tensor(f), w, h,
                            distortion=dist)
    want = tri_setup.setup_from_soa_plain(soa, torch.as_tensor(w2c), torch.tensor(f),
                                          w, h, distortion=dist)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cfg = tr.RasterConfig(caps=(24, 16, 8, 12), bin_block=bin_block)
    binned = tr.bin_triangles(got, cfg, h, w)
    plain = binning.bin_triangles_plain(got, cfg, h, w)
    assert binned.face_cand is None
    for a, b in zip(binned.cand + binned.counts, plain.cand + plain.counts):
        assert torch.equal(a, b)
    assert torch.equal(tr.bin_triangles(got, cfg, h, w, return_census=True),
                       binning.bin_triangles_plain(got, cfg, h, w, return_census=True))
    cand, counts = tr.binned_face_lists(binned, cfg)
    assert cand[0].shape[1] == cfg.caps[0] * bin_block
    assert torch.equal(counts[0], plain.counts[0] * bin_block)
    assert (tri_setup.launches, binning.launches) == before


def test_binned_face_lists_take_the_kernels_face_lists():
    """A BinnedTriangles that carries face lists (as the binning kernel
    writes them) hands those to the raster, unexpanded."""
    js, ts, w, h = setups("oblique", False)
    cfg = tr.RasterConfig(caps=(96, 32, 16, 24))
    binned = tr.bin_triangles(ts, cfg, h, w)
    marked = tuple(c + 0 for c in binned.cand)
    got, _ = tr.binned_face_lists(binned._replace(face_cand=marked,
                                                  face_counts=binned.counts), cfg)
    assert all(a is b for a, b in zip(got, marked))


def _rows(n=64, dtype=torch.float32):
    return torch.zeros((9, n), dtype=dtype)


@pytest.mark.parametrize("case", [
    "float64_rows", "noncontiguous_rows", "rows_shape", "float64_w2c", "w2c_shape",
    "float64_f", "f_shape", "f_not_a_number", "dist_on_host_lists", "float64_dist",
])
def test_setup_launch_path_refuses(case):
    """What the setup kernel does not take raises before any build: float64
    or non-contiguous rows, a wrong camera, an ``f`` that is neither a
    number nor a float32 one-element tensor beside the rows, lens terms
    that are not float32 tensors there."""
    rows, w2c, f, dist = _rows(), torch.eye(4), torch.tensor(2.0), None
    if case == "float64_rows":
        rows = _rows(dtype=torch.float64)
    elif case == "noncontiguous_rows":
        rows = torch.zeros((64, 9)).T
    elif case == "rows_shape":
        rows = torch.zeros((3, 64))
    elif case == "float64_w2c":
        w2c = torch.eye(4, dtype=torch.float64)
    elif case == "w2c_shape":
        w2c = torch.eye(3)
    elif case == "float64_f":
        f = torch.tensor(2.0, dtype=torch.float64)
    elif case == "f_shape":
        f = torch.ones(2)
    elif case == "f_not_a_number":
        f = np.float32(2.0).tobytes()
    elif case == "dist_on_host_lists":
        dist = ([0.0] * 8, torch.tensor(0.0), torch.tensor(0.0))
    elif case == "float64_dist":
        dist = (torch.zeros(8, dtype=torch.float64), torch.tensor(0.0),
                torch.tensor(0.0))
    before = tri_setup.launches
    with pytest.raises(ValueError):
        tri_setup._launch(rows, w2c, f, 32, 32, 1e-6, dist)
    assert tri_setup.launches == before


@pytest.mark.parametrize("case", ["ragged_blocks", "bbox_dtype", "bbox_noncontiguous",
                                  "valid_dtype", "exclude_shape"])
def test_binning_launch_path_refuses(case):
    """What the binning kernels do not take raises before any build:
    ``F % bin_block != 0``, a box that is not contiguous int32 (4, F), a
    validity that is not bool, an exclusion mask of the wrong length."""
    n = 64
    setup = tr.TriangleSetup(planes=torch.zeros((n, 12)),
                             bbox=torch.zeros((4, n), dtype=torch.int32),
                             valid=torch.ones(n, dtype=torch.bool))
    cfg, exclude = tr.RasterConfig(bin_block=8), None
    if case == "ragged_blocks":
        cfg = tr.RasterConfig(bin_block=24)
    elif case == "bbox_dtype":
        setup = setup._replace(bbox=setup.bbox.long())
    elif case == "bbox_noncontiguous":
        setup = setup._replace(bbox=torch.zeros((n, 4), dtype=torch.int32).T)
    elif case == "valid_dtype":
        setup = setup._replace(valid=setup.valid.to(torch.uint8))
    elif case == "exclude_shape":
        exclude = torch.zeros(n, dtype=torch.bool)
    before = binning.launches
    with pytest.raises(ValueError):
        binning._launch(setup, cfg, 32, 256, False, exclude)
    assert binning.launches == before


def test_plain_binning_refuses_ragged_blocks():
    """The plain version raises on ``F % bin_block != 0`` as the kernel's
    launch path does."""
    setup = tr.TriangleSetup(planes=torch.zeros((60, 12)),
                             bbox=torch.zeros((4, 60), dtype=torch.int32),
                             valid=torch.ones(60, dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple of bin_block"):
        tr.bin_triangles(setup, tr.RasterConfig(bin_block=8), 32, 256)


def test_other_devices_never_take_the_plain_versions():
    """A tensor that is neither on the CPU nor on a CUDA device raises in
    both wrappers: only a CPU tensor runs a plain version."""
    rows = torch.empty((9, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tr.setup_from_soa(rows, torch.eye(4, device="meta"), 2.0, 32, 32)
    setup = tr.TriangleSetup(planes=torch.empty((16, 12), device="meta"),
                             bbox=torch.empty((4, 16), dtype=torch.int32, device="meta"),
                             valid=torch.empty(16, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tr.bin_triangles(setup, tr.RasterConfig(), 32, 256)


def test_host_scalar_f_matches_a_tensor_f_on_the_cpu():
    """``f`` as a Python number and as a tensor give one setup on the CPU
    (the kernel takes both; on the card a host f divides the lens bound
    by a multiply with its float32 reciprocal, as PyTorch does)."""
    tri, w2c, f, w, h = scene("oblique")
    soa = tr.tri_to_soa(torch.as_tensor(tri))
    a = tr.setup_from_soa(soa, torch.as_tensor(w2c), float(f), w, h)
    b = tr.setup_from_soa(soa, torch.as_tensor(w2c), torch.tensor(f), w, h)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
