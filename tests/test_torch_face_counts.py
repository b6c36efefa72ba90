"""The PyTorch port's per-face class counts against the JAX package:
the counts kernel's plain version against the JAX scatter, and the
port's fused view chain against JAX's XLA and Pallas chains (CPU; Pallas
in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.ops import rasterize as jr
from geograypher_tpu.ops.aggregate import (
    project_image_class_counts as jax_class_counts,
)
from geograypher_tpu.utils.fixtures import gather_tri_verts, make_grid_mesh, oblique_camera
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.ops.aggregate import project_image_class_counts
from geograypher_tpu_torch.ops.face_counts import face_class_counts
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

N_CLASSES = 6
DIST8 = np.array([0.02, -0.01, 0.0, 0.0, 1e-3, 0.0, 0.0, 0.0], np.float32)
W, H = 160, 96


def test_counts_match_jax_scatter():
    rng = np.random.default_rng(3)
    n_faces = 300
    p2f = rng.integers(-1, n_faces, (H, W)).astype(np.int32)
    cls = rng.integers(-2, N_CLASSES + 2, (H, W)).astype(np.int32)
    ref = np.asarray(jax_class_counts(jnp.asarray(p2f), jnp.asarray(cls),
                                      n_faces=n_faces, n_classes=N_CLASSES))
    got = face_class_counts(torch.as_tensor(p2f), torch.as_tensor(cls),
                            n_faces, N_CLASSES)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        project_image_class_counts(torch.as_tensor(p2f), torch.as_tensor(cls),
                                   n_faces, N_CLASSES).numpy(),
        ref,
    )
    assert ref.sum() > 0


def scene(bin_block):
    verts, faces = make_grid_mesh(
        n=25, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y)
    )
    assert faces.shape[0] % bin_block == 0
    c2w = oblique_camera(3.0, 90.0, W, pitch_deg=28.0, azimuth_deg=60.0)
    soa = gather_tri_verts(verts, faces).astype(np.float32).reshape(-1, 9).T
    w2c = np.linalg.inv(c2w).astype(np.float32)
    rng = np.random.default_rng(5)
    cls = rng.integers(-1, N_CLASSES, (H, W)).astype(np.int32)
    return np.ascontiguousarray(soa), w2c, 90.0, cls


def run_jax(soa, w2c, f, cls, cfg, use_dist):
    return jr.fused_view_class_counts(
        jnp.asarray(soa), jnp.asarray(w2c), jnp.float32(f), jnp.asarray(DIST8),
        jnp.float32(1.5), jnp.float32(-2.0), jnp.asarray(cls), W, H, cfg,
        soa.shape[1], N_CLASSES, use_dist,
    )


def run_port(soa, w2c, f, cls, cfg, use_dist):
    return tr.fused_view_class_counts(
        torch.as_tensor(soa), torch.as_tensor(w2c), torch.tensor(f),
        torch.as_tensor(DIST8), torch.tensor(1.5), torch.tensor(-2.0),
        torch.as_tensor(cls), W, H, cfg, soa.shape[1], N_CLASSES, use_dist,
    )


def jax_pix2face(soa, w2c, f, cfg, use_dist):
    """JAX pix2face through the same jitted setup its fused chain uses."""

    def p2f(s, m, fl, d):
        setup = jr.setup_from_soa(
            s, m, fl, W, H, cfg.znear,
            distortion=(d, jnp.float32(1.5), jnp.float32(-2.0)) if use_dist else None,
        )
        return jr.rasterize_setup(setup, cfg, H, W)[0]

    return np.asarray(jax.jit(p2f)(
        jnp.asarray(soa), jnp.asarray(w2c), jnp.float32(f), jnp.asarray(DIST8)
    ))


@pytest.mark.parametrize("bin_block", [1, 8])
@pytest.mark.parametrize("use_dist", [False, True], ids=["pinhole", "distorted"])
def test_fused_counts_match_jax(bin_block, use_dist):
    soa, w2c, f, cls = scene(bin_block)
    # caps count binning units: bin_block faces each
    caps = (112, 80, 8, 8) if bin_block == 1 else (20, 40, 4, 4)
    xla = jr.RasterConfig(caps=caps, bin_block=bin_block)
    cfg = interop.raster_config_from_jax(xla)
    counts, over, ncand = run_port(soa, w2c, f, cls, cfg, use_dist)
    assert counts.dtype == torch.float32 and int(over) == 0 and int(ncand) > 0
    counts = counts.numpy()
    p2f = tr.rasterize_setup(
        tr.setup_from_soa(
            torch.as_tensor(soa), torch.as_tensor(w2c), torch.tensor(f), W, H,
            distortion=(torch.as_tensor(DIST8), torch.tensor(1.5),
                        torch.tensor(-2.0)) if use_dist else None,
        ), cfg, H, W,
    )[0].numpy()
    labelled = (cls >= 0) & (cls < N_CLASSES) & (p2f >= 0)
    assert counts.sum() == labelled.sum() > 0

    for backend in ("xla", "pallas"):
        jcfg = jr.RasterConfig(caps=caps, bin_block=bin_block, backend=backend)
        ref, jover, _ = run_jax(soa, w2c, f, cls, jcfg, use_dist)
        ref = np.asarray(ref)
        assert int(jover) == 0
        if backend == "xla" and not use_dist:
            np.testing.assert_array_equal(counts, ref)
            continue
        # knife-edge pixels may swap between two faces: each swapped
        # labelled pixel moves one count from one face to another
        swapped = ((jax_pix2face(soa, w2c, f, jcfg, use_dist) != p2f)
                   & (cls >= 0)).sum()
        assert np.abs(counts - ref).sum() <= 2 * swapped


def test_fused_overflow_matches_jax():
    soa, w2c, f, cls = scene(1)
    small = jr.RasterConfig(caps=(8, 4, 4, 4), backend="xla")
    _, jover, _ = run_jax(soa, w2c, f, cls, small, False)
    _, over, _ = run_port(soa, w2c, f, cls, interop.raster_config_from_jax(small), False)
    assert int(over) == int(jover) > 0


def test_face_class_counts_checks_inputs():
    p2f = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="pix2face"):
        face_class_counts(p2f.long(), p2f, 3, 2)
    with pytest.raises(ValueError, match="class_image"):
        face_class_counts(p2f, p2f[:, :4], 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        face_class_counts(p2f.T, p2f.T, 3, 2)
    with pytest.raises(ValueError, match="int32 flattened"):
        project_image_class_counts(p2f, p2f, 2**30, 4)


def test_tiled_counts_equal_jax_tile_class_counts():
    """B4's counterpart: the port's ``project_image_class_counts_tiled``
    exactly equal to the JAX one (Pallas ``tile_class_counts`` in
    interpret mode, then the face-block folds) on the same pix2face."""
    from geograypher_tpu.ops.agg_tiled import (
        project_image_class_counts_tiled as jax_tiled,
    )
    from geograypher_tpu_torch.ops.agg_tiled import project_image_class_counts_tiled

    soa, w2c, f, cls = scene(1)
    jcfg = jr.RasterConfig(caps=(112, 80, 8, 8), backend="pallas")
    setup = jr.setup_from_soa(jnp.asarray(soa), jnp.asarray(w2c), jnp.float32(f),
                              W, H, jcfg.znear)
    p2f, binned = jr.rasterize_setup(setup, jcfg, H, W)
    p2f_tiles, _ = jr.rasterize_setup(setup, jcfg, H, W, return_tiles=True)
    n_faces = soa.shape[1]
    want, jover = jax_tiled(p2f_tiles, jnp.asarray(cls), binned, jcfg, H, W,
                            n_faces, N_CLASSES)
    assert int(jover) == 0
    got, over = project_image_class_counts_tiled(
        torch.tensor(np.asarray(p2f)), torch.as_tensor(cls), None,
        interop.raster_config_from_jax(jcfg), H, W, n_faces, N_CLASSES)
    assert got.dtype == torch.float32 and int(over) == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want).sum() > 1000
