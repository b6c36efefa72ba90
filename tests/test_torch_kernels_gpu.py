"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs CUDA and nvcc; skips elsewhere.  This file imports no JAX, so on a
machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from geograypher_tpu_torch.ops import face_counts, raster_tiles, subtile
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.utils.fixtures import (
    gather_tri_verts,
    knife_edge_triangles,
    make_grid_mesh,
    oblique_camera,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def view_setup(device):
    verts, faces = make_grid_mesh(
        n=41, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y)
    )
    c2w = oblique_camera(3.0, 180.0, 320, pitch_deg=32.0, azimuth_deg=135.0)
    tri = torch.as_tensor(gather_tri_verts(verts, faces), dtype=torch.float32)
    w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32)
    return tr.setup_from_soa(
        tr.tri_to_soa(tri).to(device), w2c.to(device),
        torch.tensor(180.0, device=device), 320, 200,
    )


def view(device, bin_block):
    setup = view_setup(device)
    cfg = tr.RasterConfig(caps=(4096 // bin_block, 512, 64, 64),
                          bin_block=bin_block)
    cand, counts = tr.binned_face_lists(tr.bin_triangles(setup, cfg, 200, 320), cfg)
    return setup.planes.contiguous(), setup.bbox, cand, counts, cfg


@pytest.mark.parametrize("bin_block", [1, 8])
def test_raster_kernel_matches_plain(cuda, bin_block):
    planes, bbox, cand, counts, cfg = view(cuda, bin_block)
    before = raster_tiles.launches
    got = raster_tiles.raster_tiles(planes, bbox, cand, counts, cfg, 200, 320)
    torch.cuda.synchronize()
    assert raster_tiles.launches == before + 1
    want = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, 200, 320)
    assert torch.equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


def test_counts_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    p2f = torch.as_tensor(rng.integers(-1, 5000, (200, 320)).astype(np.int32),
                          device=cuda)
    cls = torch.as_tensor(rng.integers(-1, 9, (200, 320)).astype(np.int32),
                          device=cuda)
    before = face_counts.launches
    got = face_counts.face_class_counts(p2f, cls, 5000, 8)
    torch.cuda.synchronize()
    assert face_counts.launches == before + 1
    assert torch.equal(got, face_counts.face_class_counts_plain(p2f, cls, 5000, 8))


def test_s_raster_and_carry_match_plain(cuda):
    """Level S: the sub-tile kernel and the S-seeded tile raster against
    their plain versions, bit for bit (the 41-grid has 3,200 faces, a
    multiple of bin_block=8)."""
    setup = view_setup(cuda)
    cfg = tr.RasterConfig(caps=(512, 64, 64, 64), bin_block=8, l0_window=(5, 2),
                          subtile=(8, 16))
    binned, su = tr.bin_all(setup, cfg, 200, 320)
    assert int(binned.overflow) == 0 and bool(su.s_unit.any())
    planes = setup.planes.contiguous()
    before = subtile.launches
    s_w, s_id = subtile.s_raster(su, setup, cfg, 200, 320)
    torch.cuda.synchronize()
    assert subtile.launches == before + 1
    sb = subtile.bin_subtiles(setup, cfg, 200, 320)
    s_w_p, s_id_p = subtile.s_raster_plain(sb, planes, cfg, 200, 320)
    assert torch.equal(s_id, s_id_p) and torch.equal(s_w, s_w_p)
    assert (s_id >= 0).any()
    cand, counts = tr.binned_face_lists(binned, cfg)
    got = raster_tiles.raster_tiles(planes, setup.bbox, cand, counts, cfg, 200,
                                    320, s_init=(s_w, s_id))
    want = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, 200, 320,
                                           s_init=(s_w, s_id))
    assert torch.equal(got, want)
    off = tr.RasterConfig(caps=(512, 64, 64, 64), bin_block=8, l0_window=(5, 2))
    p2f_off, _ = tr.rasterize_setup(setup, off, 200, 320)
    assert (got == p2f_off).float().mean().item() >= 0.999


def knife_edge_setup(device, w, h):
    tri = knife_edge_triangles(w, h, n_patches=4, patch_cells=30, n_small=2000,
                               n_slivers=500, n_long=20, max_sliver=600)
    return tr.setup_triangles(torch.as_tensor(tri, device=device),
                              torch.tensor(1.0, device=device), w, h)


@pytest.mark.parametrize("bin_block", [1, 8])
def test_knife_edge_kernels_match_plain(cuda, bin_block):
    """The knife-edge scene (vertices on and within 1e-4 px of pixel
    centres, axis-aligned edges, slivers, edges over 2^18 px): the tile
    raster at bin_block 1, and at bin_block 8 with level S on the sub-tile
    raster and the S-seeded tile raster, bit-equal to their plain
    versions."""
    w, h = 1280, 720
    setup = knife_edge_setup(cuda, w, h)
    cfg = tr.RasterConfig(bin_block=bin_block, l0_window=(5, 2) if bin_block > 1 else 2,
                          subtile=(8, 16) if bin_block > 1 else None)
    census = tr.bin_triangles(
        setup, cfg, h, w, return_census=True,
        exclude_blocks=None if cfg.subtile is None else subtile.subtile_mask8(setup, cfg))
    cfg = dataclasses.replace(cfg, caps=tuple(int(c) + 8 for c in census.tolist()))
    binned, su = tr.bin_all(setup, cfg, h, w)
    assert int(binned.overflow) == 0
    cand, counts = tr.binned_face_lists(binned, cfg)
    planes = setup.planes.contiguous()
    s_init = None
    if su is not None:
        s_init = subtile.s_raster(su, setup, cfg, h, w)
        want = subtile.s_raster_plain(subtile.bin_subtiles(setup, cfg, h, w), planes,
                                      cfg, h, w)
        torch.cuda.synchronize()
        assert torch.equal(s_init[1], want[1]) and torch.equal(s_init[0], want[0])
        assert (s_init[1] >= 0).any()
    got = raster_tiles.raster_tiles(planes, setup.bbox, cand, counts, cfg, h, w,
                                    s_init=s_init)
    want = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, h, w,
                                           s_init=s_init)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got >= 0).float().mean().item() > 0.05


def test_level_s_on_the_card_needs_no_sort(cuda, monkeypatch):
    """rasterize_setup with level S on the card neither sorts the
    (sub-tile, unit) pairs nor reads anything back to the host."""
    setup = view_setup(cuda)
    cfg = tr.RasterConfig(caps=(512, 64, 64, 64), bin_block=8, l0_window=(5, 2),
                          subtile=(8, 16))

    def refuse(*args, **kwargs):
        raise AssertionError("the card's level-S path sorted its pairs")

    monkeypatch.setattr(subtile, "bin_subtiles", refuse)
    monkeypatch.setattr(subtile, "subtile_csr", refuse)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p2f, binned = tr.rasterize_setup(setup, cfg, 200, 320)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    monkeypatch.undo()
    planes = setup.planes.contiguous()
    sb = subtile.bin_subtiles(setup, cfg, 200, 320)
    s_init = subtile.s_raster_plain(sb, planes, cfg, 200, 320)
    cand, counts = tr.binned_face_lists(binned, cfg)
    want = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, 200, 320,
                                           s_init=s_init)
    assert torch.equal(p2f, want) and int(binned.overflow) == 0
