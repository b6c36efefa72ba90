"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs CUDA and nvcc; skips elsewhere.  This file imports no JAX, so on a
machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from geograypher_tpu_torch.ops import face_counts, raster_tiles
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.utils.fixtures import (
    gather_tri_verts,
    make_grid_mesh,
    oblique_camera,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def view(device, bin_block):
    verts, faces = make_grid_mesh(
        n=41, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y)
    )
    c2w = oblique_camera(3.0, 180.0, 320, pitch_deg=32.0, azimuth_deg=135.0)
    tri = torch.as_tensor(gather_tri_verts(verts, faces), dtype=torch.float32)
    w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32)
    setup = tr.setup_from_soa(
        tr.tri_to_soa(tri).to(device), w2c.to(device),
        torch.tensor(180.0, device=device), 320, 200,
    )
    cfg = tr.RasterConfig(caps=(4096 // bin_block, 512, 64, 64),
                          bin_block=bin_block)
    cand, counts = tr.binned_face_lists(tr.bin_triangles(setup, cfg, 200, 320), cfg)
    return setup.planes.contiguous(), cand, counts, cfg


@pytest.mark.parametrize("bin_block", [1, 8])
def test_raster_kernel_matches_plain(cuda, bin_block):
    planes, cand, counts, cfg = view(cuda, bin_block)
    before = raster_tiles.launches
    got = raster_tiles.raster_tiles(planes, cand, counts, cfg, 200, 320)
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
