"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs CUDA and nvcc; skips elsewhere.  This file imports no JAX, so on a
machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from geograypher_tpu_torch.ops import face_counts, onehot, raster_tiles, subtile
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


@pytest.mark.parametrize("shape", [
    (7, 13, 50, 3),  # neither side a multiple of the 8 x 4 patch
    (1, 5, 4, 2),  # fewer pixels than one warp
    (33, 65, 100, 10),  # one pixel past a trip on both edges
    (4, 32, 10, 10),  # exactly one trip
    (130, 1, 20, 4),  # one column
    (5, 33, 10, 1),  # one class
], ids=lambda s: "x".join(map(str, s)))
def test_counts_kernel_ragged_sizes(cuda, shape):
    """Ragged right and bottom edges, and face and class ids out of range
    on both sides, against the plain version."""
    h, w, n_faces, n_classes = shape
    rng = np.random.default_rng(h * w)
    p2f = torch.as_tensor(rng.integers(-2, n_faces + 3, (h, w)).astype(np.int32),
                          device=cuda)
    cls = torch.as_tensor(rng.integers(-2, n_classes + 2, (h, w)).astype(np.int32),
                          device=cuda)
    p2f[-1, -1], cls[-1, -1] = n_faces - 1, n_classes - 1  # the last cell of all
    got = face_counts.face_class_counts(p2f, cls, n_faces, n_classes)
    want = face_counts.face_class_counts_plain(p2f, cls, n_faces, n_classes)
    assert torch.equal(got, want) and int(want[-1, -1]) > 0
    # coherent labels: every lane of a patch holds the same key
    same = face_counts.face_class_counts(
        torch.full_like(p2f, n_faces - 1), torch.zeros_like(cls), n_faces, n_classes)
    assert int(same[n_faces - 1, 0]) == h * w and int(same.sum()) == h * w
    background = face_counts.face_class_counts(
        torch.full_like(p2f, -1), cls, n_faces, n_classes)
    assert int(background.abs().sum()) == 0


def test_counts_kernel_wide_table(cuda):
    """A table of more than 2^31 entries takes the kernel's 64-bit keys."""
    n_faces, n_classes = 1 << 22, 513
    rng = np.random.default_rng(2)
    p2f = torch.as_tensor(
        np.repeat(rng.integers(0, n_faces, (60, 80)), 4, axis=1).astype(np.int32),
        device=cuda)
    p2f[:, :8] = n_faces - 1
    cls = torch.as_tensor(
        np.repeat(rng.integers(0, n_classes, (60, 40)), 8, axis=1).astype(np.int32),
        device=cuda)
    cls[:, :8] = n_classes - 1
    got = face_counts.face_class_counts(p2f, cls, n_faces, n_classes)
    key, want = torch.unique(p2f.long() * n_classes + cls.long(), return_counts=True)
    assert int(key.max()) == n_faces * n_classes - 1 > 2**31
    assert torch.equal(got.view(-1)[key].long(), want)
    assert int(got.sum(dtype=torch.int64)) == p2f.numel()


ONEHOT_SHAPES = [(5, 7, 2), (33, 31, 3), (1, 1, 10), (64, 64, 16), (30, 50, 32),
                 (9, 11, 100), (3, 5, 700)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", ONEHOT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_onehot_kernel_matches_plain(cuda, shape, dtype):
    """The one-hot scan kernel against its plain version and the labels it
    was made from: exact stacks, unlabeled rows, refused rows, a base
    pointer off the 16-byte grid, pixel counts off the warp's 32."""
    h, w, c = shape
    rng = np.random.default_rng(c)
    labels = rng.integers(0, c, (h, w))
    exact = np.eye(c, dtype=dtype)[labels]
    unlabeled = exact.copy()
    unlabeled[h // 2] = np.nan
    unlabeled[0, 0] = np.inf
    soft = exact.copy()
    soft[h - 1, w - 1, 0] = 0.5
    empty_row = exact.copy()
    empty_row[0, w // 2] = 0
    mixed = exact.copy()
    mixed[0, 0, 1] = np.nan
    for image, violations in ((exact, 0), (unlabeled, 0), (soft, 1),
                              (empty_row, 1), (mixed, 1)):
        img = torch.as_tensor(image).to(cuda)
        before = onehot.launches
        cls, found = onehot.onehot_to_class(img)
        torch.cuda.synchronize()
        assert onehot.launches == before + 1
        cls_plain, found_plain = onehot.onehot_to_class_plain(img)
        assert torch.equal(cls, cls_plain)
        assert int(found) == int(found_plain) == violations
    cls, _ = onehot.onehot_to_class(torch.as_tensor(exact).to(cuda))
    assert torch.equal(cls.cpu(), torch.as_tensor(labels.astype(np.int32)))
    flat = torch.as_tensor(np.concatenate([np.zeros(1, dtype), exact.reshape(-1)]))
    shifted = flat.to(cuda)[1:].reshape(h, w, c)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    cls, found = onehot.onehot_to_class(shifted)
    assert torch.equal(cls.cpu(), torch.as_tensor(labels.astype(np.int32)))
    assert int(found) == 0


def test_onehot_kernel_counts_every_violation(cuda):
    soft = torch.rand((40, 50, 6), device=cuda)
    cls, found = onehot.onehot_to_class(soft)
    assert int(found) == 40 * 50 and int((cls != -1).sum()) == 0
    with pytest.raises(ValueError, match="shared memory"):
        onehot.onehot_to_class(torch.zeros((2, 2, 2000), device=cuda))


def test_project_images_scans_on_the_card(cuda):
    """A one-hot view takes the fused path with one scan launch and no
    numpy scan; a soft view takes the means path; both equal the same
    mesh on the CPU."""
    from geograypher_tpu_torch.cameras.core import CameraSet
    from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh
    from geograypher_tpu_torch.utils.fixtures import nadir_camera

    verts, faces = make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.15 * np.sin(3 * x) * np.cos(2 * y))
    w, h, c = 96, 64, 5
    c2w = nadir_camera(4.0, 50.0, w)
    c2w[:3, 3] += (0.0123, -0.0217, 0.031)
    cams = CameraSet([c2w, oblique_camera(4.0, 55.0, w, pitch_deg=25.0)],
                     {0: {"f": 50.0, "image_width": w, "image_height": h}},
                     sensor_IDs=[0, 0])
    rng = np.random.default_rng(4)
    hard = np.eye(c, dtype=np.float64)[rng.integers(0, c, (2, h, w))]
    hard[1, :6] = np.nan
    soft = rng.random((2, h, w, c)).astype(np.float32)

    class Images:
        needs_image = False

        def __init__(self, images):
            self.images = images

        def segment_image(self, image, index=None, **kwargs):
            return self.images[index]

    cfg = tr.RasterConfig(caps=(256, 96, 48, 32))
    results = {}
    for device in ("cpu", "cuda"):
        mesh = TexturedMesh((verts, faces), raster_config=cfg, device=device)
        mesh._as_class_image = None  # project_images must not call it
        scans, counted = onehot.launches, face_counts.launches
        out = [[t.cpu() for t in view] for images in (hard, soft)
               for view in mesh.project_images(SegmentorCameraSet(cams, Images(images)))]
        if device == "cuda":
            assert onehot.launches - scans == 4
            assert face_counts.launches - counted == 2
        results[device] = out
    for on_cpu, on_card in zip(results["cpu"][:2], results["cuda"][:2]):
        assert torch.equal(on_cpu[0], on_card[0]) and torch.equal(on_cpu[1], on_card[1])
        assert float(on_card[0].sum()) > 1000
    for on_cpu, on_card in zip(results["cpu"][2:], results["cuda"][2:]):
        # float32 sums in the order the card's atomics land in
        torch.testing.assert_close(on_cpu[0], on_card[0], rtol=1e-5, atol=1e-5)
        assert torch.equal(on_cpu[1], on_card[1])


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
