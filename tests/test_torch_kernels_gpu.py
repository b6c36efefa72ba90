"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs CUDA and nvcc; skips elsewhere.  This file imports no JAX, so on a
machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from geograypher_tpu_torch.ops import (
    binning,
    face_counts,
    face_sums,
    onehot,
    raster_tiles,
    subtile,
    tri_setup,
)
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.utils.fixtures import (
    crowded_tile_triangles,
    gather_tri_verts,
    knife_edge_triangles,
    make_grid_mesh,
    nadir_camera,
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



@pytest.mark.parametrize("n_local", [97, 300])
def test_counts_kernel_at_the_detection_shape(cuda, n_local):
    """The sparse detection counts' shape: a view's own detections as the
    classes (a few hundred), most pixels unlabelled (-1), labelled boxes
    over a raster's pix2face; then the device triples of
    ``meshes/sparse.py`` against the plain table's nonzero entries."""
    setup = view_setup(cuda)
    cfg = tr.RasterConfig(caps=(4096, 512, 64, 64))
    p2f, _ = tr.rasterize_setup(setup, cfg, 200, 320)
    rng = np.random.default_rng(n_local)
    cls = np.full((200, 320), -1, np.int32)
    for k in range(n_local):
        y, x = rng.integers(0, 190), rng.integers(0, 310)
        cls[y:y + rng.integers(3, 12), x:x + rng.integers(3, 12)] = k
    cls = torch.as_tensor(cls, device=cuda)
    n_faces = setup.planes.shape[0]
    got = face_counts.face_class_counts(p2f, cls, n_faces, n_local)
    want = face_counts.face_class_counts_plain(p2f, cls, n_faces, n_local)
    assert torch.equal(got, want) and int(got.sum()) > 0
    from geograypher_tpu_torch.meshes.sparse import local_class_image

    img = torch.where(cls >= 0, cls.double() * 3 + 7, float("nan"))
    local, classes = local_class_image(img)
    assert torch.equal(classes, torch.unique(cls[cls >= 0]).long() * 3 + 7)
    assert torch.equal(face_counts.face_class_counts(p2f, local, n_faces,
                                                     classes.numel()),
                       face_counts.face_class_counts_plain(p2f, local, n_faces,
                                                           classes.numel()))

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
        # float32 sums in pixel order on both: the same bits
        assert torch.equal(on_cpu[0], on_card[0])
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


@pytest.mark.parametrize("n,n_segments,c,shape", [
    (1, 1, 1, None), (5000, 300, 3, None), (3, 10, 1, None),
    (200000, 30000, 10, None), (70000, 7, 2, None),
    # 2-D images: sides no multiples of 32, odd rows (4-byte copies)
    (333 * 517, 20000, 10, (333, 517)), (480 * 640, 5000, 3, (480, 640)),
    (255 * 257, 3000, 1, (255, 257)),
    # more than 16 channels (two chunks); keys past 2^21 (64-bit words)
    (256 * 256, 100, 20, (256, 256)), (200 * 300, 2**21 + 9, 2, (200, 300)),
    (50000, 2**21 + 9, 1, None),
])
def test_face_sums_kernel_matches_plain(cuda, n, n_segments, c, shape):
    """The fixed-order sum kernels bit-equal to their plain version and to
    the CPU's, with int32 and int64 keys, and two runs equal: keys out of
    range, NaN and inf included."""
    rng = np.random.default_rng(n + c)
    keys = torch.as_tensor(rng.integers(-2, n_segments + 2, n).astype(np.int32))
    values = torch.as_tensor((rng.standard_normal((n, c)) * 1e3).astype(np.float32))
    values[torch.as_tensor(rng.random((n, c)) < 0.05)] = float("nan")
    values[torch.as_tensor(rng.random((n, c)) < 0.01)] = float("inf")
    k, v = keys.to(cuda), values.to(cuda)
    before = face_sums.launches
    sums, counts = face_sums.face_sums(k, v, n_segments, shape=shape)
    torch.cuda.synchronize()
    assert face_sums.launches == before + 1
    want_sums, want_counts = face_sums.face_sums_plain(k, v, n_segments, shape)
    assert torch.equal(sums, want_sums) and torch.equal(counts, want_counts)
    again = face_sums.face_sums(k, v, n_segments, shape=shape)
    assert torch.equal(again[0], sums) and torch.equal(again[1], counts)
    wide = face_sums.face_sums(k.long(), v, n_segments, shape=shape)
    assert torch.equal(wide[0], sums) and torch.equal(wide[1], counts)
    on_cpu = face_sums.face_sums(keys, values, n_segments, shape=shape)
    assert torch.equal(on_cpu[0], sums.cpu()) and torch.equal(on_cpu[1], counts.cpu())


def test_face_sums_long_faces_on_the_card(cuda):
    """A 4K view where face 0 covers every one of the 8,160 tiles (merged
    in global scratch), face 1 a 400 x 400 square (169 tiles, merged in
    shared memory) and small faces the rest: bit-equal to the plain
    version, two runs equal, and the call under 10 ms."""
    h, w, c = 2160, 3840, 10
    rng = np.random.default_rng(9)
    keys = np.zeros((h, w), np.int32)
    keys[500:900, 1000:1400] = 1
    scatter = rng.random((h, w)) < 0.01
    keys[scatter] = rng.integers(2, 1000, int(scatter.sum()))
    k = torch.as_tensor(keys.reshape(-1), device=cuda)
    v = torch.as_tensor(rng.random((h * w, c), dtype=np.float32), device=cuda)
    sums, counts = face_sums.face_sums(k, v, 1000, shape=(h, w))
    want_sums, want_counts = face_sums.face_sums_plain(k, v, 1000, (h, w))
    assert torch.equal(sums, want_sums) and torch.equal(counts, want_counts)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        again = face_sums.face_sums(k, v, 1000, shape=(h, w))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        assert torch.equal(again[0], sums) and torch.equal(again[1], counts)
    assert sorted(times)[2] < 10.0, times


def test_planned_aggregation_on_the_card(cuda):
    """The planner on the card equals the same plan on the CPU, a forced
    overflow included (gated, re-censused, re-run)."""
    import dataclasses as dc

    from geograypher_tpu_torch.parallel import planner

    verts, faces = make_grid_mesh(
        n=41, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y))
    tri = tr.tri_to_soa(torch.as_tensor(gather_tri_verts(verts, faces),
                                        dtype=torch.float32))
    c2ws = [oblique_camera(3.0, 180.0, 320, pitch_deg=p, azimuth_deg=a)
            for p, a in ((5.0, 0.0), (32.0, 135.0), (25.0, 250.0))]
    w2c = np.stack([np.linalg.inv(m) for m in c2ws])
    params = planner.pack_view_params(w2c, np.full(3, 180.0))
    labels = np.random.default_rng(3).integers(-1, 6, (3, 200, 320)).astype(np.int8)
    cfg = tr.RasterConfig(bin_block=8, l0_window=(5, 2))
    results = {}
    for device in ("cpu", "cuda"):
        t = tri.to(device)
        plan = planner.plan_aggregation(t, params, cfg, 200, 320, t.shape[1])
        forced = dc.replace(plan, buckets=(planner.BucketPlan(
            dc.replace(cfg, caps=(16, 16, 16, 16)), (0, 1, 2)),))
        out = []
        for p, weighted in ((plan, False), (plan, True), (forced, False)):
            agg = planner.PlannedAggregator(p, 6, weighted=weighted)
            agg.prepare(t, params, labels)
            agg.run()
            out.append((agg.finalize(), agg.resizes))
        results[device] = (plan, out)
    (plan_c, out_c), (plan_g, out_g) = results["cpu"], results["cuda"]
    assert plan_c.buckets == plan_g.buckets
    np.testing.assert_array_equal(out_g[0][0], out_c[0][0])
    assert out_g[0][0].sum() > 0
    np.testing.assert_array_equal(out_g[1][0][1], out_c[1][0][1])
    np.testing.assert_allclose(out_g[1][0][0], out_c[1][0][0], rtol=1e-6, atol=1e-7)
    assert out_g[2][1] >= 1 and out_c[2][1] == out_g[2][1]
    np.testing.assert_array_equal(out_g[2][0], out_c[0][0])


def test_pinned_upload_two_slots_on_a_copy_stream(cuda):
    """Three uploads back to back through the two-slot upload while the
    consumer stream lags (a sleep kernel before each read), each
    consumer's tensor dropped right after its read is queued: every read
    sees its own array (the copy stream, the consumer's wait on it and
    ``record_stream`` keep the slots and the device memory apart)."""
    from geograypher_tpu_torch.utils.device import PinnedUpload

    upload = PinnedUpload(cuda)
    n = 2048 * 2048
    sums = []
    for k in range(3):
        torch.cuda._sleep(50_000_000)
        on_device = upload(np.full((2048, 2048), k + 1, np.int32))
        sums.append(on_device.to(torch.int64).sum())
        del on_device
    torch.cuda.synchronize()
    assert [int(s) for s in sums] == [(k + 1) * n for k in range(3)]
    assert upload._stream is not None
    assert upload._stream.cuda_stream != torch.cuda.current_stream().cuda_stream
    assert all(s is not None for s in upload._stage)


def ortho_mesh(device, caps=None):
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    verts, faces = make_grid_mesh(
        n=101, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y))
    cfg = tr.RasterConfig(caps=caps or (4096, 1024, 256, 256))
    return TexturedMesh((verts, faces), raster_config=cfg, device=device)


def test_ortho_kernel_matches_plain(cuda):
    """The orthographic camera (f ~1e4 at 0.016 m a pixel, 251 x 251 px):
    the raster kernel bit for bit against its plain version, and the map
    ``ortho_pix2face`` pastes is the kernel's."""
    mesh = ortho_mesh(cuda)
    plan = mesh.ortho_plan(resolution_m=0.016)
    cfg = mesh.raster_config
    h, w = plan.tile_h, plan.tile_w
    setup = tr.setup_triangles(tr.transform_to_camera(plan.tri, plan.tiles[0][2]),
                               plan.focal, w, h, cfg.znear)
    binned = tr.bin_triangles(setup, cfg, h, w)
    assert int(binned.overflow) == 0
    cand, counts = tr.binned_face_lists(binned, cfg)
    planes = setup.planes.contiguous()
    before = raster_tiles.launches
    got = raster_tiles.raster_tiles(planes, setup.bbox, cand, counts, cfg, h, w)
    torch.cuda.synchronize()
    assert raster_tiles.launches == before + 1
    want = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, h, w)
    assert torch.equal(got, want)
    p2f, _, _ = mesh.ortho_pix2face(resolution_m=0.016)
    np.testing.assert_array_equal(p2f, got.cpu().numpy())
    assert (p2f >= 0).mean() > 0.95


def test_ortho_overflow_raises_on_the_card(cuda):
    """Caps too small for the ortho's tiles: one overflow read after the
    last tile, a raise naming the tiles and the caps; the census sizes
    caps that hold."""
    mesh = ortho_mesh(cuda, caps=(8, 8, 8, 8))
    with pytest.raises(RuntimeError, match=r"overflow in tiles .* caps \(8, 8, 8, 8\)"):
        mesh.ortho_pix2face(resolution_m=0.016, max_pixels=100)
    plan = mesh.ortho_plan(resolution_m=0.016, max_pixels=100)
    census = mesh.ortho_raster_census(plan, tr.RasterConfig())
    mesh.raster_config = tr.RasterConfig(caps=tuple(census))
    p2f, _, _ = mesh.ortho_pix2face(resolution_m=0.016, max_pixels=100)
    assert len(plan.tiles) == 9 and (p2f >= 0).mean() > 0.95


def test_rasterizers_raise_on_an_unread_overflow_on_the_card(cuda):
    """No drop is silent on the card: without ``return_overflow`` the
    public rasterizers read the overflow and raise."""
    setup = view_setup(cuda)
    starved = tr.RasterConfig(caps=(2, 2, 2, 2))
    with pytest.raises(ValueError, match="rasterize_and_count: the tile lists dropped"):
        tr.rasterize_and_count(setup, torch.zeros((200, 320), dtype=torch.int32,
                                                  device=cuda),
                               starved, 200, 320, int(setup.planes.shape[0]), 1)


def test_greedy_cover_on_the_card_equals_the_plain_greedy(cuda):
    """The greedy cover on the card picks what the plain loop picks on
    seeded matrices with ties and empty rows and columns."""
    import scipy.sparse

    from geograypher_tpu_torch.entrypoints.annotation_image_selection import (
        greedy_set_cover,
        greedy_set_cover_sparse,
    )

    for seed in range(8):
        rng = np.random.default_rng(seed)
        m = rng.random((int(rng.integers(50, 3000)), int(rng.integers(2, 60)))) < 0.05
        m[:, 1] = m[:, 0]
        m[::7] = False
        assert greedy_set_cover_sparse(scipy.sparse.csr_array(m), cuda) == (
            greedy_set_cover(m))


def test_assembly_on_the_card_equals_the_plain_assembly(cuda, tmp_path):
    """Chip predictions with 16-way overlap, nodata and saturating uint8
    counts assemble on the card to the plain numpy files, bit for bit."""
    from geograypher_tpu_torch.predictors import ortho
    from geograypher_tpu_torch.utils.io import write_image
    from geograypher_tpu_torch.utils.raster import Raster, read_geotiff, write_geotiff

    rng = np.random.default_rng(11)
    write_geotiff(tmp_path / "ortho.tif", Raster(np.zeros((70, 90, 3), np.uint8),
                                                 (1.0, 0, 5e5, 0, -1.0, 4e6), 32611))
    files = []
    for w in ortho.create_windows((70, 90), 40, 10):
        pred = rng.integers(0, 5, (w["height"], w["width"])).astype(np.uint8)
        pred[rng.random(pred.shape) < 0.1] = 255
        files.append(tmp_path / "p" / ortho.get_str_from_window(w, ".png"))
        write_image(files[-1], pred)
    for fn, kw, tag in ((ortho.assemble_tiled_predictions, dict(device=cuda), "card"),
                        (ortho.assemble_tiled_predictions_plain, {}, "plain")):
        fn(tmp_path / "ortho.tif", files, 5, tmp_path / f"c_{tag}.tif",
           counts_savefile=tmp_path / f"n_{tag}.tif", **kw)
    for name in ("c", "n"):
        a, b = (read_geotiff(tmp_path / f"{name}_{t}.tif").data for t in ("card", "plain"))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- the front end: triangle setup and tile binning --------------------------

FRONT_DIST8 = [0.02, -0.01, 0.0, 0.0, 1e-3, 0.0, 0.0, 0.0]


def front_view(device, view):
    """(rows, w2c, f, w, h, distortion) of a small bench-suite scene: 3192
    faces (a multiple of 8, not of 32) seen nadir, oblique, through a
    Brown-Conrady lens, or from a low oblique camera whose near faces fill
    the L2 and global lists (at 1280 x 720)."""
    verts, faces = make_grid_mesh(
        n=41, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y))
    tri = gather_tri_verts(verts, faces)[:3192]
    rows = tr.tri_to_soa(torch.as_tensor(tri, dtype=torch.float32)).to(device)
    w, h, f, dist = 320, 200, 180.0, None
    if view == "nadir":
        c2w = nadir_camera(4.0, f, w)
    elif view == "low_oblique":
        w, h, f = 1280, 720, 720.0
        c2w = oblique_camera(0.3, f, w, pitch_deg=70.0, azimuth_deg=0.0)
    else:
        c2w = oblique_camera(3.0, f, w, pitch_deg=32.0, azimuth_deg=135.0)
    if view == "brown_conrady":
        dist = (torch.tensor(FRONT_DIST8, device=device), torch.tensor(1.5, device=device),
                torch.tensor(-2.0, device=device))
    w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32, device=device)
    return rows, w2c, torch.tensor(f, device=device), w, h, dist


def assert_setup_equal(got, want):
    """Planes bit for bit (their int32 views), boxes and validity equal."""
    assert torch.equal(got.planes.view(torch.int32), want.planes.view(torch.int32))
    assert torch.equal(got.bbox, want.bbox) and torch.equal(got.valid, want.valid)


def assert_binning_equal(setup, cfg, h, w, exclude=None):
    """The binning kernels against the plain version: the census, then the
    lists, counts, overflow and face lists at census-sized caps and at
    half of them (where lists overflow).  Returns the census."""
    census = tr.bin_triangles(setup, cfg, h, w, return_census=True, exclude_blocks=exclude)
    want = binning.bin_triangles_plain(setup, cfg, h, w, True, exclude)
    torch.cuda.synchronize()
    assert census.dtype == torch.int64 and torch.equal(census, want)
    overflows = []
    for caps in ([c + 8 for c in census.tolist()], [max(1, c // 2) for c in census.tolist()]):
        cfg_c = dataclasses.replace(cfg, caps=tuple(caps))
        got = tr.bin_triangles(setup, cfg_c, h, w, exclude_blocks=exclude)
        plain = binning.bin_triangles_plain(setup, cfg_c, h, w, False, exclude)
        face_cand, face_counts_ = tr.binned_face_lists(plain, cfg_c)
        torch.cuda.synchronize()
        for lvl in range(4):
            assert torch.equal(got.cand[lvl], plain.cand[lvl])
            assert torch.equal(got.counts[lvl], plain.counts[lvl])
            assert torch.equal(got.face_cand[lvl], face_cand[lvl])
            assert torch.equal(got.face_counts[lvl], face_counts_[lvl])
        assert got.overflow.dtype == torch.int64 and torch.equal(got.overflow, plain.overflow)
        overflows.append(int(got.overflow))
    assert overflows[0] == 0 and (overflows[1] > 0 or not census.any())
    return census


FRONT_CONFIGS = {
    "main": tr.RasterConfig(),
    "bin_block8": tr.RasterConfig(bin_block=8, l0_window=(5, 2)),
    "global_from": tr.RasterConfig(global_from=2000),
    "level_s": tr.RasterConfig(bin_block=8, l0_window=(5, 2), subtile=(8, 16)),
}


@pytest.mark.parametrize("view", ["nadir", "oblique", "brown_conrady", "low_oblique"])
@pytest.mark.parametrize("config", sorted(FRONT_CONFIGS))
def test_front_kernels_match_plain(cuda, view, config):
    """The setup kernel and the binning kernels bit-equal to their plain
    versions on each view and configuration (bin_block 8 with partly
    invalid blocks, global_from, level S's exclusion), census included;
    each wrapper call launches its kernels once."""
    rows, w2c, f, w, h, dist = front_view(cuda, view)
    before = (tri_setup.launches, binning.launches)
    got = tr.setup_from_soa(rows, w2c, f, w, h, distortion=dist)
    want = tri_setup.setup_from_soa_plain(rows, w2c, f, w, h, distortion=dist)
    torch.cuda.synchronize()
    assert_setup_equal(got, want)
    cfg = FRONT_CONFIGS[config]
    exclude = subtile.subtile_mask8(want, cfg) if cfg.subtile else None
    census = assert_binning_equal(want, cfg, h, w, exclude)
    assert (tri_setup.launches, binning.launches) == (before[0] + 1, before[1] + 3)
    if cfg.bin_block > 1:
        blocks = want.valid.reshape(-1, cfg.bin_block)
        assert (blocks.any(1) & ~blocks.all(1)).any()  # partly invalid blocks
    if view == "low_oblique" and config == "main":
        assert census[2] > 0 and census[3] > 0
    if config == "global_from":
        assert census[3] > 0


def test_front_kernels_on_the_knife_edge_scene(cuda):
    """``knife_edge_triangles`` (vertices on pixel centres, slivers, edges
    over 2^18 px): setup and binning bit-equal to their plain versions."""
    w, h = 1280, 720
    tri = knife_edge_triangles(w, h, n_patches=4, patch_cells=30, n_small=2000,
                               n_slivers=500, n_long=20, max_sliver=600)
    rows = tr.tri_to_soa(torch.as_tensor(tri, device=cuda))
    eye = torch.eye(4, device=cuda)
    got = tr.setup_from_soa(rows, eye, torch.tensor(1.0, device=cuda), w, h)
    want = tri_setup.setup_from_soa_plain(rows, eye, torch.tensor(1.0, device=cuda), w, h)
    torch.cuda.synchronize()
    assert_setup_equal(got, want)
    assert_binning_equal(want, tr.RasterConfig(), h, w)


def test_setup_kernel_with_a_host_focal_length(cuda):
    """``f`` as a Python number, with and without the lens: the kernel
    takes it as PyTorch does (float32, and the lens bound divided by a
    multiply with the float32 reciprocal of f * f)."""
    rows, w2c, f, w, h, dist = front_view(cuda, "brown_conrady")
    for lens in (None, dist):
        got = tr.setup_from_soa(rows, w2c, 180.0, w, h, distortion=lens)
        want = tri_setup.setup_from_soa_plain(rows, w2c, 180.0, w, h, distortion=lens)
        torch.cuda.synchronize()
        assert_setup_equal(got, want)


def test_setup_kernel_refuses_float64(cuda):
    """float64 rows on the card raise; they never take the plain version."""
    rows, w2c, f, w, h, _ = front_view(cuda, "nadir")
    before = tri_setup.launches
    with pytest.raises(ValueError):
        tr.setup_from_soa(rows.double(), w2c, f, w, h)
    with pytest.raises(ValueError):
        tr.setup_from_soa(rows, w2c.double(), f, w, h)
    assert tri_setup.launches == before


def assert_one_buffer(setup, n):
    """The three outputs are the layout's views of one storage: planes at
    0, boxes at 48 n, validity at 64 n bytes, each 16-byte aligned, none
    overlapping another (the storage rounded up to 16 bytes)."""
    base = setup.planes.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in setup)
    assert setup.planes.untyped_storage().nbytes() == tri_setup.setup_layout(n)[-1]
    starts = [t.data_ptr() - base for t in setup]
    assert starts == list(tri_setup.setup_layout(n)[:3])
    assert all(t.data_ptr() % 16 == 0 for t in setup)
    ends = [s + t.numel() * t.element_size() for s, t in zip(starts, setup)]
    assert ends == starts[1:] + [65 * n]
    assert setup.planes.is_contiguous() and setup.bbox.is_contiguous()


# a block holds 512 faces (256 threads, two faces each): one face; the
# second face of a thread at 255-257; a block less one, a block, a block
# and one (a full 24,576-byte bulk copy, then a one-face one); two blocks
# and one; 3000, a last block of 440 faces
SETUP_SIZES = [1, 255, 256, 257, 511, 512, 513, 1025, 3000]


@pytest.mark.parametrize("f_kind", ["host", "tensor"])
@pytest.mark.parametrize("lens", [False, True])
@pytest.mark.parametrize("n", SETUP_SIZES)
def test_setup_kernel_at_block_edges(cuda, n, lens, f_kind):
    """The block edges of ``SETUP_SIZES``: the kernel bit-equal to the
    plain version with and without the lens, at a host and at a tensor f;
    two runs equal; the outputs the layout's views of one buffer."""
    rows, w2c, f, w, h, dist = front_view(cuda, "brown_conrady")
    rows = rows[:, rows.shape[1] // 2 - n // 2:][:, :n].contiguous()
    f = 180.0 if f_kind == "host" else f
    dist = dist if lens else None
    before = tri_setup.launches
    got = tr.setup_from_soa(rows, w2c, f, w, h, distortion=dist)
    again = tr.setup_from_soa(rows, w2c, f, w, h, distortion=dist)
    want = tri_setup.setup_from_soa_plain(rows, w2c, f, w, h, distortion=dist)
    torch.cuda.synchronize()
    assert tri_setup.launches == before + 2
    assert_setup_equal(got, want)
    assert_setup_equal(again, got)
    assert_one_buffer(got, n)
    assert n < 256 or want.valid.any()


def unruly_rows(device):
    """(9, 3000) camera-frame rows of a small scene (seen through the eye
    camera), every 7th face with one vertex replaced in turn by a NaN, an
    infinity, a vertex behind the near plane, one just past it (projected
    past 2^30 px) and one far off screen (1e12 m aside)."""
    rows, w2c, _, _, _, _ = front_view(device, "oblique")
    cam = torch.cat([rows.view(3, 3, -1), torch.ones_like(rows[:3]).unsqueeze(1)], 1)
    cam = torch.einsum("ij,vjf->vif", w2c[:3], cam)  # (3 vertices, xyz, F)
    cam = cam[:, :, :3000].clone()
    spots = torch.arange(0, 3000, 7, device=device)
    vertex = spots % 3
    for k, (axis, value) in enumerate([(0, float("nan")), (1, float("inf")),
                                       (2, 1e-7), (2, 2e-6), (0, 1e12)]):
        pick = spots[k::5]
        cam[vertex[k::5], axis, pick] = value
    return cam.reshape(9, -1).contiguous()


@pytest.mark.parametrize("f_kind", ["host", "tensor"])
@pytest.mark.parametrize("lens", [False, True])
def test_setup_kernel_on_unruly_rows(cuda, lens, f_kind):
    """NaN, infinite, near-plane and far off-screen vertices give the plain
    version's boxes, validity and sentinel rows, bit for bit."""
    rows = unruly_rows(cuda)
    eye = torch.eye(4, device=cuda)
    f = 180.0 if f_kind == "host" else torch.tensor(180.0, device=cuda)
    dist = (torch.tensor(FRONT_DIST8, device=cuda), torch.tensor(1.5, device=cuda),
            torch.tensor(-2.0, device=cuda)) if lens else None
    got = tr.setup_from_soa(rows, eye, f, 320, 200, distortion=dist)
    want = tri_setup.setup_from_soa_plain(rows, eye, f, 320, 200, distortion=dist)
    torch.cuda.synchronize()
    assert_setup_equal(got, want)
    spots = torch.arange(0, 3000, 7, device=cuda)
    # a NaN vertex and one behind the near plane drop their face
    assert not want.valid[spots[0::5]].any() and not want.valid[spots[2::5]].any()
    assert want.valid.any()


def test_front_end_reads_nothing_back(cuda):
    """Setup and binning (lists and census, level S's exclusion included)
    read nothing back to the host."""
    rows, w2c, f, w, h, dist = front_view(cuda, "brown_conrady")
    cfg = dataclasses.replace(FRONT_CONFIGS["level_s"], caps=(512, 128, 64, 64))
    tr.bin_all(tr.setup_from_soa(rows, w2c, f, w, h, distortion=dist), cfg, h, w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        setup = tr.setup_from_soa(rows, w2c, f, w, h, distortion=dist)
        binned, su = tr.bin_all(setup, cfg, h, w)
        tr.binned_face_lists(binned, cfg)
        tr.bin_triangles(setup, cfg, h, w, return_census=True, exclude_blocks=su.s_mask8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(binned.overflow) == 0


def crowded_setup(device, w=1280, h=720, n_tile=6000):
    """``crowded_tile_triangles`` at 1280 x 720 with 200,000 scattered
    faces: an L0 list and the global list longer than a warp sorts (512
    ids; the L0 list of ~1,650 faces at ``n_tile`` 2000), their ids
    spread over two of the long-segment kernel's bitmap windows (131,072
    unit ids), most other L0 lists of 256-512 ids."""
    tri = crowded_tile_triangles(w, h, n_tile=n_tile, n_scatter=200000)
    return tr.setup_triangles(torch.as_tensor(tri, device=device),
                              torch.tensor(1.0, device=device), w, h), w, h


def binning_outputs(binned):
    return (binned.cand + binned.counts + binned.face_cand + binned.face_counts
            + (binned.overflow,))


@pytest.mark.parametrize("config", ["main", "bin_block8"])
@pytest.mark.parametrize("n_tile", [2000, 6000])
def test_binning_long_lists(cuda, n_tile, config):
    """Lists longer than a warp sorts go to the block kernel, which reads
    them out of bitmap windows of unit ids; bit-equal to the plain version
    at census caps and at half of them."""
    setup, w, h = crowded_setup(cuda, n_tile=n_tile)
    census = assert_binning_equal(setup, FRONT_CONFIGS[config], h, w)
    assert census[3] > 512 and (census[0] > 512 or config != "main")


@pytest.mark.parametrize("config", ["main", "bin_block8"])
def test_binning_grid_past_the_shared_histogram(cuda, config):
    """An 8192 x 8192 view has 69,889 tiles, more than the count kernel's
    shared histogram holds (57,344): it counts in global memory,
    bit-equal to the plain version."""
    w = h = 8192
    verts, faces = make_grid_mesh(n=41, size=4.0,
                                  z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y))
    tri = torch.as_tensor(gather_tri_verts(verts, faces), dtype=torch.float32)
    w2c = torch.as_tensor(np.linalg.inv(nadir_camera(4.0, 4000.0, w)), dtype=torch.float32)
    setup = tr.setup_from_soa(tr.tri_to_soa(tri).to(cuda), w2c.to(cuda),
                              torch.tensor(4000.0, device=cuda), w, h)
    cfg = FRONT_CONFIGS[config]
    assert sum(a * b for a, b in cfg.grids(h, w)) + 1 == 69889
    assert_binning_equal(setup, cfg, h, w)


@pytest.mark.parametrize("config", ["main", "bin_block8", "level_s"])
def test_binning_two_runs_are_equal(cuda, config):
    """The scatter's order differs from run to run; the lists do not."""
    setup, w, h = crowded_setup(cuda)
    cfg = FRONT_CONFIGS[config]
    exclude = subtile.subtile_mask8(setup, cfg) if cfg.subtile else None
    census = tr.bin_triangles(setup, cfg, h, w, return_census=True, exclude_blocks=exclude)
    cfg = dataclasses.replace(cfg, caps=tuple(int(c) + 8 for c in census.tolist()))
    runs = [binning_outputs(tr.bin_triangles(setup, cfg, h, w, exclude_blocks=exclude))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(census, tr.bin_triangles(setup, cfg, h, w, return_census=True,
                                                exclude_blocks=exclude))


def test_binning_on_the_card_never_sorts(cuda, monkeypatch):
    """The card's binning calls no PyTorch sort."""
    setup, w, h = crowded_setup(cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("the card's binning sorted")

    for name in ("sort", "argsort", "searchsorted"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse, raising=False)
    binned = tr.bin_triangles(setup, tr.RasterConfig(caps=(8192, 64, 512, 8192)), h, w)
    monkeypatch.undo()
    plain = binning.bin_triangles_plain(setup, tr.RasterConfig(caps=(8192, 64, 512, 8192)),
                                        h, w)
    assert all(torch.equal(a, b) for a, b in zip(binned.cand, plain.cand))
