"""The premises of the raster kernels' cull and of the face-parallel level-S
kernel, on the CPU: where a face can cover pixels under the rounded edge
test, the packed (1/z, id) key's order, and a face-parallel reference of
``s_raster`` over its domains against the plain version."""

import numpy as np
import pytest
import torch

from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.ops import raster_tiles as rt
from geograypher_tpu_torch.ops import subtile as ts
from geograypher_tpu_torch.utils.fixtures import knife_edge_triangles
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401
from tests.test_torch_subtile import TCFG, scene  # noqa: F401

W4K, H4K = 3840, 2160
WINDOW = 16  # px around each box searched for coverage


def knife_setup():
    tri = knife_edge_triangles(W4K, H4K, seed=1, n_patches=2, patch_cells=20,
                               n_small=500, n_slivers=300, n_long=10,
                               max_sliver=300)
    return tr.setup_triangles(torch.as_tensor(tri), torch.tensor(1.0), W4K, H4K)


def covered_outside(planes, bbox, f, h, w, margin):
    """Pixels face ``f`` covers (the plain version's rounded edge test)
    within WINDOW px of its box but outside the box widened by margin."""
    y0, x0, y1, x1 = (int(v) for v in bbox[:, f])
    ys = torch.arange(max(y0 - WINDOW, 0), min(y1 + WINDOW + 1, h))
    xs = torch.arange(max(x0 - WINDOW, 0), min(x1 + WINDOW + 1, w))
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    px, py = xx.float()[..., None] + 0.5, yy.float()[..., None] + 0.5
    pl = planes[f]
    e = px * pl[0:9:3] + py * pl[1:9:3] + pl[2:9:3]
    cov = (e >= 0).all(dim=-1)
    out = (yy < y0 - margin) | (yy > y1 + margin) | (xx < x0 - margin) | (xx > x1 + margin)
    return int((cov & out).sum())


@pytest.mark.parametrize("scene_name", ["knife_edge_4k", "oblique_grid"])
def test_coverage_lies_in_the_cull_box(scene_name):
    """(a) Every pixel a face covers lies within its box +-1 px unless the
    cull rule exempts it: a coefficient above 2^18 (long edges) or a
    vertex too sharp for the margin.  The sharpness clause is needed: on
    the knife-edge slivers a box +-1 px alone misses covered pixels."""
    if scene_name == "knife_edge_4k":
        setup, h, w = knife_setup(), H4K, W4K
    else:
        from tests.test_torch_rasterize import both_setups, oblique_scene

        tri, w2c, f, w, h = oblique_scene()
        setup = both_setups(tri, w2c, f, w, h, False)[1]
    kind = rt.cull_rule(setup.planes, h, w)
    big = setup.planes[:, [0, 1, 3, 4, 6, 7]].abs().amax(dim=1) > rt.CULL_MAX_COEF
    assert ((kind == rt.CULL_NEVER) == ~setup.valid).all()  # sentinel rows
    assert (kind[big] == rt.CULL_EXEMPT).all()
    naive_misses = 0
    for f in torch.nonzero(setup.valid).squeeze(1).tolist():
        n_out = covered_outside(setup.planes, setup.bbox, f, h, w, rt.CULL_MARGIN)
        if kind[f] == rt.CULL_BOX:
            assert n_out == 0, (f, n_out)
        elif not big[f]:
            naive_misses += n_out > 0
    if scene_name == "knife_edge_4k":
        assert int((setup.valid & big).sum()) >= 5  # long edges, on screen
        assert naive_misses > 0  # sharp slivers break a plain 1 px margin
    else:
        assert (kind[setup.valid] == rt.CULL_BOX).all()


def test_cull_boxes_and_warp_rects():
    """The cull boxes follow the kinds; every tile shape the kernel takes
    splits into 8 warp rectangles of at most 256 pixels that cover each
    pixel of the image exactly once."""
    setup = knife_setup()
    kind = rt.cull_rule(setup.planes, H4K, W4K)
    boxes = rt.cull_boxes(setup.planes, setup.bbox, H4K, W4K)
    box = kind == rt.CULL_BOX
    assert torch.equal(boxes[box], setup.bbox.T[box].long() + torch.tensor([-1, -1, 1, 1]))
    assert (boxes[kind == rt.CULL_EXEMPT] == torch.tensor([0, 0, H4K - 1, W4K - 1])).all()
    never = boxes[kind == rt.CULL_NEVER]
    assert (never[:, 0] > never[:, 2]).all()
    assert rt.warp_split(8, 128) == (1, 8, 8, 16)
    for th, tw, h, w in ((8, 128, 37, 300), (9, 113, 50, 250), (3, 341, 10, 700),
                         (32, 32, 70, 90), (1, 1024, 3, 2100), (1024, 1, 2100, 3)):
        wy, wx, rh, rw = rt.warp_split(th, tw)
        assert wy * wx == 8 and rh * rw <= 256
        cfg = tr.RasterConfig(tile_h=th, tile_w=tw)
        rects = rt.warp_rects(cfg, h, w).reshape(-1, 4)
        hits = torch.zeros((h, w), dtype=torch.int64)
        for y0, x0, y1, x1 in rects.tolist():
            if y0 <= y1 and x0 <= x1:
                hits[y0:y1 + 1, x0:x1 + 1] += 1
        assert (hits == 1).all(), (th, tw)


def test_kernel_cand_pixels_between_need_and_tiles():
    """The candidate-pixels the culled kernel evaluates lie between what
    the faces' own boxes need and what whole tiles cost."""
    from tests.test_torch_rasterize import both_setups, oblique_scene

    tri, w2c, f, w, h = oblique_scene()
    setup = both_setups(tri, w2c, f, w, h, False)[1]
    cfg = tr.RasterConfig(caps=(96, 32, 16, 24))
    cand, counts = tr.binned_face_lists(tr.bin_triangles(setup, cfg, h, w), cfg)
    got = rt.kernel_cand_pixels(setup.planes, setup.bbox, cand, counts, cfg, h, w)
    groups = rt.tile_candidate_groups(cand, counts, cfg, h, w)
    tile_cost = sum(int(ok.sum()) for _, ok in groups) * cfg.tile_h * cfg.tile_w
    py0, px0, py1, px1 = (setup.bbox[k].long() for k in range(4))
    need = int(torch.where(setup.valid, (py1 - py0 + 1) * (px1 - px0 + 1), 0).sum())
    assert need < got < tile_cost / 2, (need, got, tile_cost)


def unpack_key(key):
    """The kernel's unpack on :func:`s_pack_key`'s int64 keys."""
    low = torch.remainder(key, 2**32)
    ordered = torch.div(key - low, 2**32, rounding_mode="floor") + 2**31
    bits = torch.where(ordered >= 2**31, ordered - 2**31, 0xFFFFFFFF - ordered)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return bits.view(torch.float32), (0xFFFFFFFF - low).to(torch.int32)


def test_packed_key_max_is_max_w_then_min_id():
    """(b) The max of the packed key is the larger w, then the lower id,
    on random pairs with ties, -0.0 / +0.0 and tiny w."""
    rng = np.random.default_rng(5)
    pool = np.array([-0.0, 0.0, 1e-40, -1e-40, 1e-30, 0.25, 0.2500001, 3.0,
                     -2.0, 7e5, np.float32(1.0 / 3.0)], np.float32)
    n, n_bins = 20000, 500
    w = torch.as_tensor(rng.choice(pool, n))
    ids = torch.as_tensor(rng.integers(0, 2**31 - 1, n).astype(np.int32))
    ids[: n // 4] = torch.as_tensor(rng.integers(0, 50, n // 4).astype(np.int32))
    bins = torch.as_tensor(rng.integers(0, n_bins, n))
    key = ts.s_pack_key(w, ids)
    best = torch.full((n_bins,), torch.iinfo(torch.int64).min).scatter_reduce(
        0, bins, key, "amax")
    got_w, got_id = unpack_key(best)
    for b in range(n_bins):
        sel = bins == b
        wb, ib = w[sel], ids[sel]
        top = wb.max()
        assert got_w[b] == top  # -0.0 == +0.0
        assert got_id[b] == ib[wb == top].min()
    # the unpack restores each key's own pair, with -0.0 folded to +0.0
    w_back, id_back = unpack_key(key)
    assert torch.equal(id_back, ids) and torch.equal(w_back, w + 0.0)
    assert not torch.signbit(w_back[w == 0]).any()


def s_raster_face_parallel(su, setup, config, h, w):
    """A face-parallel torch reference of the CUDA kernel: every face of
    an S unit over its domain, the packed keys reduced with a max."""
    dom = ts.s_face_domains(su, setup, config, h, w)
    live = torch.nonzero((dom[:, 0] <= dom[:, 2]) & (dom[:, 1] <= dom[:, 3])).squeeze(1)
    d = dom[live]
    assert (d[:, :2] >= 0).all() and (d[:, 2] < h).all() and (d[:, 3] < w).all()
    wy, wx = config.s_window
    sh, sw = config.subtile
    dy = torch.arange(wy * sh)[None, :, None]
    dx = torch.arange(wx * sw)[None, None, :]
    y = d[:, 0, None, None] + dy
    x = d[:, 1, None, None] + dx
    inside = (y <= d[:, 2, None, None]) & (x <= d[:, 3, None, None])
    px, py = x.float() + 0.5, y.float() + 0.5
    pl = setup.planes[live][:, None, None, :]

    def plane(k):
        return px * pl[..., 3 * k] + py * pl[..., 3 * k + 1] + pl[..., 3 * k + 2]

    cov = inside & (plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
    key = ts.s_pack_key(plane(3), live[:, None, None].expand_as(cov).to(torch.int32))
    none = torch.iinfo(torch.int64).min
    best = torch.full((h * w,), none).scatter_reduce(
        0, (y * w + x)[cov], key[cov], "amax")
    bw, bid = unpack_key(best)
    empty = best == none
    bw = torch.where(empty, float("-inf"), bw)
    bid = torch.where(empty, -1, bid)
    return bw.reshape(h, w), bid.reshape(h, w), int(inside.sum())


def test_face_parallel_reference_equals_s_raster_plain(scene):  # noqa: F811
    """(c) Every S face over its domain (its box +-1 px within its unit's
    cells; the cells when exempt), reduced with the packed-key max, equals
    the plain sub-tile raster bit for bit."""
    _, tsetup, w, h = scene
    su = ts.subtile_units(tsetup, TCFG)
    want_w, want_id = ts.s_raster_plain(ts.bin_subtiles(tsetup, TCFG, h, w),
                                        tsetup.planes.contiguous(), TCFG, h, w)
    got_w, got_id, n_eval = s_raster_face_parallel(su, tsetup, TCFG, h, w)
    assert torch.equal(got_id, want_id) and torch.equal(got_w, want_w)
    assert (want_id >= 0).sum() > 1000
    # the domains hold far fewer candidate-pixels than every unit slot
    # over its sub-tiles
    sb = ts.bin_subtiles(tsetup, TCFG, h, w)
    per_slot = int(sb.units.numel()) * TCFG.s_block * TCFG.subtile[0] * TCFG.subtile[1]
    assert n_eval < per_slot / 3
    assert int(ts.subtile_pairs(su)) == sb.units.numel()
