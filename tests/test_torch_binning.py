"""The card's counting binning (``csrc/tile_binning.cu``) as a numpy model,
held equal to the plain version and to the JAX package on the CPU.

The kernels run only on the card; this model follows their algorithm
step by step so that the algorithm itself is tested here: the window
keys of every unit (``unit_window`` and ``slot_key``), per-block counts
summed into per-tile counts (shared or global histogram), the exclusive
scan with the overflow and the census, a scatter of the unit ids into
per-tile segments, each run of neighbouring units of a warp with one key
written as one piece of consecutive ids, the pieces in a shuffled order
(the card's atomics give no order), and the cut: a segment of up to 512
ids sorted by a warp, a longer one queued for a block that reads it out
of bitmap windows of ``BITMAP_WORDS * 32`` unit ids from its smallest id,
stopping at the cap."""

import re
from pathlib import Path

import dataclasses

import numpy as np
import pytest
import torch

from geograypher_tpu.ops import rasterize as jr
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.ops import binning
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.utils.fixtures import (crowded_tile_triangles,
                                                  gather_tri_verts, make_grid_mesh,
                                                  nadir_camera)
from tests.test_torch_front import setups
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

INT32_MAX = 2**31 - 1
# the kernel's most shared-memory histogram bins (kMaxSharedBins); the
# longest segment a warp sorts (kMidSortMax); the 32-bit words of the
# long-segment kernel's bitmap window (kBitmapWords)
MAX_SHARED_BINS = 57344
WARP_SORT_MAX = 512
BITMAP_WORDS = 4096
KERNEL_SOURCE = (Path(__file__).resolve().parents[1] / "geograypher_tpu_torch" / "csrc"
                 / "tile_binning.cu")


def model_keys(setup, cfg, h, w, exclude=None):
    """(n_units, wy0 * wx0) int64 tile keys, -1 in an unused slot."""
    bb = cfg.bin_block
    bbox = setup.bbox.numpy().astype(np.int64)
    valid = setup.valid.numpy()
    n_units = valid.size // bb
    box = bbox.reshape(4, n_units, bb)
    members = valid.reshape(n_units, bb)
    y0 = np.where(members, box[0], INT32_MAX).min(1)
    x0 = np.where(members, box[1], INT32_MAX).min(1)
    y1 = np.where(members, box[2], -1).max(1)
    x1 = np.where(members, box[3], -1).max(1)
    ok = members.any(1)
    if exclude is not None:
        ok &= ~exclude.numpy()
    grids = cfg.grids(h, w)
    bases = np.cumsum([0] + [a * b for a, b in grids])
    wy0, wx0 = binning._window(cfg)
    global_from = INT32_MAX if cfg.global_from is None else cfg.global_from
    small = np.arange(n_units) * bb + (bb - 1) < global_from
    levels = []
    for lvl, scale in enumerate(cfg.level_scales):
        th, tw = cfg.tile_h * scale, cfg.tile_w * scale
        ty0, ty1, tx0, tx1 = y0 // th, y1 // th, x0 // tw, x1 // tw
        wy, wx = (wy0, wx0) if lvl == 0 else (2, 2)
        fits = (ty1 - ty0 < wy) & (tx1 - tx0 < wx) & small
        levels.append((fits, ty0, ty1, tx0, tx1, bases[lvl], grids[lvl][1]))
    at_l3 = ~(levels[0][0] | levels[1][0] | levels[2][0])
    level = np.where(levels[0][0], 0, np.where(levels[1][0], 1, 2))

    def pick(i):
        return np.choose(level, [np.broadcast_to(lv[i], level.shape) for lv in levels])

    wy_0, wy_1, wx_0, wx_1, base, ntx = (pick(i) for i in range(1, 7))
    keys = np.full((n_units, wy0 * wx0), -1, np.int64)
    for dy in range(wy0):
        for dx in range(wx0):
            ty, tx = wy_0 + dy, wx_0 + dx
            key = np.where((ty <= wy_1) & (tx <= wx_1) & ~at_l3, base + ty * ntx + tx, -1)
            if dy == 0 and dx == 0:
                key = np.where(at_l3, bases[3], key)
            keys[:, dy * wx0 + dx] = np.where(ok, key, -1)
    return keys


def model_binning(setup, cfg, h, w, return_census=False, exclude=None,
                  words=BITMAP_WORDS, n_blocks=7, seed=0):
    """The kernels' algorithm on the CPU: (result, paths), the result as
    the plain version returns it (with the face lists), paths what the
    count and cut steps took.  ``words`` sets the bitmap window (the
    kernel's at its default; fewer words reach many windows a list on a
    small scene), ``n_blocks`` the count blocks, ``seed`` the scatter's
    order."""
    keys = model_keys(setup, cfg, h, w, exclude)
    n_units = keys.shape[0]
    n_tiles = [a * b for a, b in cfg.grids(h, w)] + [1]
    total = sum(n_tiles)
    bases = np.cumsum([0] + n_tiles)
    caps = list(cfg.caps)
    level_of = np.searchsorted(bases, np.arange(total), side="right") - 1
    cap_of = np.asarray(caps)[level_of]
    paths = {"histogram": "shared" if total <= MAX_SHARED_BINS else "global", "long_tiles": 0, "bitmap_tiles": 0, "windows": 0}
    # count: each block's contiguous range of units, summed per tile
    counts = np.zeros(total, np.int64)
    per = -(-n_units // n_blocks)
    for blk in range(n_blocks):
        k = keys[blk * per:(blk + 1) * per].ravel()
        counts += np.bincount(k[k >= 0], minlength=total)
    # scan: segment starts, overflow, census
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    overflow = int(np.maximum(counts - cap_of, 0).sum())
    census = np.array([counts[bases[lvl]:bases[lvl + 1]].max() for lvl in range(4)])
    if return_census:
        return torch.as_tensor(census), paths
    # scatter: each block's units in warps of 32; in each slot a run of
    # neighbouring lanes with one key is one piece of consecutive ids,
    # the pieces placed in a shuffled order
    lane_unit = np.arange(n_units)
    warp = (lane_unit // per) * per + (lane_unit % per) // 32 * 32  # its first unit
    pieces = []  # (tile, first unit, length)
    for s in range(keys.shape[1]):
        k = keys[:, s]
        head = np.ones(n_units, bool)
        head[1:] = (k[1:] != k[:-1]) | (warp[1:] != warp[:-1])
        first = np.flatnonzero(head)
        length = np.diff(np.append(first, n_units))
        kept_piece = k[first] >= 0
        pieces += list(zip(k[first][kept_piece], first[kept_piece], length[kept_piece]))
    order = np.random.default_rng(seed).permutation(len(pieces))
    seg = np.full(n_units * keys.shape[1], -1, np.int64)
    fill = start.copy()
    for i in order:
        t, u0, n_piece = pieces[i]
        seg[fill[t]:fill[t] + n_piece] = np.arange(u0, u0 + n_piece)
        fill[t] += n_piece
    # cut: each tile's smallest `cap` ids, ascending
    span = words * 32
    cand = [np.full((n, cap), -1, np.int64) for n, cap in zip(n_tiles, caps)]
    for t in np.flatnonzero(counts):
        lvl, n = level_of[t], counts[t]
        ids = seg[start[t]:start[t] + n]
        kept = min(n, caps[lvl])
        paths["long_tiles"] += n > WARP_SORT_MAX
        if n <= WARP_SORT_MAX:
            row = np.sort(ids)[:kept]
        else:
            paths["bitmap_tiles"] += 1
            row, w0 = [], ids.min()
            while len(row) < kept:
                bits = np.zeros(span, bool)
                inside = (ids >= w0) & (ids < w0 + span)
                bits[ids[inside] - w0] = True
                row.extend((w0 + np.flatnonzero(bits))[:kept - len(row)])
                w0 += span
                paths["windows"] += 1
        cand[lvl][t - bases[lvl], :kept] = row
    bb = cfg.bin_block
    cand = tuple(torch.as_tensor(c, dtype=torch.int32) for c in cand)
    clipped = tuple(torch.as_tensor(np.minimum(counts[bases[lvl]:bases[lvl + 1]],
                                               caps[lvl]), dtype=torch.int32)
                    for lvl in range(4))
    result = binning.BinnedTriangles(
        cand=cand, counts=clipped, overflow=torch.tensor(overflow),
        face_cand=tuple(binning.expand_block_ids(c, bb) for c in cand),
        face_counts=tuple(c * bb for c in clipped))
    return result, paths


def assert_equal_to_plain(setup, cfg, h, w, exclude=None, **model_args):
    """The model against ``bin_triangles_plain``: the census, then the
    lists, counts, face lists and overflow at ``cfg``'s caps.  Returns
    the model's paths of the list run."""
    census, _ = model_binning(setup, cfg, h, w, True, exclude, **model_args)
    assert torch.equal(census, binning.bin_triangles_plain(setup, cfg, h, w, True, exclude))
    got, paths = model_binning(setup, cfg, h, w, False, exclude, **model_args)
    plain = binning.bin_triangles_plain(setup, cfg, h, w, False, exclude)
    face_cand, face_counts = tr.binned_face_lists(plain, cfg)
    for lvl in range(4):
        assert torch.equal(got.cand[lvl], plain.cand[lvl])
        assert torch.equal(got.counts[lvl], plain.counts[lvl])
        assert torch.equal(got.face_cand[lvl], face_cand[lvl])
        assert torch.equal(got.face_counts[lvl], face_counts[lvl])
    assert int(got.overflow) == int(plain.overflow)
    return paths


def crowded_scene(w=1280, h=720, n_tile=6000):
    """``crowded_tile_triangles`` at 1280 x 720 with 5,000 scattered faces:
    the global list of ~4,900 units and an L0 list of ~4,900 (of ~1,650
    at ``n_tile`` 2000)."""
    tri = crowded_tile_triangles(w, h, n_tile=n_tile, n_scatter=5000)
    return tr.setup_triangles(torch.as_tensor(tri), torch.tensor(1.0), w, h), w, h


def scene_setup(name):
    if name == "crowded":
        return crowded_scene()
    _, ts, w, h = setups(name, False)
    return ts, w, h


@pytest.mark.parametrize("name", ["oblique", "edge", "crowded"])
@pytest.mark.parametrize("bin_block,l0_window,global_from", [
    (1, 2, None), (1, (5, 2), None), (8, 2, None), (8, (5, 2), None),
    (8, (5, 2), 200), (1, 3, 201),
])
def test_model_matches_plain(name, bin_block, l0_window, global_from):
    """Census, lists, counts, face lists and overflow (tight caps) equal
    the plain version's at every binning argument."""
    setup, w, h = scene_setup(name)
    cfg = tr.RasterConfig(caps=(24, 16, 8, 12), bin_block=bin_block,
                          l0_window=l0_window, global_from=global_from)
    assert_equal_to_plain(setup, cfg, h, w)


@pytest.mark.parametrize("census", [False, True])
def test_model_matches_jax(census):
    """The model against the JAX package's ``bin_triangles`` directly."""
    js, ts, w, h = setups("oblique", False)
    jcfg = jr.RasterConfig(caps=(24, 16, 8, 12), bin_block=8, l0_window=(5, 2))
    want = jr.bin_triangles(js, jcfg, h, w, return_census=census)
    got, _ = model_binning(ts, interop.raster_config_from_jax(jcfg), h, w, census)
    if census:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    for lvl in range(4):
        np.testing.assert_array_equal(got.cand[lvl].numpy(), np.asarray(want.cand[lvl]))
    assert int(got.overflow) == int(want.overflow)


@pytest.mark.parametrize("census_caps", [False, True])
def test_model_excluded_blocks(census_caps):
    """``exclude_blocks`` drops its blocks from the lists and the census."""
    setup, w, h = scene_setup("oblique")
    mask = torch.as_tensor(np.random.default_rng(5).random(setup.valid.shape[0] // 8) < 0.4)
    cfg = tr.RasterConfig(caps=(96, 32, 16, 24), bin_block=8, l0_window=(5, 2))
    if census_caps:
        census = binning.bin_triangles_plain(setup, cfg, h, w, True, mask)
        cfg = dataclasses.replace(cfg, caps=tuple(int(c) + 8 for c in census))
    assert_equal_to_plain(setup, cfg, h, w, mask)


@pytest.mark.parametrize("caps", [(1, 1, 1, 1), (2, 1, 3, 1), (5, 3, 2, 2)])
def test_model_overflow_at_tiny_caps(caps):
    """Lists cut at caps of a few units: the overflow is every unit past
    them, the lists the smallest ids."""
    setup, w, h = scene_setup("edge")
    assert_equal_to_plain(setup, tr.RasterConfig(caps=caps), h, w)


@pytest.mark.parametrize("n_tile,words,half", [
    (6000, 4096, False), (6000, 4096, True), (6000, 256, False), (6000, 8, False),
    (6000, 8, True), (2000, 4096, False), (2000, 4096, True)])
def test_model_long_lists(n_tile, words, half):
    """Lists past a warp's 512 ids are queued for the block, which reads
    them out of bitmap windows of ``words * 32`` unit ids (an L0 list of
    ~1,650 ids at ``n_tile`` 2000, of ~4,900 at 6,000; at 8 words, windows
    of 256 ids, many a list), at census caps and at half of them."""
    setup, w, h = crowded_scene(n_tile=n_tile)
    cfg = tr.RasterConfig()
    census = binning.bin_triangles_plain(setup, cfg, h, w, True).tolist()
    caps = [max(1, c // 2) if half else c + 8 for c in census]
    paths = assert_equal_to_plain(setup, dataclasses.replace(cfg, caps=tuple(caps)), h, w,
                                  words=words)
    assert paths["long_tiles"] >= 2 and paths["bitmap_tiles"] == paths["long_tiles"]
    if n_tile == 2000:
        assert 512 < census[0] <= 4096 < census[3]
    else:
        assert census[0] > 4096 and census[3] > 4096
    if words == 8:
        assert paths["windows"] > 2 * paths["bitmap_tiles"]


@pytest.mark.parametrize("bin_block", [1, 8])
def test_model_grid_past_the_shared_histogram(bin_block):
    """An 8192 x 8192 view has 69,889 tiles, more than the shared
    histogram holds: it takes the global histogram, with the same lists;
    the oblique scene's 29 tiles take the shared one."""
    w = h = 8192
    verts, faces = make_grid_mesh(n=41, size=4.0,
                                  z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y))
    tri = torch.as_tensor(gather_tri_verts(verts, faces), dtype=torch.float32)
    w2c = torch.as_tensor(np.linalg.inv(nadir_camera(4.0, 4000.0, w)), dtype=torch.float32)
    setup = tr.setup_from_soa(tr.tri_to_soa(tri), w2c, torch.tensor(4000.0), w, h)
    cfg = tr.RasterConfig(bin_block=bin_block)
    census = binning.bin_triangles_plain(setup, cfg, h, w, True).tolist()
    cfg = dataclasses.replace(cfg, caps=tuple(max(1, c // 2) for c in census))
    assert sum(a * b for a, b in cfg.grids(h, w)) + 1 == 69889
    assert assert_equal_to_plain(setup, cfg, h, w)["histogram"] == "global"
    setup, w, h = scene_setup("oblique")
    cfg = tr.RasterConfig(caps=(24, 16, 8, 12), bin_block=bin_block, l0_window=(5, 2))
    assert sum(a * b for a, b in cfg.grids(h, w)) + 1 == 29
    assert assert_equal_to_plain(setup, cfg, h, w)["histogram"] == "shared"


def test_model_scatter_order_and_blocks_do_not_matter():
    """Other scatter orders and block counts give the same lists."""
    setup, w, h = crowded_scene()
    cfg = tr.RasterConfig(caps=(4000, 8, 64, 3000), bin_block=8, l0_window=(5, 2))
    runs = [model_binning(setup, cfg, h, w, seed=s, n_blocks=b, words=256)[0]
            for s, b in ((0, 7), (1, 1), (2, 132))]
    for other in runs[1:]:
        for a, b in zip(runs[0].cand + runs[0].face_cand, other.cand + other.face_cand):
            assert torch.equal(a, b)


@pytest.mark.parametrize("b", [1, 3, 7, 8, 32, 100, 128, 512, 2048, 4095])
def test_float_reciprocal_floor_division_is_exact(b):
    """The kernels' window rule divides 0 <= a < 2^22 by a tile size as
    ``int(float(a) * (1 / b))`` (float32, each product rounded once) then
    one integer correction either way: exactly ``a // b``."""
    a = np.arange(1 << 22, dtype=np.int64)
    q = (a.astype(np.float32) * (np.float32(1) / np.float32(b))).astype(np.int64)
    q = np.where(q * b > a, q - 1, np.where((q + 1) * b <= a, q + 1, q))
    np.testing.assert_array_equal(q, a // b)


@pytest.mark.parametrize("name,value", [
    ("kMaxSharedBins", MAX_SHARED_BINS), ("kMidSortMax", WARP_SORT_MAX),
    ("kBitmapWords", BITMAP_WORDS)])
def test_model_constants_are_the_kernels(name, value):
    """The model's shared-histogram size, warp sort length and bitmap
    window are the kernel source's own constants."""
    found = re.findall(rf"constexpr int {name} = (\d+);", KERNEL_SOURCE.read_text())
    assert found == [str(value)]
