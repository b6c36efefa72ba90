"""Drive the PyTorch port's aggregation path once on one CUDA card.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):

0. the card's name and power limit (nvidia-smi), torch and CUDA versions;
1. build the CUDA kernels from ``geograypher_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, bit for
   bit, on the 999,698-face bench grid mesh at 3840x2160: a nadir view
   (f=2000) and an oblique view (f=2600, pitch 30 deg) at the main path's
   configuration, the nadir view again at ``bin_block=8`` (the
   configuration of the TPU's 8-face-unit fold), and a low oblique view
   whose near faces fill the L2 and global candidate lists; then a
   knife-edge probe (``knife_edge_triangles``: vertices on and within
   1e-4 px of pixel centres, axis-aligned edges, slivers, edges longer
   than 2^18 px) through both rasters at the main and the level-S
   configurations;
3. the main path: ``TexturedMesh.aggregate_projected_images`` over 8 4K
   views (6 pinhole, 2 Brown-Conrady) of seeded one-hot labels, with
   every kernel's launch count, then view 0 re-run through the plain
   versions (bit for bit) and a small scene held against the numpy
   brute-force oracle; then each stage of one view's device chain timed
   alone (breakdown);
4. level S: the sub-tile raster configuration (``bin_block=8``,
   ``subtile=(8, 16)``) -- its three kernels against their plain versions
   on the nadir and oblique 4K views, bit for bit; the S path of
   ``aggregate_projected_images`` over the same 8 views with every
   kernel's launch count; view 0's pix2face with level S on against the
   same configuration with it off; the unfused counts
   (``ops/agg_tiled.py``) on view 0's pix2face; and the stage breakdown
   of views 0/1/6 with level S on and off.

The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is a JSON object
of per-kernel results, each with its time, its plain version's time, the
least time the card could take for the same work (``bound_ms``) and,
where one PyTorch call computes the same function, that call's time.
Without a CUDA device it exits nonzero before printing any result.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.kernels import build
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops import face_counts, raster_tiles, subtile
from geograypher_tpu_torch.ops.agg_tiled import project_image_class_counts_tiled
from geograypher_tpu_torch.ops.rasterize import (
    RasterConfig,
    bin_all,
    bin_triangles,
    binned_face_lists,
    fused_view_class_counts,
    rasterize_setup,
    rasterize_triangles,
    setup_from_soa,
    setup_triangles,
)
from geograypher_tpu_torch.utils.fixtures import (
    brute_force_pix2face,
    gather_tri_verts,
    knife_edge_triangles,
    make_grid_mesh,
    nadir_camera,
    oblique_camera,
)

N_CLASSES = 10
H, W = 2160, 3840
CAP_MARGIN = 1.25  # caps = ceil(census max x margin) + 8 slots
ORACLE_MIN_AGREE = 0.99  # f32 kernel vs the float64 oracle: knife-edge pixels
S_MIN_AGREE = 0.9999  # level S on vs off: only exact cross-group 1/z ties differ
# the least time of a kernel's work on one H100 SXM (NVIDIA's data
# sheet): FP32 outside the tensor cores, HBM rate
FP32_FLOP_S = 67e12
HBM_BYTES_S = 3.35e12
# a candidate-pixel evaluation: 3 edge planes + the 1/z plane, each
# (a*x + b*y) + c, two multiplies and two adds
FLOP_PER_CAND_PIXEL = 16
# the replaced TPU kernels (function, file:line of its definition)
TPU_KERNELS = {
    "B1": "geograypher_tpu/ops/pallas_raster.py:524",
    "B2": "geograypher_tpu/ops/agg_tiled.py:1000",
    "B3": "geograypher_tpu/ops/agg_tiled.py:895",
    "B4": "geograypher_tpu/ops/agg_tiled.py:155",
    "B5": "geograypher_tpu/ops/subtile.py:352",
    "B6": "geograypher_tpu/ops/subtile.py:570",
}


class LabelSegmentor:
    """In-memory integer label images by camera index, served as the
    float32 one-hot (H, W, C) stacks a segmentation model emits."""

    needs_image = False

    def __init__(self, labels: np.ndarray, num_classes: int):
        self.labels = labels
        self.num_classes = num_classes
        self._eye = np.eye(num_classes, dtype=np.float32)

    def segment_image(self, image, filename=None, image_scale: float = 1.0,
                      index=None, **kwargs):
        return self._eye[self.labels[index]]


def _line(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _cuda_times(fn, runs=5):
    """Milliseconds of ``fn`` in ``runs`` timed calls (CUDA events, one
    untimed warm-up call first)."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _cuda_ms(fn, runs=5):
    """Median milliseconds of ``fn`` over ``runs`` timed calls."""
    return statistics.median(_cuda_times(fn, runs))


def _ab_ms(fn_a, fn_b, runs=5):
    """Medians of two versions timed in turns a, b, b, a (``runs`` calls
    each turn), and the spread (max - min of the turn medians) of each."""
    ta1, tb1, tb2, ta2 = (statistics.median(_cuda_times(f, runs))
                          for f in (fn_a, fn_b, fn_b, fn_a))
    return ((ta1 + ta2) / 2, abs(ta1 - ta2)), ((tb1 + tb2) / 2, abs(tb1 - tb2))


def _profile(fn, runs=5):
    """``fn`` run ``runs`` times under ``torch.profiler`` after a warm-up:
    (device busy share of the window, {kernel: device ms per run}, top
    10), or (None, {}) when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(runs):
                fn()
            end.record()
            end.synchronize()
    except RuntimeError:  # a card without profiler access: not measured
        return None, {}
    wall_ms = start.elapsed_time(end)
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key[:60]
            kernels[name] = kernels.get(name, 0.0) + us / 1e3 / runs
    if not kernels:
        return None, {}
    busy = sum(kernels.values()) * runs / wall_ms
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    return busy, top


def _bound(n_bytes, n_flop):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the FP32 operations over the FP32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_flop / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _box_pixels(setup, faces=None):
    """The candidate-pixels a view's data needs: every valid face (of the
    mask ``faces``, when given) evaluated over the pixels of its own box,
    which ``setup.bbox`` holds clipped to the image."""
    py0, px0, py1, px1 = (setup.bbox[k].long() for k in range(4))
    keep = setup.valid if faces is None else setup.valid & faces
    return int(torch.where(keep, (py1 - py0 + 1) * (px1 - px0 + 1), 0).sum())


def _raster_bound(setup, planes, cand, counts, cfg, s_init=None, s_mask8=None):
    """The tile raster's bound on this view: each face of the tile lists
    (those level S did not take, ``s_mask8``) over its own box; each
    input read once, the pix2face written once.  Also the candidate-pixels
    the kernel evaluates (every group candidate over the warp rectangles
    its cull box meets, ``raster_tiles.kernel_cand_pixels``) and what
    whole tiles would cost: every L0 tile's in-image pixels against its
    own, its L1 and L2 parents' and the global list's counts."""
    th, tw = cfg.tile_h, cfg.tile_w
    nty0, ntx0 = cfg.grids(H, W)[0]
    p1, p2 = raster_tiles._parents(cfg, H, W, planes.device)
    n = (counts[0].long() + counts[1].long()[p1] + counts[2].long()[p2]
         + counts[3].long())
    t = torch.arange(nty0 * ntx0, device=planes.device)
    pix = ((H - t // ntx0 * th).clamp(max=th) * (W - t % ntx0 * tw).clamp(max=tw))
    tile_pixels = int((n * pix).sum())
    cand_pixels = raster_tiles.kernel_cand_pixels(planes, setup.bbox, cand, counts,
                                                  cfg, H, W)
    listed = (None if s_mask8 is None
              else ~s_mask8.repeat_interleave(cfg.bin_block))
    need_pixels = _box_pixels(setup, listed)
    n_bytes = (planes.numel() * 4 + sum(c.numel() * 4 for c in cand)
               + sum(c.numel() * 4 for c in counts) + H * W * 4
               + (0 if s_init is None else 2 * H * W * 4))
    return (_bound(n_bytes, FLOP_PER_CAND_PIXEL * need_pixels), need_pixels,
            cand_pixels, tile_pixels)


def _s_raster_bound(setup, su, cfg):
    """The sub-tile raster's bound: each face level S took over its own
    box; the CSR lists (``bin_subtiles``, built here untimed) and the S
    units' plane rows read once, both (H, W) planes written once.  Also
    the candidate-pixels the kernel evaluates (each S face over its
    domain, ``subtile.s_face_domains``) and what every S face slot over
    its sub-tiles' pixels would cost."""
    sb = subtile.bin_subtiles(setup, cfg, H, W)
    sh, sw = cfg.subtile
    _, nsx = subtile.subtile_grid(cfg, H, W)
    sub = sb.sub_ids.long()
    pix = ((H - sub // nsx * sh).clamp(max=sh) * (W - sub % nsx * sw).clamp(max=sw))
    subtile_pixels = int((sb.sub_count.long() * cfg.s_block * pix).sum())
    dom = subtile.s_face_domains(su, setup, cfg, H, W)
    cand_pixels = int(((dom[:, 2] - dom[:, 0] + 1).clamp(min=0)
                       * (dom[:, 3] - dom[:, 1] + 1).clamp(min=0)).sum())
    need_pixels = _box_pixels(setup, sb.s_mask8.repeat_interleave(cfg.bin_block))
    n_units = int(torch.unique(sb.units).numel())
    n_bytes = (4 * (sb.units.numel() + 3 * sb.sub_ids.numel())
               + n_units * cfg.s_block * 48 + 2 * H * W * 4)
    return (_bound(n_bytes, FLOP_PER_CAND_PIXEL * need_pixels), need_pixels,
            cand_pixels, subtile_pixels, sb)


def _counts_bound(n_faces):
    """The counts kernel's bound: pix2face and class image read, the
    (F, C) int32 counts written."""
    return _bound(2 * H * W * 4 + n_faces * N_CLASSES * 4, 0)


def _counts_library_ms(p2f, cls, n_faces):
    """One ``torch.bincount`` over the flat (face, class) key, background
    shifted into the first C bins; the port never calls it."""
    key = ((p2f.long() + 1) * N_CLASSES + cls.long()).reshape(-1)
    return _cuda_ms(lambda: torch.bincount(key, minlength=(n_faces + 1) * N_CLASSES))


def _knife_edge(a, b):
    """(agreement, face-vs-background disagreements) of two pix2face
    maps; the oracle contract wants >= 99% agreement and every
    disagreement a swap between two faces."""
    diff = a != b
    bg = diff & ((a < 0) | (b < 0))
    return 1.0 - diff.float().mean().item(), int(bg.sum())


def _suite_cameras(focals=(2000.0, 2600.0), n_views=8):
    """The bench's mixed suite: even views nadir with seeded jitter, odd
    views oblique at 15-35 deg off nadir, alternating focal lengths."""
    rng = np.random.default_rng(0)
    c2ws = []
    for k in range(n_views):
        focal = focals[k % len(focals)]
        if k % 2 == 0:
            c2w = nadir_camera(4.0, focal, W)
            c2w[0, 3] += rng.uniform(-0.3, 0.3)
            c2w[1, 3] += rng.uniform(-0.3, 0.3)
            c2w[2, 3] += rng.uniform(0.0, 0.3)
        else:
            c2w = oblique_camera(
                4.0, focal, W,
                pitch_deg=float(rng.uniform(15.0, 35.0)),
                azimuth_deg=float(360.0 * k / n_views),
            )
        c2ws.append(c2w)
    return c2ws


def _census_caps(setups, cfg):
    """Per-level exact census max over ``setups`` and the caps it sizes
    (with level S on, of the L0..L3 lists after its diversion)."""
    census = torch.stack([
        bin_triangles(s, cfg, H, W, return_census=True,
                      exclude_blocks=None if cfg.subtile is None
                      else subtile.subtile_mask8(s, cfg))
        for s in setups
    ]).amax(0).tolist()
    return census, tuple(int(math.ceil(m * CAP_MARGIN)) + 8 for m in census)


def _kernel_vs_plain(name, setup, cfg, n_faces, cls):
    """Both kernels against their plain versions on one view, bit for
    bit, and the median times of all four."""
    binned = bin_triangles(setup, cfg, H, W)
    if int(binned.overflow):
        raise RuntimeError(f"{name}: caps {cfg.caps} overflow ({int(binned.overflow)})")
    cand, counts = binned_face_lists(binned, cfg)
    planes, bbox = setup.planes.contiguous(), setup.bbox
    p2f = raster_tiles.raster_tiles(planes, bbox, cand, counts, cfg, H, W)
    p2f_plain = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, H, W)
    torch.cuda.synchronize()
    if not torch.equal(p2f, p2f_plain):
        agree, bg = _knife_edge(p2f, p2f_plain)
        raise RuntimeError(
            f"raster kernel vs plain on {name}: {int((p2f != p2f_plain).sum())} "
            f"pixels differ (agreement {agree:.6f}, {bg} face-vs-background)"
        )
    cnt = face_counts.face_class_counts(p2f, cls, n_faces, N_CLASSES)
    cnt_plain = face_counts.face_class_counts_plain(p2f, cls, n_faces, N_CLASSES)
    if not torch.equal(cnt, cnt_plain):
        raise RuntimeError(
            f"counts kernel vs plain on {name}: max |diff| "
            f"{int((cnt - cnt_plain).abs().max())}"
        )
    (raster_bound_ms, raster_bound_by), need_pixels, cand_pixels, tile_pixels = (
        _raster_bound(setup, planes, cand, counts, cfg))
    counts_bound_ms, counts_bound_by = _counts_bound(n_faces)
    row = dict(
        view=name, bin_block=cfg.bin_block,
        census=bin_triangles(setup, cfg, H, W, return_census=True).tolist(),
        caps=list(cfg.caps),
        coverage=round((p2f >= 0).float().mean().item(), 6),
        list_entries=[int(c.sum()) for c in counts],
        raster_max_abs_err=int((p2f - p2f_plain).abs().max()),
        counts_max_abs_err=int((cnt - cnt_plain).abs().max()),
        raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
            planes, bbox, cand, counts, cfg, H, W)),
        raster_plain_ms=_cuda_ms(lambda: raster_tiles.raster_tiles_plain(
            planes, cand, counts, cfg, H, W)),
        counts_ms=_cuda_ms(lambda: face_counts.face_class_counts(
            p2f, cls, n_faces, N_CLASSES)),
        counts_plain_ms=_cuda_ms(lambda: face_counts.face_class_counts_plain(
            p2f, cls, n_faces, N_CLASSES)),
        counts_library_ms=_counts_library_ms(p2f, cls, n_faces),
        raster_cand_pixels=cand_pixels, raster_tile_cand_pixels=tile_pixels,
        raster_need_pixels=need_pixels,
        raster_bound_ms=raster_bound_ms, raster_bound_by=raster_bound_by,
        counts_bound_ms=counts_bound_ms, counts_bound_by=counts_bound_by,
    )
    _line(2, **row)
    return row


def _s_kernels_vs_plain(name, setup, cfg, n_faces, cls):
    """Level S on one view: the sub-tile raster, the S-seeded tile raster
    and the counts kernel against their plain versions, bit for bit, and
    the median times of all six."""
    binned, su = bin_all(setup, cfg, H, W)
    if int(binned.overflow):
        raise RuntimeError(f"{name}: S caps {cfg.caps} overflow ({int(binned.overflow)})")
    cand, counts = binned_face_lists(binned, cfg)
    planes, bbox = setup.planes.contiguous(), setup.bbox
    (s_bound_ms, s_bound_by), s_need_pixels, s_cand_pixels, s_sub_pixels, sb = (
        _s_raster_bound(setup, su, cfg))
    s_w, s_id = subtile.s_raster(su, setup, cfg, H, W)
    s_w_p, s_id_p = subtile.s_raster_plain(sb, planes, cfg, H, W)
    torch.cuda.synchronize()
    if not (torch.equal(s_w, s_w_p) and torch.equal(s_id, s_id_p)):
        raise RuntimeError(
            f"s_raster vs plain on {name}: {int((s_id != s_id_p).sum())} ids and "
            f"{int((s_w != s_w_p).sum())} depths differ")
    s_init = (s_w, s_id)
    p2f = raster_tiles.raster_tiles(planes, bbox, cand, counts, cfg, H, W,
                                    s_init=s_init)
    p2f_plain = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, H, W,
                                                s_init=s_init)
    torch.cuda.synchronize()
    if not torch.equal(p2f, p2f_plain):
        agree, bg = _knife_edge(p2f, p2f_plain)
        raise RuntimeError(
            f"S-seeded raster vs plain on {name}: {int((p2f != p2f_plain).sum())} "
            f"pixels differ (agreement {agree:.6f}, {bg} face-vs-background)")
    cnt = face_counts.face_class_counts(p2f, cls, n_faces, N_CLASSES)
    cnt_plain = face_counts.face_class_counts_plain(p2f, cls, n_faces, N_CLASSES)
    if not torch.equal(cnt, cnt_plain):
        raise RuntimeError(f"counts kernel vs plain on {name} (level S): max |diff| "
                           f"{int((cnt - cnt_plain).abs().max())}")
    (r_bound_ms, r_bound_by), r_need_pixels, r_cand_pixels, r_tile_pixels = (
        _raster_bound(setup, planes, cand, counts, cfg, s_init, su.s_mask8))
    row = dict(
        view=name, bin_block=cfg.bin_block, subtile=list(cfg.subtile),
        caps=list(cfg.caps), list_entries=[int(c.sum()) for c in counts],
        s_pairs=int(subtile.subtile_pairs(su)), s_occupied=int(sb.sub_ids.numel()),
        s_diverted_blocks=int(su.s_mask8.sum()),
        s_covered=round((s_id >= 0).float().mean().item(), 6),
        coverage=round((p2f >= 0).float().mean().item(), 6),
        s_raster_max_abs_err=max(int((s_id - s_id_p).abs().max()),
                                 int((s_w != s_w_p).sum())),
        raster_max_abs_err=int((p2f - p2f_plain).abs().max()),
        counts_max_abs_err=int((cnt - cnt_plain).abs().max()),
        s_raster_ms=_cuda_ms(lambda: subtile.s_raster(su, setup, cfg, H, W)),
        s_raster_plain_ms=_cuda_ms(
            lambda: subtile.s_raster_plain(sb, planes, cfg, H, W)),
        raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
            planes, bbox, cand, counts, cfg, H, W, s_init=s_init)),
        raster_plain_ms=_cuda_ms(lambda: raster_tiles.raster_tiles_plain(
            planes, cand, counts, cfg, H, W, s_init=s_init)),
        counts_ms=_cuda_ms(lambda: face_counts.face_class_counts(
            p2f, cls, n_faces, N_CLASSES)),
        counts_plain_ms=_cuda_ms(lambda: face_counts.face_class_counts_plain(
            p2f, cls, n_faces, N_CLASSES)),
        counts_library_ms=_counts_library_ms(p2f, cls, n_faces),
        s_cand_pixels=s_cand_pixels, s_subtile_cand_pixels=s_sub_pixels,
        raster_cand_pixels=r_cand_pixels, raster_tile_cand_pixels=r_tile_pixels,
        s_need_pixels=s_need_pixels, raster_need_pixels=r_need_pixels,
        s_raster_bound_ms=s_bound_ms, s_raster_bound_by=s_bound_by,
        raster_bound_ms=r_bound_ms, raster_bound_by=r_bound_by,
    )
    _line("2s", **row)
    return row


def _knife_edge_probe(cls, dev):
    """Phase 2's knife-edge probe at 4K: ``knife_edge_triangles`` (vertices
    on and within 1e-4 px of pixel centres, axis-aligned edges through
    them, slivers, edges longer than 2^18 px), both rasters bit-equal to
    their plain versions at the main configuration (``bin_block=1``) and
    at the level-S configuration."""
    tri = torch.as_tensor(knife_edge_triangles(W, H), device=dev)
    setup = setup_triangles(tri, torch.tensor(1.0, device=dev), W, H)
    n = tri.shape[0]
    long_edges = int((setup.valid & (setup.planes[:, [0, 1, 3, 4, 6, 7]].abs()
                                     .amax(dim=1) > 2.0**18)).sum())
    if long_edges == 0:
        raise RuntimeError("knife-edge probe: no valid face with an edge over 2^18 px")
    cfg = RasterConfig()
    cfg = dataclasses.replace(cfg, caps=_census_caps([setup], cfg)[1])
    _kernel_vs_plain("knife_edge", setup, cfg, n, cls)
    base = RasterConfig(bin_block=8, l0_window=(5, 2))
    cfg_s = dataclasses.replace(base, subtile=(8, 16), s_window=(3, 2), s_block=4)
    cfg_s = dataclasses.replace(cfg_s, caps=_census_caps([setup], cfg_s)[1])
    _s_kernels_vs_plain("knife_edge", setup, cfg_s, n, cls)
    _line("knife_edge", faces=n, valid=int(setup.valid.sum()),
          long_edge_faces=long_edges,
          exempt_faces=int((raster_tiles.cull_rule(setup.planes, H, W)
                            == raster_tiles.CULL_EXEMPT).sum()),
          raster_equal=True, s_raster_equal=True, s_carry_equal=True)


def _probe_setup(soa, c2w, f, cfg):
    w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                          device=soa.device)
    return setup_from_soa(soa, w2c, torch.tensor(f, device=soa.device), W, H,
                          cfg.znear)


def main():
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
            "is False"
        )
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 0: the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _line(0, card=smi, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    # -- phase 1: build the kernels ---------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log = (build.BUILD_DIR / "nvcc.log").read_text().splitlines()
    _line(1, build_s=round(time.perf_counter() - t0, 3),
          nvcc_s=round(build.last_build_seconds, 3),
          ptxas=[ln.strip() for ln in log if "registers" in ln or "spill" in ln])

    # -- the bench-scale mesh and the views --------------------------------------
    verts, faces = make_grid_mesh(
        n=708, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y)
    )
    mesh = TexturedMesh((verts, faces), raster_config=RasterConfig(), device=dev)
    mesh.spatial_sort_faces()
    n_faces = mesh.n_faces

    c2ws = _suite_cameras()
    dist = {"k1": 0.02, "k2": -0.01, "p1": 1e-3}
    # two lens models (pinhole, Brown-Conrady), each at the two focals
    sensors = {
        2 * d + j: {"f": fl, "cx": 0.0, "cy": 0.0, "image_width": W,
                    "image_height": H,
                    **({"distortion_params": dist} if d else {})}
        for d in (0, 1) for j, fl in enumerate((2000.0, 2600.0))
    }
    sensor_ids = [2 * (k >= 6) + (k % 2) for k in range(len(c2ws))]
    cams = CameraSet(c2ws, sensors, sensor_IDs=sensor_ids)

    # main-path caps from the exact census over every view they serve
    cfg = mesh.raster_config
    soa = mesh._tri_soa_device(cams, cfg.bin_block)
    setups = []
    for i in range(len(cams)):
        b = cams.get_camera_batch([i], device=dev)
        use_dist = mesh._resolve_distortion(cams, i, None)
        setups.append(setup_from_soa(
            soa, b.world_to_cam[0], b.f[0], W, H, cfg.znear,
            distortion=(b.distortion[0], b.cx[0], b.cy[0]) if use_dist else None,
        ))
    nadir_c2w = nadir_camera(4.0, 2000.0, W)
    probes = [
        ("nadir_f2000", _probe_setup(soa, nadir_c2w, 2000.0, cfg)),
        ("oblique_f2600_p30", _probe_setup(
            soa, oblique_camera(4.0, 2600.0, W, pitch_deg=30.0, azimuth_deg=45.0),
            2600.0, cfg)),
    ]
    census, caps = _census_caps(setups + [s for _, s in probes], cfg)
    cfg = dataclasses.replace(cfg, caps=caps)
    mesh.raster_config = cfg
    overflow = sum(int(bin_triangles(s, cfg, H, W).overflow) for s in setups)
    if overflow:
        raise RuntimeError(f"census-sized caps {caps} still overflow ({overflow})")
    _line("setup", faces=n_faces, census=census, caps=list(caps),
          cap_margin=CAP_MARGIN, overflow=overflow,
          seconds=round(time.perf_counter() - t_start, 3))

    # -- phase 2: each kernel against its plain version ----------------------------
    rng = np.random.default_rng(0)
    cls = torch.as_tensor(rng.integers(0, N_CLASSES, (H, W), dtype=np.int32),
                          device=dev)
    rows = [_kernel_vs_plain(name, s, cfg, n_faces, cls) for name, s in probes]
    # bin_block=8: faces ride along in 8-face units (padded mesh, own caps)
    cfg8 = dataclasses.replace(RasterConfig(), bin_block=8,
                               global_from=cfg.global_from)
    soa8 = mesh._tri_soa_device(cams, 8)
    setup8 = _probe_setup(soa8, nadir_c2w, 2000.0, cfg8)
    _, caps8 = _census_caps([setup8], cfg8)
    rows.append(_kernel_vs_plain("nadir_f2000", setup8,
                                 dataclasses.replace(cfg8, caps=caps8),
                                 soa8.shape[1], cls))
    # a low oblique view: its near faces span more than an L1 window
    # (L2 list) or an L2 window (global list), so the kernel's third
    # group runs at 4K
    near = _probe_setup(
        soa, oblique_camera(0.1, 2000.0, W, pitch_deg=60.0, azimuth_deg=0.0),
        2000.0, cfg)
    census_near, caps_near = _census_caps([near], cfg)
    if census_near[2] == 0 or census_near[3] == 0:
        raise RuntimeError(f"near probe census {census_near}: no L2 or global "
                           "candidates")
    rows.append(_kernel_vs_plain("near_oblique_p60", near,
                                 dataclasses.replace(cfg, caps=caps_near),
                                 n_faces, cls))
    # vertices on pixel centres, slivers, edges over 2^18 px: both
    # redesigned rasters against their plain versions
    _knife_edge_probe(cls, dev)

    # -- phase 3: the main path ---------------------------------------------------
    labels = rng.integers(0, N_CLASSES, (len(cams), H, W), dtype=np.int8)
    seg_cams = SegmentorCameraSet(cams, LabelSegmentor(labels, N_CLASSES))
    raster_tiles.launches = face_counts.launches = subtile.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    avg, info = mesh.aggregate_projected_images(seg_cams)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"raster_tiles": raster_tiles.launches,
                "face_class_counts": face_counts.launches}
    for name, n in launches.items():
        if n < len(cams):
            raise RuntimeError(f"{name} launched {n} times for {len(cams)} views")
    seen = info["projection_counts"] > 0
    if avg.shape != (n_faces, N_CLASSES) or not np.isfinite(avg[seen]).all():
        raise RuntimeError(f"bad aggregate: shape {avg.shape}")
    if not np.isnan(avg[~seen]).all():
        raise RuntimeError("unseen faces must be NaN")
    if seen.mean() <= 0.5:
        raise RuntimeError(f"only {seen.mean():.3f} of faces were seen")
    frac_err = float(np.abs(avg[seen].sum(axis=1) - 1.0).max())
    if frac_err > 1e-5:
        raise RuntimeError(f"class fractions of seen faces sum off 1 by {frac_err}")
    # host label preparation alone, for the breakdown
    t1 = time.perf_counter()
    img0 = seg_cams.get_image_by_index(0)
    t2 = time.perf_counter()
    cls0 = mesh._as_class_image(img0)
    t3 = time.perf_counter()
    _line(3, views=len(cams), seconds=round(dt, 4),
          views_per_s=round(len(cams) / dt, 4), launches=launches,
          seen_frac=round(float(seen.mean()), 6), frac_sum_err=frac_err,
          overflow=overflow, peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
          host_segment_s=round(t2 - t1, 4), host_class_image_s=round(t3 - t2, 4),
          card=smi)

    # view 0 again: the fused chain against the plain versions, bit for bit
    b0 = cams.get_camera_batch([0], device=dev)
    cls0 = torch.as_tensor(cls0, device=dev)
    counts_k, over0, _ = fused_view_class_counts(
        soa, b0.world_to_cam[0], b0.f[0], b0.distortion[0], b0.cx[0],
        b0.cy[0], cls0, W, H, cfg, soa.shape[1], N_CLASSES, False)
    setup0 = setup_from_soa(soa, b0.world_to_cam[0], b0.f[0], W, H, cfg.znear)
    cand0, counts0 = binned_face_lists(bin_triangles(setup0, cfg, H, W), cfg)
    planes0 = setup0.planes.contiguous()
    p2f_k = raster_tiles.raster_tiles(planes0, setup0.bbox, cand0, counts0, cfg, H, W)
    p2f_p = raster_tiles.raster_tiles_plain(planes0, cand0, counts0, cfg, H, W)
    counts_p = face_counts.face_class_counts_plain(p2f_p, cls0, soa.shape[1], N_CLASSES)
    if (not torch.equal(p2f_k, p2f_p)
            or not torch.equal(counts_k, counts_p.to(torch.float32))
            or int(over0)):
        raise RuntimeError(
            f"view 0 kernels vs plain: {int((p2f_k != p2f_p).sum())} pixels "
            f"differ, sum|dcounts| {float((counts_k - counts_p).abs().sum())}, "
            f"overflow {int(over0)}"
        )
    # a small scene against the independent numpy brute-force oracle
    sv, sf = make_grid_mesh(n=15, size=4.0,
                            z_fn=lambda x, y: 0.25 * np.sin(2 * x) * np.cos(y))
    sc2w = oblique_camera(4.0, 50.0, 80, pitch_deg=20.0)
    tri = gather_tri_verts(sv, sf)
    w2c = np.linalg.inv(sc2w)
    tri_cam = (tri.reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]).reshape(tri.shape)
    oracle = torch.as_tensor(brute_force_pix2face(tri_cam, 50.0, 80, 80), device=dev)
    small = rasterize_triangles(
        torch.as_tensor(tri_cam, dtype=torch.float32, device=dev), 50.0, 80, 80,
        RasterConfig(caps=(256, 64, 32, 32)))
    agree_s, bg_s = _knife_edge(small, oracle)
    if agree_s < ORACLE_MIN_AGREE or bg_s or not (oracle >= 0).any():
        raise RuntimeError(f"small scene vs oracle: agree {agree_s}, bg {bg_s}")
    _line("check", view0_pixels_differ=0, view0_counts_equal=True,
          oracle_agree=agree_s, oracle_bg_disagree=bg_s)

    # where one view's device time goes: each stage of the fused chain
    # timed alone with CUDA events (launch gaps included)
    cls_host = torch.as_tensor(mesh._as_class_image(seg_cams.get_image_by_index(0)))
    for i in (0, 1, 6):
        b = cams.get_camera_batch([i], device=dev)
        use_dist = mesh._resolve_distortion(cams, i, None)
        dist_args = (b.distortion[0], b.cx[0], b.cy[0]) if use_dist else None

        def setup_i():
            return setup_from_soa(soa, b.world_to_cam[0], b.f[0], W, H,
                                  cfg.znear, distortion=dist_args)

        s_i = setup_i()
        cand_i, counts_i = binned_face_lists(bin_triangles(s_i, cfg, H, W), cfg)
        p2f_i = raster_tiles.raster_tiles(s_i.planes, s_i.bbox, cand_i, counts_i,
                                          cfg, H, W)
        cls_i = cls_host.to(dev)
        _line("breakdown", view=i, distorted=use_dist,
              h2d_class_image_ms=_cuda_ms(lambda: cls_host.to(dev)),
              setup_ms=_cuda_ms(setup_i),
              binning_ms=_cuda_ms(lambda: binned_face_lists(
                  bin_triangles(s_i, cfg, H, W), cfg)),
              raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                  s_i.planes, s_i.bbox, cand_i, counts_i, cfg, H, W)),
              counts_ms=_cuda_ms(lambda: face_counts.face_class_counts(
                  p2f_i, cls_i, n_faces, N_CLASSES)),
              fused_chain_ms=_cuda_ms(lambda: fused_view_class_counts(
                  soa, b.world_to_cam[0], b.f[0], b.distortion[0], b.cx[0],
                  b.cy[0], cls_i, W, H, cfg, soa.shape[1], N_CLASSES, use_dist)),
              list_entries=[int(c.sum()) for c in counts_i])
    # -- phase 4: level S ------------------------------------------------------
    rows_s, launches_s = _level_s(mesh, cams, seg_cams, soa, cls, avg, info,
                                  nadir_c2w, smi)
    _line("done", total_s=round(time.perf_counter() - t_start, 3))

    # one line per kernel: launches are the main paths' (phase 3 and the
    # level-S path); times and bounds are the kernel-vs-plain views at the
    # main path's configuration (phase 2's first two views; level S: its
    # two views at the S configuration)
    def mean(rs, key):
        return statistics.mean(r[key] for r in rs)

    main_rows = rows[:2]
    all_rows = rows + rows_s
    kernels = [
        dict(name="raster_tiles", route="cuda",
             source="geograypher_tpu_torch/csrc/raster_tiles.cu",
             replaces=TPU_KERNELS["B1"],
             launches=launches["raster_tiles"] + launches_s["raster_tiles"],
             max_abs_err=max(r["raster_max_abs_err"] for r in all_rows),
             ms=mean(main_rows, "raster_ms"),
             plain_ms=mean(main_rows, "raster_plain_ms"),
             bound_ms=mean(main_rows, "raster_bound_ms"),
             bound_by=main_rows[0]["raster_bound_by"], library_ms=None),
        dict(name="face_class_counts", route="cuda",
             source="geograypher_tpu_torch/csrc/face_class_counts.cu",
             replaces=", ".join(TPU_KERNELS[k] for k in ("B2", "B3", "B4", "B6")),
             launches=(launches["face_class_counts"]
                       + launches_s["face_class_counts"]),
             max_abs_err=max(r["counts_max_abs_err"] for r in all_rows),
             ms=mean(main_rows, "counts_ms"),
             plain_ms=mean(main_rows, "counts_plain_ms"),
             bound_ms=mean(main_rows, "counts_bound_ms"),
             bound_by=main_rows[0]["counts_bound_by"],
             library_ms=mean(main_rows, "counts_library_ms")),
        dict(name="s_raster", route="cuda",
             source="geograypher_tpu_torch/csrc/s_raster.cu",
             replaces=TPU_KERNELS["B5"], launches=launches_s["s_raster"],
             max_abs_err=max(r["s_raster_max_abs_err"] for r in rows_s),
             ms=mean(rows_s, "s_raster_ms"),
             plain_ms=mean(rows_s, "s_raster_plain_ms"),
             bound_ms=mean(rows_s, "s_raster_bound_ms"),
             bound_by=rows_s[0]["s_raster_bound_by"], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _level_s(mesh, cams, seg_cams, soa, cls, avg, info, nadir_c2w, smi):
    """Phase 4: the level-S configuration on the same mesh and views.
    Returns (kernel-vs-plain rows, the S path's launch counts)."""
    dev = soa.device
    soa8 = mesh._tri_soa_device(cams, 8)  # padded to a multiple of 8
    n_pad = soa8.shape[1]
    base = RasterConfig(bin_block=8, l0_window=(5, 2),
                        global_from=mesh.raster_config.global_from)
    cfg_s = dataclasses.replace(base, subtile=(8, 16), s_window=(3, 2), s_block=4)
    setups = []
    for i in range(len(cams)):
        b = cams.get_camera_batch([i], device=dev)
        use_dist = mesh._resolve_distortion(cams, i, None)
        setups.append(setup_from_soa(
            soa8, b.world_to_cam[0], b.f[0], W, H, base.znear,
            distortion=(b.distortion[0], b.cx[0], b.cy[0]) if use_dist else None,
        ))
    probes = [
        ("nadir_f2000", _probe_setup(soa8, nadir_c2w, 2000.0, base)),
        ("oblique_f2600_p30", _probe_setup(
            soa8, oblique_camera(4.0, 2600.0, W, pitch_deg=30.0, azimuth_deg=45.0),
            2600.0, base)),
    ]
    census_s, caps_s = _census_caps(setups + [s for _, s in probes], cfg_s)
    census_off, caps_off = _census_caps(setups + [s for _, s in probes], base)
    cfg_s = dataclasses.replace(cfg_s, caps=caps_s)
    cfg_off = dataclasses.replace(base, caps=caps_off)
    overflow = sum(int(bin_all(s, cfg_s, H, W)[0].overflow) for s in setups)
    if overflow:
        raise RuntimeError(f"level-S census caps {caps_s} overflow ({overflow})")
    _line("setup_s", padded_faces=n_pad, census_s=census_s, caps_s=list(caps_s),
          census_off=census_off, caps_off=list(caps_off), overflow=overflow)

    # the three kernels against their plain versions, bit for bit
    rows = [_s_kernels_vs_plain(name, s, cfg_s, n_pad, cls) for name, s in probes]

    # the S path through the entry point
    raster_tiles.launches = face_counts.launches = subtile.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg_s, info_s = mesh.aggregate_projected_images(seg_cams, config=cfg_s)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"raster_tiles": raster_tiles.launches,
                "face_class_counts": face_counts.launches,
                "s_raster": subtile.launches}
    for name, n in launches.items():
        if n < len(cams):
            raise RuntimeError(f"level S: {name} launched {n} times for "
                               f"{len(cams)} views")
    seen = info_s["projection_counts"] > 0
    if avg_s.shape != avg.shape or not np.isfinite(avg_s[seen]).all():
        raise RuntimeError(f"level S: bad aggregate, shape {avg_s.shape}")
    if not np.isnan(avg_s[~seen]).all():
        raise RuntimeError("level S: unseen faces must be NaN")
    frac_err = float(np.abs(avg_s[seen].sum(axis=1) - 1.0).max())
    if frac_err > 1e-5:
        raise RuntimeError(f"level S: class fractions sum off 1 by {frac_err}")
    # against the main path (level S off, bin_block=1): the pix2face maps
    # differ only on exact 1/z ties, so nearly every face's counts agree
    same_counts = float((info_s["summed_projections"]
                         == info["summed_projections"]).all(axis=1).mean())
    if same_counts < 0.99:
        raise RuntimeError(f"level S vs main path: only {same_counts} of faces "
                           "have equal counts")
    _line(4, views=len(cams), seconds=round(dt, 4),
          views_per_s=round(len(cams) / dt, 4), launches=launches,
          seen_frac=round(float(seen.mean()), 6), frac_sum_err=frac_err,
          overflow=overflow, faces_equal_to_main_path=same_counts, card=smi)

    # view 0: level S on against off, and the unfused counts (B4's
    # counterpart) on its pix2face
    p2f_on, binned_on = rasterize_setup(setups[0], cfg_s, H, W)
    p2f_off, binned_off = rasterize_setup(setups[0], cfg_off, H, W)
    agree, bg = _knife_edge(p2f_on, p2f_off)
    if agree < S_MIN_AGREE or bg or int(binned_on.overflow) or int(binned_off.overflow):
        raise RuntimeError(f"view 0 level S on vs off: agreement {agree}, {bg} "
                           "face-vs-background")
    cls0 = torch.as_tensor(mesh._as_class_image(seg_cams.get_image_by_index(0)),
                           device=dev)
    tiled, tiled_over = project_image_class_counts_tiled(
        p2f_on, cls0, binned_on, cfg_s, H, W, n_pad, N_CLASSES)
    tiled_plain = face_counts.face_class_counts_plain(p2f_on, cls0, n_pad, N_CLASSES)
    if not torch.equal(tiled, tiled_plain.to(torch.float32)) or int(tiled_over):
        raise RuntimeError("unfused counts vs plain on view 0 (level S) differ")
    _line("check_s", view0_s_on_off_agree=agree, view0_s_on_off_bg=bg,
          view0_s_on_off_pixels_differ=int((p2f_on != p2f_off).sum()),
          view0_tiled_counts_equal=True,
          tiled_ms=_cuda_ms(lambda: project_image_class_counts_tiled(
              p2f_on, cls0, binned_on, cfg_s, H, W, n_pad, N_CLASSES)),
          tiled_plain_ms=_cuda_ms(lambda: face_counts.face_class_counts_plain(
              p2f_on, cls0, n_pad, N_CLASSES)),
          tiled_library_ms=_counts_library_ms(p2f_on, cls0, n_pad),
          tiled_bound_ms=_counts_bound(n_pad)[0], card=smi)

    # where one view's device time goes with level S on, and at
    # bin_block=8 with it off
    cls_host = cls0.cpu()
    for i in (0, 1, 6):
        b = cams.get_camera_batch([i], device=dev)
        use_dist = mesh._resolve_distortion(cams, i, None)
        s_i = setups[i]
        binned_i, su_i = bin_all(s_i, cfg_s, H, W)
        cand_i, counts_i = binned_face_lists(binned_i, cfg_s)
        planes_i, bbox_i = s_i.planes.contiguous(), s_i.bbox
        init_i = subtile.s_raster(su_i, s_i, cfg_s, H, W)
        cand_o, counts_o = binned_face_lists(bin_triangles(s_i, cfg_off, H, W), cfg_off)
        cls_i = cls_host.to(dev)

        def chain(cfg):
            return fused_view_class_counts(
                soa8, b.world_to_cam[0], b.f[0], b.distortion[0], b.cx[0],
                b.cy[0], cls_i, W, H, cfg, n_pad, N_CLASSES, use_dist)

        (on_ms, on_spread), (off_ms, off_spread) = _ab_ms(
            lambda: chain(cfg_s), lambda: chain(cfg_off))
        if i == 0:
            # device kernels of each chain and the device's busy share of
            # the window (the rest is launch gaps and host work)
            busy_on, top_on = _profile(lambda: chain(cfg_s))
            busy_off, top_off = _profile(lambda: chain(cfg_off))
            _line("profile_s", view=i, s_on_busy_share=busy_on,
                  s_on_kernels_ms=top_on, s_off_busy_share=busy_off,
                  s_off_kernels_ms=top_off, card=smi)
        _line("breakdown_s", view=i, distorted=use_dist,
              s_prep_ms=_cuda_ms(lambda: subtile.subtile_units(s_i, cfg_s)),
              tile_binning_ms=_cuda_ms(lambda: binned_face_lists(bin_triangles(
                  s_i, cfg_s, H, W, exclude_blocks=su_i.s_mask8), cfg_s)),
              s_raster_ms=_cuda_ms(lambda: subtile.s_raster(
                  su_i, s_i, cfg_s, H, W)),
              raster_carry_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                  planes_i, bbox_i, cand_i, counts_i, cfg_s, H, W, s_init=init_i)),
              fused_chain_ms=on_ms, fused_chain_spread_ms=on_spread,
              off_binning_ms=_cuda_ms(lambda: binned_face_lists(
                  bin_triangles(s_i, cfg_off, H, W), cfg_off)),
              off_raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                  planes_i, bbox_i, cand_o, counts_o, cfg_off, H, W)),
              off_fused_chain_ms=off_ms, off_fused_chain_spread_ms=off_spread,
              list_entries=[int(c.sum()) for c in counts_i],
              off_list_entries=[int(c.sum()) for c in counts_o],
              # (sub-tile, unit) pairs and the most units of one sub-tile
              s_census=subtile.subtile_counts_census(s_i, cfg_s, H, W).tolist(),
              card=smi)
    return rows, launches


if __name__ == "__main__":
    main()
