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
   whose near faces fill the L2 and global candidate lists;
3. the main path: ``TexturedMesh.aggregate_projected_images`` over 8 4K
   views (6 pinhole, 2 Brown-Conrady) of seeded one-hot labels, with
   every kernel's launch count, then view 0 re-run through the plain
   versions (bit for bit) and a small scene held against the numpy
   brute-force oracle; then each stage of one view's device chain timed
   alone (breakdown).

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
nonzero before printing any result.  It imports nothing of JAX or of the
JAX package.
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
from geograypher_tpu_torch.ops import face_counts, raster_tiles
from geograypher_tpu_torch.ops.rasterize import (
    RasterConfig,
    bin_triangles,
    binned_face_lists,
    fused_view_class_counts,
    rasterize_triangles,
    setup_from_soa,
)
from geograypher_tpu_torch.utils.fixtures import (
    brute_force_pix2face,
    gather_tri_verts,
    make_grid_mesh,
    nadir_camera,
    oblique_camera,
)

N_CLASSES = 10
H, W = 2160, 3840
CAP_MARGIN = 1.25  # caps = ceil(census max x margin) + 8 slots
ORACLE_MIN_AGREE = 0.99  # f32 kernel vs the float64 oracle: knife-edge pixels


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


def _cuda_ms(fn, runs=5):
    """Median milliseconds of ``fn`` over ``runs`` timed calls (CUDA
    events, one untimed warm-up call first)."""
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
    return statistics.median(times)


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
    """Per-level exact census max over ``setups`` and the caps it sizes."""
    census = torch.stack(
        [bin_triangles(s, cfg, H, W, return_census=True) for s in setups]
    ).amax(0).tolist()
    return census, tuple(int(math.ceil(m * CAP_MARGIN)) + 8 for m in census)


def _kernel_vs_plain(name, setup, cfg, n_faces, cls):
    """Both kernels against their plain versions on one view, bit for
    bit, and the median times of all four."""
    binned = bin_triangles(setup, cfg, H, W)
    if int(binned.overflow):
        raise RuntimeError(f"{name}: caps {cfg.caps} overflow ({int(binned.overflow)})")
    cand, counts = binned_face_lists(binned, cfg)
    planes = setup.planes.contiguous()
    p2f = raster_tiles.raster_tiles(planes, cand, counts, cfg, H, W)
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
    row = dict(
        view=name, bin_block=cfg.bin_block,
        census=bin_triangles(setup, cfg, H, W, return_census=True).tolist(),
        caps=list(cfg.caps),
        coverage=round((p2f >= 0).float().mean().item(), 6),
        list_entries=[int(c.sum()) for c in counts],
        raster_max_abs_err=int((p2f - p2f_plain).abs().max()),
        counts_max_abs_err=int((cnt - cnt_plain).abs().max()),
        raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
            planes, cand, counts, cfg, H, W)),
        raster_plain_ms=_cuda_ms(lambda: raster_tiles.raster_tiles_plain(
            planes, cand, counts, cfg, H, W)),
        counts_ms=_cuda_ms(lambda: face_counts.face_class_counts(
            p2f, cls, n_faces, N_CLASSES)),
        counts_plain_ms=_cuda_ms(lambda: face_counts.face_class_counts_plain(
            p2f, cls, n_faces, N_CLASSES)),
    )
    _line(2, **row)
    return row


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

    # -- phase 3: the main path ---------------------------------------------------
    labels = rng.integers(0, N_CLASSES, (len(cams), H, W), dtype=np.int8)
    seg_cams = SegmentorCameraSet(cams, LabelSegmentor(labels, N_CLASSES))
    raster_tiles.launches = 0
    face_counts.launches = 0
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
    p2f_k = raster_tiles.raster_tiles(planes0, cand0, counts0, cfg, H, W)
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
        p2f_i = raster_tiles.raster_tiles(s_i.planes, cand_i, counts_i, cfg, H, W)
        cls_i = cls_host.to(dev)
        _line("breakdown", view=i, distorted=use_dist,
              h2d_class_image_ms=_cuda_ms(lambda: cls_host.to(dev)),
              setup_ms=_cuda_ms(setup_i),
              binning_ms=_cuda_ms(lambda: binned_face_lists(
                  bin_triangles(s_i, cfg, H, W), cfg)),
              raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                  s_i.planes, cand_i, counts_i, cfg, H, W)),
              counts_ms=_cuda_ms(lambda: face_counts.face_class_counts(
                  p2f_i, cls_i, n_faces, N_CLASSES)),
              fused_chain_ms=_cuda_ms(lambda: fused_view_class_counts(
                  soa, b.world_to_cam[0], b.f[0], b.distortion[0], b.cx[0],
                  b.cy[0], cls_i, W, H, cfg, soa.shape[1], N_CLASSES, use_dist)),
              list_entries=[int(c.sum()) for c in counts_i])
    _line("done", total_s=round(time.perf_counter() - t_start, 3))

    sources = {
        "raster_tiles": ("geograypher_tpu_torch/csrc/raster_tiles.cu",
                         "geograypher_tpu/ops/pallas_raster.py:524"),
        "face_class_counts": ("geograypher_tpu_torch/csrc/face_class_counts.cu",
                              "geograypher_tpu/ops/agg_tiled.py:895"),
    }
    key = {"raster_tiles": "raster", "face_class_counts": "counts"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": max(r[f"{key[name]}_max_abs_err"] for r in rows),
         # the main path's configuration: the first two phase-2 views
         "ms": statistics.mean(r[f"{key[name]}_ms"] for r in rows[:2]),
         "plain_ms": statistics.mean(r[f"{key[name]}_plain_ms"] for r in rows[:2])}
        for name, (src, rep) in sources.items()
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
