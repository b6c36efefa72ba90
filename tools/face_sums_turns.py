"""Time and profile the port's ``face_sums`` wrapper on the card, on the
inputs of ``chip_smoke.py`` phase 6m, in one or two trees of this
repository.

Run from the repository root on a machine with a CUDA card:

    python3 tools/face_sums_turns.py [--parent DIR] [--out FILE]

It builds the bench grid mesh (999,698 faces) and the suite's view 0 at
3840x2160 as ``chip_smoke.py`` does, and saves two inputs: view 0's
pix2face with phase 6m's soft image (10 channels, the top sixteenth NaN),
and the mesh's 3F vertex keys with 10 seeded channels per face, as
``face_to_vert_texture`` sums them.  Each turn is a process of its own,
started in a tree's root, that times that tree's wrapper on both inputs
(median of 20 CUDA-event runs; ``host_ms``, the host's time to enqueue
one call, and ``c_host_ms``, that of the C entry point alone), lists the device time of every kernel the
wrapper launches and of every ``aten::`` operator it calls
(``torch.profiler``, per call), and times ``index_add`` on the same
inputs.  With ``--parent DIR`` (a ``git archive`` of another commit,
unpacked under the gitignored ``build/``) the turns run parent, change,
change, parent; without it, this tree once.  Prints one JSON line per
turn, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# one turn: run with a tree's root as the working directory, it times
# that tree's wrapper on the saved inputs
TURN = r"""
import inspect, json, os, statistics, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from geograypher_tpu_torch.ops import face_sums
here = os.path.realpath(os.getcwd()) + os.sep
assert os.path.realpath(face_sums.__file__).startswith(here), face_sums.__file__
data = torch.load(sys.argv[1])
takes_shape = "shape" in inspect.signature(face_sums.face_sums).parameters


def ms(fn, runs=20):
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


out = {"tree": here}
for case in ("view0", "vertex"):
    d = data[case]
    keys, values, n = d["keys"].cuda(), d["values"].cuda(), d["n_segments"]
    shape = d["shape"]
    if takes_shape:
        call = lambda: face_sums.face_sums(keys, values, n, shape=shape)
    else:
        call = lambda: face_sums.face_sums(keys, values, n)
    call()
    torch.cuda.synchronize()
    runs = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
    kernels, ops = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.self_device_time_total
            if us > 0:
                kernels[ev.key[:90]] = round(us / 1e3 / runs, 5)
        elif ev.key.startswith("aten::"):
            us = getattr(ev, "device_time_total", 0)
            if us > 0:
                ops[ev.key] = round(us / 1e3 / runs, 5)
    # the host's time to enqueue a call (no synchronise between calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        call()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    extra = {}
    if takes_shape:  # the C entry point alone, on buffers allocated once
        from geograypher_tpu_torch.kernels import build
        lib, c = build.load(), values.shape[1]
        (h, w), (_, tw) = face_sums._tiling(keys.numel(), shape)
        bufs = [torch.empty(lib.gg_face_sums_scratch_bytes(keys.numel(), n, c),
                            dtype=torch.uint8, device="cuda"),
                torch.empty((n, c), device="cuda"),
                torch.empty((n, c), dtype=torch.int32, device="cuda")]
        stream = build.stream_ptr(values.device)
        args = (keys.data_ptr(), int(keys.dtype == torch.int64), values.data_ptr(),
                keys.numel(), h, w, tw.bit_length() - 1, n, c,
                *(b.data_ptr() for b in bufs), stream)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            lib.gg_face_sums(*args)
        extra["c_host_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
    seg = torch.where((keys >= 0) & (keys < n), keys.long(), n)
    zeros = torch.zeros((n + 1, values.shape[1]), device=values.device)
    out[case] = dict(
        ms=ms(call), device_ms=round(sum(kernels.values()), 5), host_ms=host_ms,
        kernels=kernels, aten_ops=ops, **extra,
        library_ms=ms(lambda: zeros.index_add(0, seg, values)))
print(json.dumps(out))
"""


def _inputs(path):
    """Save phase 6m's two inputs of the wrapper to ``path``."""
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda")
    _, _, mesh, _, _, _, cams = cs._bench_scene(dev)
    cfg = mesh.raster_config
    b = cams.get_camera_batch([0], device=dev)
    soa = mesh._tri_soa_device(cams, cfg.bin_block)
    setup = cs.setup_from_soa(soa, b.world_to_cam[0], b.f[0], cs.W, cs.H, cfg.znear)
    _, caps = cs._census_caps([setup], cfg)
    mesh.raster_config = dataclasses.replace(cfg, caps=caps)
    p2f, _ = mesh._rasterize_view(cams, 0, 1.0, None, mesh.raster_config)
    rng = np.random.default_rng(6)
    soft = rng.random((cs.H, cs.W, cs.N_CLASSES), dtype=np.float32)
    soft[: cs.H // 16] = np.nan
    face_values = torch.as_tensor(
        np.random.default_rng(7).random((mesh.n_faces, cs.N_CLASSES), dtype=np.float32))
    torch.save({
        "view0": dict(keys=p2f.reshape(-1).cpu(),
                      values=torch.as_tensor(soft).reshape(-1, cs.N_CLASSES),
                      n_segments=mesh.n_faces, shape=(cs.H, cs.W)),
        "vertex": dict(keys=torch.as_tensor(mesh.faces, dtype=torch.int64).reshape(-1),
                       values=face_values.repeat_interleave(3, dim=0).contiguous(),
                       n_segments=mesh.n_verts, shape=None),
    }, path)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR", default=None,
                        help="a checkout of another commit, timed in turns with this tree")
    parser.add_argument("--out", default=None, help="also write the lines to this file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("face_sums_turns.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    path = ROOT / "build" / "face_sums_inputs.pt"
    path.parent.mkdir(exist_ok=True)
    _inputs(path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    order = ("parent", "change", "change", "parent") if args.parent else ("change",)
    lines = []
    for who in order:
        run = subprocess.run([sys.executable, "-c", TURN, str(path)], text=True, env=env,
                             cwd=args.parent if who == "parent" else ROOT,
                             capture_output=True)
        if run.returncode:
            raise RuntimeError(f"{who} turn:\n{run.stderr}")
        lines.append(json.dumps({"turn": who, **json.loads(run.stdout.splitlines()[-1]),
                                 "card": smi}))
        print(lines[-1], flush=True)
    path.unlink()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
