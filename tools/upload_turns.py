"""Time ``chip_smoke.py`` phase 3's streaming aggregation (8 4K views of
one-hot float32 label stacks, each uploaded through
``utils/device.py`` ``PinnedUpload``) in one or two trees of this
repository, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/upload_turns.py [--parent DIR] [--runs N]

Each turn is a process of its own, started in a tree's root, that builds
that tree's kernels, the bench grid mesh (999,698 faces, sorted) and the
suite's 8 views with phase 3's census-sized caps (that tree's
``chip_smoke.py`` helpers), runs ``aggregate_projected_images(...,
use_planned=False)`` once to warm up and then ``--runs`` times, and prints
one JSON line: views/s of each run, the host's seconds inside the uploads
(``PinnedUpload.__call__``) and the aggregate's checksum.  With ``--parent
DIR`` (a ``git archive`` of another commit, unpacked under the gitignored
``build/``) the turns run parent, change, change, parent; without it,
this tree once.  Prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = r"""
import json, os, sys, time
import numpy as np
import torch
import chip_smoke as cs
from geograypher_tpu_torch.kernels import build
from geograypher_tpu_torch.utils import device as device_mod
here = os.path.realpath(os.getcwd()) + os.sep
assert os.path.realpath(device_mod.__file__).startswith(here), device_mod.__file__
build.load()
dev = torch.device("cuda")
verts, faces, mesh, c2ws, sensors, sensor_ids, cams = cs._bench_scene(dev)
cfg = mesh.raster_config
soa = mesh._tri_soa_device(cams, cfg.bin_block)
setups = []
for i in range(len(cams)):
    b = cams.get_camera_batch([i], device=dev)
    dist = mesh._resolve_distortion(cams, i, None)
    setups.append(cs.setup_from_soa(
        soa, b.world_to_cam[0], b.f[0], cs.W, cs.H, cfg.znear,
        distortion=(b.distortion[0], b.cx[0], b.cy[0]) if dist else None))
_, caps = cs._census_caps(setups, cfg)
del setups
mesh.raster_config = cs.dataclasses.replace(cfg, caps=caps)
labels = np.random.default_rng(0).integers(0, cs.N_CLASSES, (len(cams), cs.H, cs.W),
                                           dtype=np.int8)
seg = cs.SegmentorCameraSet(cams, cs.LabelSegmentor(labels, cs.N_CLASSES))
spent = [0.0]
call = device_mod.PinnedUpload.__call__


def timed_call(self, array):
    t0 = time.perf_counter()
    out = call(self, array)
    spent[0] += time.perf_counter() - t0
    return out


device_mod.PinnedUpload.__call__ = timed_call
avg, _ = mesh.aggregate_projected_images(seg, use_planned=False)
rates, uploads = [], []
for _ in range(int(sys.argv[1])):
    spent[0] = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg, _ = mesh.aggregate_projected_images(seg, use_planned=False)
    torch.cuda.synchronize()
    rates.append(len(cams) / (time.perf_counter() - t0))
    uploads.append(spent[0])
print(json.dumps({"tree": here, "views_per_s": rates, "upload_s": uploads,
                  "checksum": float(np.nansum(avg))}), flush=True)
"""


def turn(tree: Path, runs: int) -> None:
    env = dict(os.environ, PYTHONPATH=str(tree))
    subprocess.run([sys.executable, "-c", TURN, str(runs)], cwd=tree, env=env,
                   check=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR", default=None)
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    trees = [ROOT] if args.parent is None else [
        Path(args.parent).resolve(), ROOT, ROOT, Path(args.parent).resolve()]
    for tree in trees:
        turn(tree, args.runs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
