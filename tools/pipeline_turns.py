"""Time ``chip_smoke.py`` phase 7's survey pipeline (20 4K views of the
bench suite from int8 class images) through several trees of this
repository, in turns, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/pipeline_turns.py TREE [TREE ...]

Each TREE is the root of a checkout of a commit (for instance a ``git
archive`` unpacked under the gitignored ``build/``; ``.`` is this tree).
The turns walk the trees forward, then backward (A B C D D C B A;
a tree named more than once takes a turn each time it is named, so
``P C P C P C P C P C`` gives ten turns of each, alternating), each a
process of its own started in its tree, so that every turn
imports that tree's ``geograypher_tpu_torch`` and its
``chip_smoke.py`` helpers.  A turn builds phase 7's workload: the
999,698-face bench mesh (sorted), the 20 views of the suite (the last
five through the Brown-Conrady sensors), seeded int8 class images of 10
classes, phase 6's configuration (``bin_block=8, l0_window=(5, 2)``, the
library's default caps) and a provider of the class images on one device,
as ``_pipeline_phase`` calls it.  It runs
``aggregate_class_images_distributed`` once (the plan), then at 4, 1, 4
and 1 prefetch workers, each run ended by a synchronise, and prints one
JSON line: the seconds and views/s of each run, and a checksum of the
view counts (every tree must give the same).  The script prints every
turn's line, each tree's median views/s at 4 and at 1 worker with the
quartiles of its runs, and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

TURN = r"""
import json, os, sys, time
import numpy as np
import torch
import chip_smoke as cs
from geograypher_tpu_torch.parallel import pipeline
here = os.path.realpath(os.getcwd()) + os.sep
assert os.path.realpath(pipeline.__file__).startswith(here), pipeline.__file__
dev = torch.device("cuda")
t0 = time.perf_counter()
_, _, mesh, _, sensors, _, _ = cs._bench_scene(dev)
n = cs.PIPELINE_VIEWS
cams = cs.CameraSet(cs._suite_cameras(n_views=n), sensors,
                    image_filenames=[f"view_{k:02d}.png" for k in range(n)],
                    sensor_IDs=cs._suite_sensor_ids(n))
labels = np.random.default_rng(7).integers(0, cs.N_CLASSES, (n, cs.H, cs.W), dtype=np.int8)
cfg = cs.dataclasses.replace(cs.DEFAULT_RASTER_CONFIG, bin_block=8, l0_window=(5, 2),
                             global_from=mesh.raster_config.global_from)
scene_s = time.perf_counter() - t0


def run(workers):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline.aggregate_class_images_distributed(
        mesh, cams, cs.N_CLASSES, class_image_provider=lambda i: labels[i],
        prefetch_workers=workers, config=cfg, device_mesh=[dev])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


(_, views), first_s = run(4)
runs = []
for workers in (4, 1, 4, 1):
    (_, vc2), sec = run(workers)
    if not np.array_equal(vc2, views):
        raise SystemExit(f"a run at {workers} workers gave other view counts")
    runs.append(dict(workers=workers, seconds=round(sec, 4), views_per_s=round(n / sec, 3)))
weights = (np.arange(views.size) % 97 + 1).reshape(views.shape)
print(json.dumps(dict(scene_s=round(scene_s, 3), first_s=round(first_s, 4), runs=runs,
                      views_checksum=int((views.astype(np.int64) * weights).sum()))))
"""


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="roots of checkouts of commits")
    args = parser.parse_args()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    order = args.trees + args.trees[::-1]
    turns = []
    for tree in order:
        out = subprocess.run([sys.executable, "-c", TURN], cwd=tree, env=env, text=True,
                             capture_output=True)
        if out.returncode:
            raise SystemExit(f"turn in {tree} failed:\n{out.stderr[-4000:]}")
        turn = dict(tree=tree, **json.loads(out.stdout.strip().splitlines()[-1]))
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    summary = {}
    for tree in dict.fromkeys(args.trees):
        mine = [t for t in turns if t["tree"] == tree]
        summary[tree] = {"turns": len(mine)}
        for w in (4, 1):
            rates = [r["views_per_s"] for t in mine for r in t["runs"] if r["workers"] == w]
            summary[tree][f"workers_{w}_views_per_s"] = statistics.median(rates)
            # first and third quartiles of the runs
            q1, _, q3 = statistics.quantiles(rates, n=4)
            summary[tree][f"workers_{w}_quartiles"] = [q1, q3]
        summary[tree]["first_s"] = [t["first_s"] for t in mine]
    checksums = {t["views_checksum"] for t in turns}
    print(json.dumps({"summary": summary, "order": order,
                      "view_counts_equal": len(checksums) == 1}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
