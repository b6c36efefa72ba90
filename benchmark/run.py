"""Run one cell of the benchmark once on the card, and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: every number
compared with the plain reference beside its limit); the last lines of
standard error repeat the checks.  Without a card, or with fewer cards than
the cell asks for, it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up counts from here: imports, build, warm-up

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a non-negative whole number")

    import torch

    from benchmark import cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2

    from benchmark import harness

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
