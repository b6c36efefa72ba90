"""The readings that the limits of an entry's ``LIMITS`` are set from.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ... [--control-seeds 3]

On the card, in one process: for each seed, one survey of the cell at its
timed size through the program's timed entry, compared with the float64
reference (the program's reading, a lower end), and, on the first
``--control-seeds`` seeds, the control: the same reference computed in
bfloat16 put in the program's place (an upper end).  One JSON line a seed;
the last line the largest program reading and the smallest control
reading of each compared number.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONTROL_DTYPE = "bfloat16"  # the precision below the configurations' float32


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from benchmark import cells

    cell = cells.load(args.workload)
    device = torch.device(args.device)
    entry = cells.entry(cell.traffic).Entry(cell.config, cell.traffic, args.seeds[0],
                                            device)
    entry.run(-1)
    program, control = {}, {}
    for k, seed in enumerate(args.seeds):
        entry.reseed(seed)
        t0 = time.perf_counter()
        done = entry.run(0)
        t1 = time.perf_counter()
        line = {"seed": seed, "program_s": t1 - t0, "program": entry.check(done)}
        t2 = time.perf_counter()
        line["check_s"] = t2 - t1
        if k < args.control_seeds:
            line["control"] = entry.control(done, getattr(torch, CONTROL_DTYPE))
            line["control_s"] = time.perf_counter() - t2
        for name, value in line["program"].items():
            program[name] = max(program.get(name, 0.0), value)
        for name, value in line.get("control", {}).items():
            control[name] = min(control.get(name, float("inf")), value)
        print(json.dumps(line), flush=True)
    entry.close()
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "program_max": program, "control_min": control,
                      "control_dtype": CONTROL_DTYPE}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
