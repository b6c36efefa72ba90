"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The window is a closed loop: one survey at a time, the next started when
the last returns, until ``seconds`` have passed; the last survey started
always runs to its end, so a stall anywhere in the window counts.  The
rate is every view of every finished survey over the time from the
window's start to the end of the last survey.  With ``trace`` the first
surveys of the window, ``trace_seconds`` of them, run under the profiler,
and the per-layer metrics are read instead of the end-to-end ones.

The mix names its entry (``entries/<entry>.py``: its ``Entry`` class and
the limits of its compared numbers, ``LIMITS``) and the end-to-end metric
its rate is reported under (``rate_metric``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import traceback

import torch

from benchmark import cells, scene, system
from benchmark.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "geograypher_tpu")


@dataclasses.dataclass
class Window:
    """What the per-layer readers read: the window's surveys and views,
    the program's counters over it, and the traced slice."""

    views: int
    stats: list  # the program's pipeline_stats records of the window
    launches: dict  # kernel launches in the window, by kernel
    peak_bytes: int  # device memory peak over the window
    slice: object  # trace.Slice, or None
    slice_views: int
    slice_least_s: float  # the roofline's least time of the slice's views, or None


def forbidden_modules() -> list:
    """Top-level names of ``FORBIDDEN`` modules that are loaded, compared
    whole (``geograypher_tpu_torch`` is not ``geograypher_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _log(line: str):
    print(line, file=sys.stderr, flush=True)


def _number(x: float):
    return x if math.isfinite(x) else None


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    traffic = cell.traffic
    module = cells.entry(traffic)
    limits = module.LIMITS
    t_entry = time.perf_counter()
    entry = module.Entry(cell.config, traffic, seed, device)
    try:
        t_warm = time.perf_counter()
        entry.run(-1)  # warm-up: every shape of the cell, on a survey the window never uses
        if trace:
            Tracer(on_card).warm_up(device)
        if on_card:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        _log(f"setup {setup_s:.3f} s: imports {t_entry - t_start:.3f}, inputs and "
             f"program {t_warm - t_entry:.3f}, warm-up {t_start + setup_s - t_warm:.3f}")
        setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)

        launches0 = system.launches()
        stats0 = len(entry.stats.records)
        tracer = Tracer(on_card) if trace else None
        done, ends, traced = [], [], None
        attempted = failed = 0
        if tracer is not None:
            tracer.start()
        t0 = slice_t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            attempted += entry.views_per_survey
            t_survey = time.perf_counter()
            try:
                done.append(entry.run(len(done)))
                ends.append(time.perf_counter() - t_survey)
            except Exception:  # a failed survey is counted, the loop goes on
                traceback.print_exc()
                failed += entry.views_per_survey
                done.append(None)
            if tracer is not None and traced is None and (
                    time.perf_counter() - slice_t0 >= traffic["trace_seconds"]):
                tracer.stop()
                traced = [d for d in done if d is not None]
        if on_card:
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        if tracer is not None and traced is None:
            tracer.stop()
            traced = [d for d in done if d is not None]
        window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        launches = {k: v - launches0[k] for k, v in system.launches().items()}
        stats = entry.stats.records[stats0:]
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"modules loaded that the port must not load: {found}")
        entry.release()

        finished = [d for d in done if d is not None]
        views = sum(len(d.survey) for d in finished)
        _log(f"window {t_end - t0:.3f} s: {len(done)} surveys, {views} views, "
             "survey s " + " ".join(f"{e:.3f}" for e in ends))

        t_check = time.perf_counter()
        pick = scene.rng(seed, scene.STREAM_SAMPLE).permutation(len(done))
        checks, compared = {}, 0
        for k in pick[: traffic["check_surveys"]]:
            if done[k] is None:  # an answer that never came
                checks = {name: math.inf for name in limits}
                break
            for name, value in entry.check(done[k]).items():
                checks[name] = max(checks.get(name, 0.0), value)
            compared += 1
        correct = bool(compared) and all(checks[n] <= limits[n] for n in limits)
        _log(f"reference {time.perf_counter() - t_check:.3f} s over {compared} surveys")

        dev = {"platform": "gpu" if on_card else device.type,
               "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
               "count": cell.chips,
               "memory_peak_bytes": int(max(setup_peak, window_peak))}
        out = {"correct": correct, "attempted": attempted, "failed": failed}
        if trace:
            sl = tracer.reduce()
            window = Window(views, stats, launches, window_peak, sl,
                            sum(len(d.survey) for d in traced),
                            entry.least_seconds(traced))
            out["metrics"] = {}
            for m in cell.per_layer:
                value = cells.reader(m["name"])(window)
                if value is not None:
                    out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
            dev["busy_s"] = sl.busy_s
            dev["window_s"] = sl.window_s
            out["device"] = dev
            out["breakdown"] = {"device_ops": sl.device_ops, "idle_gaps": sl.idle_gaps}
        else:
            e2e = {traffic["rate_metric"]: views / (t_end - t0), "setup_s": setup_s}
            out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                              for m in cell.end_to_end}
            out["device"] = dev
        out["checks"] = {n: {"value": _number(checks.get(n, math.inf)),
                             "limit": limits[n]} for n in limits}
        return out
    finally:
        entry.close()
