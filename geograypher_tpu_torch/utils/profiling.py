"""Stage timing and device traces: the port's counterpart of
``geograypher_tpu/utils/profiling.py`` on ``torch.profiler``.

Usage::

    from geograypher_tpu_torch.utils.profiling import stage_timer, device_trace

    with stage_timer("aggregate"):
        ...

    with device_trace("traces"):      # a Chrome trace file in traces/
        run_pipeline()

    print(stage_timer.report())
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch

logger = logging.getLogger("geograypher_tpu_torch.profiling")


class _StageTimer:
    """Accumulating named wall-clock stage timer (work enqueued on a card
    counts where the stage waits for it)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, log: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if log:
                logger.info("%s: %.1f ms", name, dt * 1e3)

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        lines = ["stage                          total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t:8.3f} {c:7d} {t / c * 1e3:9.2f}")
        return "\n".join(lines)


stage_timer = _StageTimer()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the scope (the CPU, and CUDA where a
    card is present), written to ``log_dir/trace.json`` in the Chrome
    trace format (``chrome://tracing``, Perfetto)."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    folder = Path(log_dir)
    folder.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(folder / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up on the trace's timeline."""
    with torch.profiler.record_function(name):
        yield
