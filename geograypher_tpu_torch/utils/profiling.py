"""Stage timing, spans and device traces: the port's counterpart of
``geograypher_tpu/utils/profiling.py`` on ``torch.profiler``.

Usage::

    from geograypher_tpu_torch.utils.profiling import stage_timer, device_trace

    with stage_timer("aggregate"):
        ...

    with device_trace("traces"):      # a Chrome trace file in traces/
        run_pipeline()

    print(stage_timer.report())

A stage of a :class:`_StageTimer` is also a span: while a profiler records
(``device_trace``, or any ``torch.profiler.profile``), it and every
:func:`annotate` region appear on the trace as ``user_annotation`` events
of the thread that opened them, on the clock of the card's kernel events.
With no profiler recording a span opens nothing: a running profiler is
the only switch.  No span waits for the device or reads a device value.

The spans the port opens on its hot paths:

* ``parallel/pipeline.py`` ``aggregate_class_images_distributed`` and the
  plan's executor it runs (``parallel/planner.py`` ``_DeviceRunner``,
  which opens the same spans for ``PlannedAggregator``), one timer a call,
  each span the ``pipeline_stats`` key in brackets:
  ``pipeline.prepare`` (``prepare_s``), ``pipeline.load`` and
  ``pipeline.slot_wait`` on the prefetch workers' threads (``load_s``,
  ``slot_wait_s``; on a trace only where the profiler records every
  thread), ``pipeline.fetch_wait`` (``fetch_wait_s``), ``pipeline.upload``
  (``upload_s``), ``pipeline.enqueue`` (``enqueue_s``) and
  ``pipeline.sync`` (``sync_s``);
* ``parallel/planner.py``: ``planner.plan`` around ``plan_aggregation``;
* ``utils/device.py`` ``PinnedUpload``: ``upload.wait`` and ``upload.stage``
  inside its callers' spans (``meshes/sparse.py``'s among them);
* ``meshes/mesh.py`` ``save_renders``: ``render.view`` (a view's raster and
  texture launches), ``render.overflow_read``, ``render.download``,
  ``render.writer_wait`` (the wait for the mask writer's threads); and
  ``utils/io.py`` ``write_image``: ``io.encode``, ``io.write`` (on the mask
  writer's threads there).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch

logger = logging.getLogger("geograypher_tpu_torch.profiling")


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` records in this process.  Reads the flag
    every profiler sets on entry and clears on exit through a private
    PyTorch name, anew on every call (a bound copy would miss a profiler
    started later); the one such read of this module."""
    return torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up on the trace's timeline; opens
    ``record_function`` only while a profiler records."""
    if not profiler_recording():
        yield
        return
    with torch.profiler.record_function(name):
        yield


class _StageTimer:
    """Accumulating named wall-clock stage timer (work enqueued on a card
    counts where the stage waits for it); each stage is an :func:`annotate`
    span too.  Threads may add to one name at once."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str, log: bool = False):
        t0 = time.perf_counter()
        try:
            if profiler_recording():
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
            if log:
                logger.info("%s: %.1f ms", name, dt * 1e3)

    def seconds(self, name: str) -> float:
        """Total seconds of ``name``; 0.0 for a stage never entered."""
        with self._lock:
            return self.totals.get(name, 0.0)

    def reset(self):
        with self._lock:
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
