"""The traced slice of a run: ``torch.profiler`` around a few surveys, and
the reduction of its Chrome trace to device busy time, device time by
operation and the host's activity in the device's idle gaps.

The reduction reads plain event lists, so the tests can hand it a
synthetic trace.  Device time is the union of the intervals of every
device event (kernels, copies, fills) inside the slice, never a sum:
events on two streams that overlap count once.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from pathlib import Path

SLICE_SPAN = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 120  # a breakdown's names are cut to this many characters


@dataclasses.dataclass
class Slice:
    """What a traced slice holds, times in seconds: ``window_s`` the slice's
    length, ``busy_s`` the union of the device intervals inside it,
    ``kernels`` {kernel name: (events, seconds)}, ``device_ops`` and
    ``idle_gaps`` the breakdown's two lists ([name, seconds], longest
    first)."""

    window_s: float
    busy_s: float
    kernels: dict
    device_ops: list
    idle_gaps: list


def merge(intervals):
    """Sorted, disjoint (start, end) pairs covering ``intervals``."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def reduce_events(events: list) -> Slice:
    """Reduce Chrome-trace events (dicts with ``ph``, ``cat``, ``name``,
    ``ts``, ``dur`` in microseconds, ``tid``) to a :class:`Slice`.  The
    slice is the one ``bench.slice`` span; device events are clipped to it;
    an idle gap is named by the innermost host event of the slice's
    thread that covers its middle ("host: outside any operation" where
    none does), and gaps of one name are added up."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE_SPAN]
    if len(spans) != 1:
        raise ValueError(f"a trace holds {len(spans)} {SLICE_SPAN!r} spans, not one")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    main_tid = spans[0].get("tid")
    device, by_name, kernels = [], {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        start = max(float(e["ts"]), lo)
        end = min(float(e["ts"]) + float(e["dur"]), hi)
        if end <= start:
            continue
        device.append((start, end))
        sec = (end - start) / 1e6
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + sec
        if e["cat"] == "kernel":
            n, s = kernels.get(e["name"], (0, 0.0))
            kernels[e["name"]] = (n + 1, s + sec)
    busy = merge(device)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and e.get("tid") == main_tid and e.get("name") != SLICE_SPAN),
                  key=lambda h: (h[0], -h[1]))
    gaps = {}
    edge = lo
    stack, nxt = [], 0  # the host events open at the last gap's middle
    for start, end in busy + [(hi, hi)]:
        if start > edge:
            mid = (edge + start) / 2
            while nxt < len(host) and host[nxt][0] <= mid:
                while stack and stack[-1][1] <= host[nxt][0]:
                    stack.pop()
                stack.append(host[nxt])
                nxt += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            name = stack[-1][2] if stack else "host: outside any operation"
            gaps[name] = gaps.get(name, 0.0) + (start - edge) / 1e6
        edge = max(edge, end)

    def top(d):
        return [[k[:NAME_CHARS], v]
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Slice(window_s=(hi - lo) / 1e6,
                 busy_s=sum(end - start for start, end in busy) / 1e6,
                 kernels=kernels, device_ops=top(by_name), idle_gaps=top(gaps))


class Tracer:
    """``torch.profiler`` over the host and (``on_card``) CUDA, started and
    stopped around the slice; :meth:`reduce` reads its Chrome trace from a
    temporary file."""

    def __init__(self, on_card: bool = True):
        self.on_card = on_card
        self._prof = None
        self._span = None

    def warm_up(self, device):
        """One short trace of one device operation: the profiler's first
        start (CUPTI's set-up, seconds on the card) falls in the set-up."""
        import torch

        self.start()
        torch.ones(1, device=device).add_(1)
        self.stop()

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.on_card:
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._span = record_function(SLICE_SPAN)
        self._span.__enter__()

    def stop(self):
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def reduce(self) -> Slice:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self._prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        return reduce_events(events)
