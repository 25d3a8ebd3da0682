"""The traced run: the benchmark's own host spans, ``torch.profiler`` over
the measured window, and the reduction of its Chrome trace to what the
per-layer readers read.

Spans are recorded from the benchmark's files around its calls into the
program (``zkbench.next_input``, ``zkbench.request``, ``zkbench.readback``
inside ``zkbench.window``); with tracing off they cost nothing.  The
device's busy time is the union of its kernel, copy and set intervals
inside the window (the arithmetic of the port's ``bench/profile.py::
device_busy``).  A device kernel is the program's own unless its name
belongs to PyTorch or a library PyTorch calls, so that a kernel renamed,
split or rewritten is still found.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "zkbench.window"
SPAN_PREFIX = "zkbench."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Kernels of PyTorch (ATen, c10) and of the libraries it launches (CUB,
# Thrust, cuBLAS, cuDNN).  PyTorch's kernels in anonymous namespaces still
# carry their ``at::native::`` prefix.
_TORCH_KERNEL = re.compile(r"at::|c10::|cub::|thrust::|at_cuda_detail|cublas|cudnn")


def is_program_kernel(name: str, cat: str) -> bool:
    """True for a device kernel of the program under test."""
    return cat == "kernel" and not _TORCH_KERNEL.search(name)


class Spans:
    """Host spans around the benchmark's calls: ``record_function`` ranges
    while the profiler runs, nothing otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)


@dataclass
class TraceView:
    """What one traced window shows, in seconds; the readers' input."""

    window_s: float
    busy_s: float
    program_kernel_s: float
    other_device_s: float
    requests: int
    # Work each request requires (roofline.py), when the cell counts it.
    work: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


class Profiler:
    """``torch.profiler`` over the window, its trace written to a temporary
    directory and reduced to a :class:`TraceView` when it stops."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        import torch

        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def view(self, requests: int, work: Dict[str, float]) -> TraceView:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_trace(events, requests, work)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)", "anon")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:160]


def reduce_trace(events: List[dict], requests: int,
                 work: Optional[Dict[str, float]] = None) -> TraceView:
    """The window's busy time, the program's kernel time, everything else
    on the device, the top device operations by time, and the idle time
    by the host span that was open while the device idled (times in the
    trace are microseconds)."""
    windows = [e for e in events
               if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW} span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name") != WINDOW
        and str(e.get("name", "")).startswith(SPAN_PREFIX))
    intervals, program, other = [], 0.0, 0.0
    by_name: Dict[str, float] = {}
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATEGORIES or "dur" not in e:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        intervals.append((s, t))
        name = e.get("name", "")
        if is_program_kernel(name, cat):
            program += t - s
        else:
            other += t - s
        key = short_name(name) if cat == "kernel" else name
        by_name[key] = by_name.get(key, 0.0) + (t - s)
    busy = _merge(intervals)
    busy_us = sum(t - s for s, t in busy)
    # Idle gaps inside the window, each named by the innermost benchmark
    # span open at its midpoint.
    starts = [s for s, _, _ in spans]
    idle: Dict[str, float] = {}
    prev = w0
    for s, t in busy + [(w1, w1)]:
        if s > prev:
            mid = (prev + s) / 2
            label = "zkbench.none"
            i = bisect.bisect_right(starts, mid) - 1
            best = None
            while i >= 0 and i > bisect.bisect_right(starts, mid) - 64:
                a, b, name = spans[i]
                if a <= mid <= b and (best is None or b - a < best[0]):
                    best = (b - a, name)
                i -= 1
            if best is not None:
                label = best[1]
            idle[label] = idle.get(label, 0.0) + (s - prev)
        prev = max(prev, t)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceView(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy_us / 1e6,
        program_kernel_s=program / 1e6,
        other_device_s=other / 1e6,
        requests=requests,
        work=dict(work or {}),
        device_ops=[(n, v / 1e6) for n, v in top],
        idle_gaps=[(n, v / 1e6) for n, v in gaps],
    )
