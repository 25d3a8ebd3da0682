"""Spans and counters inside the port, recorded while a ``torch.profiler``
session records and costing one flag test otherwise.

Run any ``torch.profiler`` session around calls into the port: each
:func:`span` then opens ``record_function("cuzk." + name)``, so the span
lands in the profiler's own trace on the clock of the device's kernels, and
adds its time to an in-memory table keyed by its name and its parent's
name.  A span opened with no span open on its thread is a root: one request
(``cuzk.build_tree_levels``, ``cuzk.verify_each``).  It takes the next
request number, and its children pass the same number as
``record_function``'s ``args``.  A span opened with ``wait=True`` is one in
which the host blocks on the device.  :func:`count` adds to a named counter.

With no session recording, :func:`span` tests the profiler's flag and
returns one shared no-op context, and :func:`count` returns.

The table starts empty when a span or a count finds the profiler recording
after last finding it off, and holds that session's totals until the next
session begins: read it with :func:`totals` after the session.  Kernel
launches come from ``ops.poseidon_cuda.launch_counts``, copied when the
session begins; :func:`totals` reports their change up to the end of the
session's last root span as ``launch.<kind>``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch.autograd.profiler as _profiler

PREFIX = "cuzk."

_NOOP = contextlib.nullcontext()  # every span while no session records
# Whether the last look found the profiler recording: a span or a count
# that finds it recording after this reads False begins a new table.
_live = False
_lock = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # this thread's open spans


_local = _Local()


class _Table:
    """One session's totals."""

    def __init__(self):
        from cuzk_tpu_torch.ops.poseidon_cuda import launch_counts

        # (name, parent) -> [count, ns, self ns, wait]
        self.spans: Dict[tuple, list] = {}
        self.counters: Dict[str, int] = {}
        self.requests = 0
        self.root_ns = 0
        self.wait_ns = 0
        self.launch_base = dict(launch_counts)
        self.launch_last = dict(launch_counts)


_table: Optional[_Table] = None


def _begin() -> None:
    """The profiler records and the last look found it off: a new table."""
    global _live, _table
    with _lock:
        if not _live:
            _table = _Table()
            _live = True


class _Span:
    """A span while a session records."""

    __slots__ = ("name", "wait", "parent", "request", "child_ns", "t0", "rf")

    def __init__(self, name: str, wait: bool):
        self.name = name
        self.wait = wait

    def __enter__(self):
        stack = _local.stack
        if stack:
            self.parent = stack[-1].name
            self.request = stack[-1].request
        else:
            self.parent = None
            with _lock:
                _table.requests += 1
                self.request = _table.requests
        self.rf = _profiler.record_function(self.name, str(self.request))
        self.rf.__enter__()
        self.child_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += ns
        self.rf.__exit__(*exc)
        with _lock:
            row = _table.spans.setdefault((self.name, self.parent),
                                          [0, 0, 0, self.wait])
            row[0] += 1
            row[1] += ns
            row[2] += ns - self.child_ns
            if self.wait:
                _table.wait_ns += ns
            if not stack:
                from cuzk_tpu_torch.ops.poseidon_cuda import launch_counts

                _table.root_ns += ns
                _table.launch_last = dict(launch_counts)
        return False


def span(name: str, wait: bool = False):
    """A context that records ``cuzk.<name>`` while a profiler session
    records, and the shared no-op otherwise.  ``wait`` marks a span in
    which the host blocks on the device."""
    global _live
    if not _profiler._is_profiler_enabled:
        _live = False
        return _NOOP
    if not _live:
        _begin()
    return _Span(PREFIX + name, wait)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session records."""
    global _live
    if not _profiler._is_profiler_enabled:
        _live = False
        return
    if not _live:
        _begin()
    with _lock:
        _table.counters[name] = _table.counters.get(name, 0) + n


def totals() -> dict:
    """The totals of the session that records now or recorded last: one
    row a span name and parent (``count``, ``total_s``, ``self_s``: the
    duration less the part its child spans cover, ``wait``), the sums over
    root spans (``root_s``) and over wait spans (``wait_s``), the root
    spans (``requests``), and the counters with each kernel's launches
    from the session's start to its last root span's end as
    ``launch.<kind>``.  Empty before the first session."""
    global _live
    if not _profiler._is_profiler_enabled:
        _live = False
    with _lock:
        t = _table
        if t is None:
            return {"requests": 0, "root_s": 0.0, "wait_s": 0.0, "spans": [],
                    "counters": {}}
        counters = dict(t.counters)
        for kind, n in t.launch_last.items():
            counters["launch." + kind] = n - t.launch_base.get(kind, 0)
        rows = [{"name": name, "parent": parent, "count": n,
                 "total_s": ns / 1e9, "self_s": self_ns / 1e9, "wait": wait}
                for (name, parent), (n, ns, self_ns, wait) in t.spans.items()]
        return {"requests": t.requests, "root_s": t.root_ns / 1e9,
                "wait_s": t.wait_ns / 1e9,
                "spans": sorted(rows, key=lambda r: -r["total_s"]),
                "counters": counters}
