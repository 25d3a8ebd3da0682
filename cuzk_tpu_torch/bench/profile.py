"""Profiler CLI — the counterpart of ``cuzk_tpu.bench.profile``, the analog
of the reference's Nsight-targeted binary
(cuda/poseidon_cuda_profiler.cpp:172-213), on ``torch.profiler``.

Same config matrix ({1024 x 100, 8192 x 50, 32768 x 20, 65536 x 10},
poseidon_cuda_profiler.cpp:150-170) and CLI shape
(``<batch> <iters> single|pairs|both``).  ``--trace-dir`` traces each
config with ``torch.profiler`` inside an NVTX range named after it, writes
one Chrome trace per config there and adds the device's busy time, the
traced span and the idle share to the config's line.  Needs a Hopper card.

Usage:
    python -m cuzk_tpu_torch.bench.profile 8192 50 pairs
    python -m cuzk_tpu_torch.bench.profile --comprehensive --trace-dir /tmp/trace
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import hash_pair_cuda, hash_single_cuda
from cuzk_tpu_torch.utils.device import require_cuda

# poseidon_cuda_profiler.cpp:150-170
COMPREHENSIVE_CONFIGS = [(1024, 100), (8192, 50), (32768, 20), (65536, 10)]
WARMUP_ITERS = 3


def device_busy(fn: Callable, name: str, trace_path: str = None) -> Dict:
    """Run ``fn()`` once under ``torch.profiler`` inside an NVTX range and a
    profiler range named ``name``; returns the device's busy time (the union
    of its kernel and copy intervals), the span from the first to the last
    of them, and the idle share of that span.  Writes a Chrome trace to
    ``trace_path`` when given."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.cuda.nvtx.range(name), record_function(name):
            fn()
        torch.cuda.synchronize()
    if trace_path:
        prof.export_chrome_trace(trace_path)
    # The range itself is mirrored on the device's timeline under its own
    # name; it spans the whole call and is no device work.
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name != name
    )
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = spans[-1][1] - spans[0][0] if spans else 0
    return {
        "device_busy_ms": busy / 1e3,
        "device_span_ms": span / 1e3,
        "idle_share": 1 - busy / span if span else None,
    }


def profile_hash(batch: int, iters: int, mode: str, device,
                 trace_dir: str = None) -> Dict:
    rng = np.random.default_rng(0)
    l = fr.as_digits(rng.integers(0, 1 << 16, (batch, fr.NDIGITS), np.uint32),
                     device=device)
    r = fr.as_digits(rng.integers(0, 1 << 16, (batch, fr.NDIGITS), np.uint32),
                     device=device)

    def step():
        if mode == "single":
            return hash_single_cuda(l)
        return hash_pair_cuda(l, r)

    def run():
        for _ in range(iters):
            step()

    for _ in range(WARMUP_ITERS):
        step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    out = {
        "mode": mode,
        "batch": batch,
        "iters": iters,
        "total_hashes": batch * iters,
        "hashes_per_s": batch * iters / elapsed,
        "ns_per_hash": elapsed / (batch * iters) * 1e9,
    }
    if trace_dir:
        name = f"{mode}_{batch}x{iters}"
        out.update(device_busy(run, name, os.path.join(trace_dir, f"{name}.json")))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("batch", nargs="?", type=int, default=8192)
    parser.add_argument("iters", nargs="?", type=int, default=50)
    parser.add_argument(
        "mode", nargs="?", default="both", choices=["single", "pairs", "both"]
    )
    parser.add_argument("--comprehensive", action="store_true")
    parser.add_argument("--trace-dir", default=None)
    args = parser.parse_args(argv)
    device = require_cuda()

    configs = COMPREHENSIVE_CONFIGS if args.comprehensive else [
        (args.batch, args.iters)
    ]
    modes = ["single", "pairs"] if args.mode == "both" else [args.mode]
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    for batch, iters in configs:
        for mode in modes:
            print(json.dumps(profile_hash(batch, iters, mode, device,
                                          args.trace_dir)))
    if args.trace_dir:
        print(f"traces written to {args.trace_dir}")


if __name__ == "__main__":
    main()
