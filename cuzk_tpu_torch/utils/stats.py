"""Timing helpers: :func:`timed` as in ``cuzk_tpu.utils.stats``, waiting
for CUDA instead of ``jax.block_until_ready``, and CUDA-event timing."""

from __future__ import annotations

import time
from typing import Callable

import torch


def timed(fn: Callable, *args, **kwargs):
    """(result, seconds) on the host clock, with queued CUDA work finished
    before the clock stops (PyTorch returns before the device is done)."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - start


def cuda_time_ms(fn: Callable, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls, measured
    with CUDA events on the current stream after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
