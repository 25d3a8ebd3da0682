"""Timing stats structs (HashingStats / TreeBenchmarkResult analogs —
poseidon.hpp:69-77, merkle_tree.hpp:121-128) and timing helpers:
:func:`timed` as in ``cuzk_tpu.utils.stats``, waiting for CUDA instead of
``jax.block_until_ready``, and CUDA-event timing."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class HashingStats:
    """poseidon.hpp:69-77 — totals + derived rates."""

    total_hashes: int = 0
    total_time_s: float = 0.0

    @property
    def hashes_per_second(self) -> float:
        return self.total_hashes / self.total_time_s if self.total_time_s else 0.0

    @property
    def ns_per_hash(self) -> float:
        return (
            self.total_time_s / self.total_hashes * 1e9 if self.total_hashes else 0.0
        )


@dataclass
class TreeBenchmarkResult:
    """merkle_tree.hpp:121-128 (proof_time_ms = the reference's
    proof_generation_time_ms; verify_time_ms = proof_verification_time_ms)."""

    leaf_count: int = 0
    arity: int = 0
    tree_height: int = 0
    build_time_ms: float = 0.0
    proof_time_ms: float = 0.0
    verify_time_ms: float = 0.0


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
