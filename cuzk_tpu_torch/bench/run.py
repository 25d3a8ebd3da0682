"""Benchmark suite of the port: Poseidon hash throughput and Merkle builds.

The counterpart of the Poseidon and tree-build parts of
``cuzk_tpu.bench.run``, on one Hopper card:

- the reference's ``poseidon_benchmark`` configs {10K x 512, 100K x 1024,
  1M x 4096} (benchmark.cpp:213-235), single and pair hashing: small
  batches through the coalescing engine over the CUDA engine, as calls
  arrive from a host one batch at a time, large batches synchronously on
  tensors already on the card; ``--sync`` gives the device-loop rows;
- the Merkle build (50K leaves, arity 4 by default);
- a cross-implementation gate before any suite (the reference gates its
  whole benchmark binary, benchmark.cpp:137-144): every kernel entry point
  against its plain version on the card, the raw permutation included.

Timing: warm-up outside the timer; inside it the host clock runs until
``torch.cuda.synchronize()`` returns.  Every function takes an explicit
``device``; on the CPU the same code runs the plain versions (for tests of
the plumbing only — CPU numbers are not device metrics).  Results print
as JSON lines, each naming the card, then a summary table.

Usage:
    python -m cuzk_tpu_torch.bench.run --suite all
    python -m cuzk_tpu_torch.bench.run --suite poseidon --mode pairs
    python -m cuzk_tpu_torch.bench.run --suite merkle --leaves 50000 --arity 4
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cuzk_tpu_torch import merkle, poseidon
from cuzk_tpu_torch.engine import (
    CoalescingPoseidonEngine,
    CudaPoseidonEngine,
    PoseidonEngine,
    TorchPoseidonEngine,
)
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda as pc
from cuzk_tpu_torch.utils.device import nvidia_smi_name_power, require_cuda
from cuzk_tpu_torch.utils.errors import ComputationError

# A100 reference numbers (README.md:131-143, SURVEY.md §6).
BASELINES = {
    "poseidon_pairs_hashes_per_s": 2_145_027.0,
    "poseidon_single_hashes_per_s": 1_751_596.0,
    "merkle_build_50k_ms": 282.0,
}

# Reference poseidon_benchmark configs (benchmark.cpp:213-235).
POSEIDON_CONFIGS = [
    (512, 10_000, "Small Scale"),
    (1024, 100_000, "Medium Scale"),
    (4096, 1_000_000, "Large Scale"),
]

# Batches up to this size go through the coalescing engine by default.
COALESCE_MAX_BATCH = 2048


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device: torch.device) -> str:
    """The card's ``name, power.limit`` as nvidia-smi gives it ("cpu" for
    the CPU)."""
    if device.type != "cuda":
        return "cpu"
    return nvidia_smi_name_power().splitlines()[device.index or 0]


def time_fn_stats(fn: Callable, *args, device, iters: int = 10,
                  warmup: int = 2, groups: int = 5) -> Dict:
    """Grouped wall timing: warm-up, then the timed loop split into up to
    ``groups`` chunks, each ended by a wait on the device.  Within a chunk
    launches queue back to back; the per-chunk means give order statistics
    beside the mean.  Returns ``{"mean_s", "p50_s", "min_s"}`` seconds per
    iteration."""
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    _wait(device)
    g = max(1, min(iters, groups))
    base, extra = divmod(iters, g)
    per, total = [], 0.0
    for i in range(g):
        n = base + (1 if i < extra else 0)
        start = time.perf_counter()
        for _ in range(n):
            fn(*args)
        _wait(device)
        dt = time.perf_counter() - start
        total += dt
        per.append(dt / n)
    return {
        "mean_s": total / iters,
        "p50_s": float(np.median(per)),
        "min_s": min(per),
    }


def _rand_digits(n: int, seed: int) -> np.ndarray:
    """Random 256-bit canonical values as host digits; hashing reduces
    them on absorb."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 16, (n, fr.NDIGITS), dtype=np.uint32)


def _on(host: np.ndarray, device) -> torch.Tensor:
    return fr.as_digits(host, device=device)


def verify_paths_match(batch: int = 256, device="cuda") -> bool:
    """Gate: the kernel entry points and the plain versions agree bit for
    bit on ``device`` before benchmarking, over every exported op: pair and
    single hashing, ``hash_multiple`` (what the Merkle build runs on) and
    the raw permutation."""
    device = torch.device(device)
    l = _on(_rand_digits(batch, 7), device)
    r = _on(_rand_digits(batch, 8), device)
    groups = _on(_rand_digits(batch * 4, 9).reshape(batch, 4, fr.NDIGITS), device)
    states = _on(_rand_digits(batch * 3, 10).reshape(batch, 3, fr.NDIGITS), device)
    return (
        torch.equal(pc.hash_pair_cuda(l, r), poseidon.hash_pair(l, r))
        and torch.equal(pc.hash_single_cuda(l), poseidon.hash_single(l))
        and torch.equal(pc.hash_multiple_cuda(groups),
                        poseidon.hash_multiple(groups))
        and torch.equal(pc.permutation_cuda(states), poseidon.permutation(states))
    )


def _engine(device: torch.device) -> PoseidonEngine:
    """The kernels' engine on a card, the plain engine on the CPU."""
    if device.type == "cuda":
        return CudaPoseidonEngine(device)
    return TorchPoseidonEngine(device)


def bench_poseidon(batch: int, total: int, mode: str = "pairs",
                   pipeline: Optional[bool] = None, device="cuda") -> Dict:
    """One reference config (benchmark.cpp:213-235): ``total`` hashes fed
    ``batch`` at a time.

    Batches up to :data:`COALESCE_MAX_BATCH` go through
    :class:`CoalescingPoseidonEngine` by default: calls arrive host-side
    batch by batch, as in the reference's loop, and fuse into large
    launches.  Host staging and uploads stay inside the timed region (the
    reference's numbers include its per-call copies too).
    ``pipeline=False`` forces the synchronous path on operands already on
    the device.  The config's last output is held against the plain sponge
    on the same device (``bit_exact``); a mismatch raises."""
    device = torch.device(device)
    iters = max(1, total // batch)
    if pipeline is None:
        pipeline = batch <= COALESCE_MAX_BATCH
    l_h, r_h = _rand_digits(batch, 42), _rand_digits(batch, 43)
    l, r = _on(l_h, device), _on(r_h, device)
    if pipeline:
        eng = CoalescingPoseidonEngine(_engine(device))

        def run_config():
            if mode == "pairs":
                outs = [eng.async_hash_pairs(l_h, r_h) for _ in range(iters)]
            else:
                outs = [eng.async_hash_single(l_h) for _ in range(iters)]
            eng.flush()
            return outs[-1].get()

        st = time_fn_stats(run_config, device=device, iters=3, warmup=2,
                           groups=3)
        st = {k: v / iters for k, v in st.items()}
        last = run_config()
    else:
        def run_batch():
            if mode == "pairs":
                return pc.hash_pair_cuda(l, r)
            return pc.hash_single_cuda(l)

        st = time_fn_stats(run_batch, device=device, iters=iters, warmup=2)
        last = run_batch()
    want = poseidon.hash_pair(l, r) if mode == "pairs" else poseidon.hash_single(l)
    if not torch.equal(last, want):
        raise ComputationError(
            f"poseidon {mode} batch {batch}: output disagrees with the plain sponge"
        )
    sec = st["mean_s"]
    hps = batch / sec
    key = f"poseidon_{mode}_hashes_per_s"
    return {
        "suite": "poseidon",
        "mode": mode,
        "path": "cuda" if device.type == "cuda" else "torch",
        "pipelined": bool(pipeline),
        "batch": batch,
        "total_hashes": iters * batch,
        "ns_per_hash": sec / batch * 1e9,
        "hashes_per_s": hps,
        "hashes_per_s_p50": batch / st["p50_s"],
        "hashes_per_s_best": batch / st["min_s"],
        "vs_baseline": hps / BASELINES[key],
        "bit_exact": True,
        "card": card(device),
    }


def bench_poseidon_resident(batch: int, total: int, mode: str = "pairs",
                            samples: int = 3, device="cuda") -> Dict:
    """Device-loop row for one reference config: operands on the device
    and the batch loop chained there (``ops.hash_*_cuda_loop``: each
    iteration's output feeds the next input, so none can be skipped), with
    one wait at the end.  The companion of ``bench_poseidon``'s coalesced
    row, which carries the host staging and uploads."""
    device = torch.device(device)
    iters = max(1, total // batch)
    l = _on(_rand_digits(batch, 42), device)
    r = _on(_rand_digits(batch, 43), device)

    def loop(n):
        if mode == "pairs":
            return pc.hash_pair_cuda_loop(l, r, n)
        return pc.hash_single_cuda_loop(l, n)

    # Two chained iterations must equal two plain applications.
    want = (
        poseidon.hash_pair(poseidon.hash_pair(l, r), r)
        if mode == "pairs"
        else poseidon.hash_single(poseidon.hash_single(l))
    )
    if not torch.equal(loop(2), want):
        raise ComputationError("device loop diverges from the plain path")

    st = time_fn_stats(lambda: loop(iters), device=device, iters=samples,
                       warmup=1, groups=samples)
    sec = st["mean_s"] / iters  # per batch
    key = f"poseidon_{mode}_hashes_per_s"
    return {
        "suite": "poseidon_resident",
        "mode": mode,
        "batch": batch,
        "total_hashes": iters * batch,
        "device_loop_iters": iters,
        "ns_per_hash": sec / batch * 1e9,
        "hashes_per_s": batch / sec,
        "hashes_per_s_best": batch * iters / st["min_s"],
        "config_ms": st["mean_s"] * 1e3,
        "vs_baseline": batch / sec / BASELINES[key],
        "card": card(device),
    }


def bench_merkle_build(n_leaves: int, arity: int, iters: int = 3,
                       device="cuda") -> Dict:
    """Build of an ``n_leaves`` tree with ``merkle.NaryMerkleTree`` from
    leaves already on the device."""
    device = torch.device(device)
    leaves = _on(_rand_digits(n_leaves, 11), device)
    cfg = merkle.MerkleConfig(arity)

    def build():
        return merkle.NaryMerkleTree(leaves, cfg, device=device)

    st = time_fn_stats(build, device=device, iters=iters, warmup=1,
                       groups=iters)
    ms = st["mean_s"] * 1e3
    out = {
        "suite": "merkle_build",
        "leaves": n_leaves,
        "arity": arity,
        "build_ms": ms,
        "build_ms_p50": st["p50_s"] * 1e3,
        "build_ms_min": st["min_s"] * 1e3,
        "leaves_per_s": n_leaves / st["mean_s"],
        "card": card(device),
    }
    if n_leaves == 50_000:
        out["vs_baseline"] = BASELINES["merkle_build_50k_ms"] / ms
    return out


def _print_summary(results: List[Dict], device: torch.device) -> None:
    """Human summary after the JSON lines — the analog of the reference
    binary's speedup tables and best-performer line (benchmark.cpp:81-123)."""
    rows = []
    best_pairs = None
    for r in results:
        s = r["suite"]
        if s in ("poseidon", "poseidon_resident"):
            cfg = f"{r['mode']} batch={r['batch']}"
            if r.get("pipelined"):
                cfg += " (coalesced)"
            rows.append((s, cfg, f"{r['ns_per_hash']:.2f} ns/hash",
                         f"{r['hashes_per_s']:,.0f} hash/s", r["vs_baseline"]))
            if r["mode"] == "pairs" and (
                best_pairs is None or r["hashes_per_s"] > best_pairs[1]
            ):
                best_pairs = (cfg, r["hashes_per_s"])
        elif s == "merkle_build":
            cfg = f"{r['leaves']} leaves a={r['arity']}"
            rows.append((s, cfg, f"{r['build_ms']:.3f} ms",
                         f"{r['leaves_per_s']:,.0f} leaves/s",
                         r.get("vs_baseline")))
    if not rows:
        return
    print(f"\n== Summary ({card(device)}) ==")
    hdr = ("suite", "config", "time", "throughput", "vs baseline")
    cells = [
        [str(c) for c in row[:4]]
        + [f"{row[4]:.3f}x" if isinstance(row[4], float) else "-"]
        for row in rows
    ]
    widths = [max(len(c[i]) for c in cells + [list(hdr)]) for i in range(5)]
    print("  ".join(h.ljust(w) for h, w in zip(hdr, widths)))
    for c in cells:
        print("  ".join(v.ljust(w) for v, w in zip(c, widths)))
    if best_pairs is not None:
        print(f"Best pair-hash throughput: {best_pairs[1]:,.0f} hash/s"
              f" ({best_pairs[0]})")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--suite", default="all",
                        choices=["all", "poseidon", "merkle"])
    parser.add_argument("--mode", default="both",
                        choices=["both", "pairs", "single"])
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--total", type=int, default=None)
    parser.add_argument("--leaves", type=int, default=50_000)
    parser.add_argument("--arity", type=int, default=4)
    parser.add_argument("--skip-verify", action="store_true")
    pipe = parser.add_mutually_exclusive_group()
    pipe.add_argument(
        "--pipeline", action="store_true",
        help="poseidon suite: the coalescing engine for every config",
    )
    pipe.add_argument(
        "--sync", action="store_true",
        help="poseidon suite: device-loop rows (operands on the card, the "
        "batch loop chained there)",
    )
    args = parser.parse_args(argv)
    device = require_cuda()

    results: List[Dict] = []
    if not args.skip_verify:
        ok = verify_paths_match(device=device)
        print(json.dumps({"suite": "verify_paths_match", "ok": ok,
                          "card": card(device)}))
        if not ok:
            raise SystemExit("kernels and plain paths disagree; aborting")

    if args.suite in ("all", "poseidon"):
        modes = ["pairs", "single"] if args.mode == "both" else [args.mode]
        if args.batch:
            configs = [(args.batch, args.total or args.batch * 100, "Custom")]
        else:
            configs = POSEIDON_CONFIGS
        pipeline = True if args.pipeline else None
        for batch, total, label in configs:
            for mode in modes:
                if args.sync:
                    res = bench_poseidon_resident(batch, total, mode,
                                                  device=device)
                else:
                    res = bench_poseidon(batch, total, mode, pipeline,
                                         device=device)
                res["label"] = label
                results.append(res)
                print(json.dumps(res))

    if args.suite in ("all", "merkle"):
        res = bench_merkle_build(args.leaves, args.arity, device=device)
        results.append(res)
        print(json.dumps(res))

    _print_summary(results, device)


if __name__ == "__main__":
    main()
