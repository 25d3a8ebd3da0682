"""Benchmark suite of the port: Poseidon hashing, Merkle builds, proofs,
updates, trees, the sharded build's scaling, the plain-against-accelerated
comparison, the arity sweep and the hardware verification.

The counterpart of ``cuzk_tpu.bench.run``, on one Hopper card:

- the reference's ``poseidon_benchmark`` configs {10K x 512, 100K x 1024,
  1M x 4096} (benchmark.cpp:213-235), single and pair hashing: small
  batches through the coalescing engine over the CUDA engine, as calls
  arrive from a host one batch at a time, large batches synchronously on
  tensors already on the card; ``--sync`` gives the device-loop rows;
- the Merkle build (50K leaves, arity 4 by default), then the largest
  published build, 1,048,576 leaves at arity 8;
- ``proofs``: proof generation, then the batch verify of ``--proofs``
  proofs as a verifier gets them (host numpy in, one bool out, the
  deduplicated schedule by default, ``--no-dedupe`` for the per-proof
  kernel), gated on a 64-proof subset where the verify kernel, the plain
  path and the dedup path must agree; ``--device-resident`` adds the
  verify split into host schedule, upload and device program, and
  ``--tampered`` the failure-isolation row (one tampered proof);
- ``updates``: 64 incremental leaf updates against a rebuild;
- ``trees``: ``merkle.benchmark_tree`` over (1024, 2), (4096, 4), (50K, 8);
- ``scaling``: the sharded build (``parallel.distributed``) on ``--devices``
  ranks, one process a rank, launched by ``bench.mp_scaling``; ``--weak``
  sweeps 1, 2, 4, ... ranks at ``--leaves`` leaves a rank.  Ranks take card
  ``rank % cards``; when they share a card their contexts are time-sliced
  and ``efficiency_serialized`` is the ratio to read;
- ``compare``: the accelerated build against the plain one
  (``merkle.engine_path("plain")``) on the same device, with the trees
  held equal in the run (the reference's benchmark_cuda_vs_cpu_merkle,
  merkle_tree_cuda.cu:648-856);
- ``sweep``: builds at arities 2-8 x 64-4,096 leaves, and a per-proof
  verify of 256 proofs at the largest size per arity, which must all
  verify (test_merkle_benchmark.cpp:39-235);
- ``verify``: the hardware verification: the port's oracle, its native
  oracle, the plain path and the kernels on the same random inputs, the
  golden vectors, builds against the native oracle, K3 and the dedup verify,
  honest and tampered, and with ``--stress`` a 262,144-leaf arity-8 tree;
  it writes a JSON artifact (``--verify-out``) and exits non-zero on any
  failed check;
- a cross-implementation gate before any suite (the reference gates its
  whole benchmark binary, benchmark.cpp:137-144): every kernel entry point
  against its plain version, the raw permutation included.

Timing: warm-up outside the timer; inside it the host clock runs until
``torch.cuda.synchronize()`` returns.  ``--device`` picks the device (the
card by default, which raises without one); ``--device cpu`` runs every
suite on the plain versions, for tests of the plumbing only — CPU numbers
are not device metrics.  ``--path plain`` runs the poseidon suite on the
plain versions on the chosen device.  Results print as JSON lines, each
naming the card, then a summary table.

Usage:
    python -m cuzk_tpu_torch.bench.run --suite all
    python -m cuzk_tpu_torch.bench.run --suite poseidon --mode pairs
    python -m cuzk_tpu_torch.bench.run --suite merkle --leaves 50000 --arity 4
    python -m cuzk_tpu_torch.bench.run --suite proofs --proofs 5000 \
        --device-resident --tampered
    python -m cuzk_tpu_torch.bench.run --suite updates
    python -m cuzk_tpu_torch.bench.run --suite trees
    python -m cuzk_tpu_torch.bench.run --suite scaling --weak --devices 4 \
        --leaves 262144 --arity 8
    python -m cuzk_tpu_torch.bench.run --suite compare --leaves 50000 --arity 4
    python -m cuzk_tpu_torch.bench.run --suite sweep
    python -m cuzk_tpu_torch.bench.run --suite verify --stress \
        --verify-out chiprun_out/CUDA_VERIFY.json
    python -m cuzk_tpu_torch.bench.run --suite verify --device cpu --skip-verify
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cuzk_tpu_torch import merkle, native, oracle, poseidon
from cuzk_tpu_torch.bench import mp_scaling
from cuzk_tpu_torch.engine import (
    CoalescingPoseidonEngine,
    CudaPoseidonEngine,
    PoseidonEngine,
    TorchPoseidonEngine,
)
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda as pc
from cuzk_tpu_torch.utils.device import (
    nvidia_smi_name_power,
    require_cuda,
    resolve_device,
)
from cuzk_tpu_torch.utils.errors import ComputationError

# A100 reference numbers (README.md:131-143, SURVEY.md §6).
BASELINES = {
    "poseidon_pairs_hashes_per_s": 2_145_027.0,
    "poseidon_single_hashes_per_s": 1_751_596.0,
    "merkle_build_50k_ms": 282.0,
    "batch_verify_5k_ms": 14.8,
}

# Reference poseidon_benchmark configs (benchmark.cpp:213-235).
POSEIDON_CONFIGS = [
    (512, 10_000, "Small Scale"),
    (1024, 100_000, "Medium Scale"),
    (4096, 1_000_000, "Large Scale"),
]

# The largest published build: 1,048,576 leaves at arity 8 (padded to
# 8^7 = 2,097,152: 7 sponge launches of 262,144 down to 1 group).
NORTH_STAR_BUILD = (1_048_576, 8)

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


def time_fn(fn: Callable, *args, device, iters: int = 10,
            warmup: int = 2) -> float:
    """Mean seconds per iteration (see :func:`time_fn_stats`)."""
    return time_fn_stats(fn, *args, device=device, iters=iters,
                         warmup=warmup)["mean_s"]


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


PATHS = ("kernel", "plain")


def _hash_fns(path: str):
    """(single, pair) hash functions of ``path``: the kernels' entry points
    (which run the plain versions on CPU tensors), or the plain sponge."""
    if path == "kernel":
        return pc.hash_single_cuda, pc.hash_pair_cuda
    return poseidon.hash_single, poseidon.hash_pair


def _engine(device: torch.device, path: str = "kernel") -> PoseidonEngine:
    """The kernels' engine on a card, the plain engine on the CPU or for
    ``path="plain"``."""
    if path == "kernel" and device.type == "cuda":
        return CudaPoseidonEngine(device)
    return TorchPoseidonEngine(device)


def bench_poseidon(batch: int, total: int, mode: str = "pairs",
                   pipeline: Optional[bool] = None, device="cuda",
                   path: str = "kernel") -> Dict:
    """One reference config (benchmark.cpp:213-235): ``total`` hashes fed
    ``batch`` at a time.

    Batches up to :data:`COALESCE_MAX_BATCH` go through
    :class:`CoalescingPoseidonEngine` by default: calls arrive host-side
    batch by batch, as in the reference's loop, and fuse into large
    launches.  Host staging and uploads stay inside the timed region (the
    reference's numbers include its per-call copies too).
    ``pipeline=False`` forces the synchronous path on operands already on
    the device.  ``path="plain"`` runs the plain sponge on the device
    (synchronously unless ``pipeline=True``), the analog of the JAX
    suite's ``--path jnp``.  The config's last output is held against the
    plain sponge on the same device (``bit_exact``); a mismatch raises."""
    device = torch.device(device)
    iters = max(1, total // batch)
    if pipeline is None:
        pipeline = path == "kernel" and batch <= COALESCE_MAX_BATCH
    l_h, r_h = _rand_digits(batch, 42), _rand_digits(batch, 43)
    l, r = _on(l_h, device), _on(r_h, device)
    if pipeline:
        eng = CoalescingPoseidonEngine(_engine(device, path))

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
        single_fn, pair_fn = _hash_fns(path)

        def run_batch():
            if mode == "pairs":
                return pair_fn(l, r)
            return single_fn(l)

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
        "path": "cuda" if path == "kernel" and device.type == "cuda" else "torch",
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


def _host_proofs(n_proofs: int, n_leaves: int, arity: int, device):
    """A tree of ``n_leaves`` seeded leaves built on ``device``, and the
    proofs of leaves ``arange(n_proofs) % n_leaves`` landed on the host as
    a verifier receives them: positions int32, siblings, leaves and root
    uint32 digits."""
    leaves = _on(_rand_digits(n_leaves, 13), device)
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity),
                                 device=device)
    idx = torch.as_tensor(np.arange(n_proofs) % n_leaves, device=device)
    pos, sib = tree.generate_batch_proofs(idx)
    return (
        pos.cpu().numpy(),
        sib.cpu().numpy().astype(np.uint32),
        tree.levels[0][idx].cpu().numpy().astype(np.uint32),
        tree.get_root_hash().cpu().numpy().astype(np.uint32),
    )


def bench_proof_generation(n_proofs: int, n_leaves: int, arity: int,
                           iters: int = 10, device="cuda") -> Dict:
    """``generate_batch_proofs`` of ``n_proofs`` seeded random leaves of a
    tree on the device, landed on the host (MerkleUtils::benchmark_tree's
    proof_generation_time_ms, merkle_tree.cpp:399-440)."""
    device = torch.device(device)
    leaves = _on(_rand_digits(n_leaves, 13), device)
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity),
                                 device=device)
    idx = torch.as_tensor(
        np.random.default_rng(19).integers(0, n_leaves, n_proofs),
        device=device,
    )

    def gen():
        pos, sib = tree.generate_batch_proofs(idx)
        return pos.cpu().numpy(), sib.cpu().numpy()

    st = time_fn_stats(gen, device=device, iters=iters, warmup=1,
                       groups=iters)
    pos, sib = gen()
    return {
        "suite": "proof_generation",
        "proofs": n_proofs,
        "leaves": n_leaves,
        "arity": arity,
        "proof_levels": int(pos.shape[1]),
        "proof_bytes": int(pos.nbytes + sib.nbytes),
        "gen_ms": st["mean_s"] * 1e3,
        "gen_ms_p50": st["p50_s"] * 1e3,
        "gen_ms_min": st["min_s"] * 1e3,
        "proofs_per_s": n_proofs / st["mean_s"],
        "card": card(device),
    }


def bench_batch_verify(n_proofs: int, n_leaves: int, arity: int,
                       iters: int = 10, dedupe: Optional[bool] = None,
                       device="cuda", gate: bool = True) -> Dict:
    """The reference's batch verify (merkle_tree_cuda.cu:341-465): proofs
    on the host, one all-or-nothing bool out, ``merkle.verify_all`` with
    the schedule build, upload and readback inside the timed region.
    With ``gate``, first a check on a 64-proof subset: the verify kernel
    on the device, the plain path on the host and the dedup path must
    agree (the reference cross-checks its CPU and GPU results inside its
    benchmark, merkle_tree_cuda.cu:648-856); a disagreement raises.
    ``paths_consistent`` is None when the gate did not run."""
    device = torch.device(device)
    pos, sib, proved, root = _host_proofs(n_proofs, n_leaves, arity, device)

    def verify():
        return merkle.verify_all(pos, sib, proved, root, arity, dedupe=dedupe,
                                 device=device)

    ok = verify()
    if gate:
        k_sub = min(64, n_proofs)
        sub = (pos[:k_sub], sib[:k_sub], proved[:k_sub], root)
        kernel_sub = merkle._exact(*sub, arity, device)
        plain_sub = merkle._exact(*sub, arity, torch.device("cpu"))
        dedup_sub = merkle.verify_all(*sub, arity, dedupe=True, device=device)
        if not (np.array_equal(kernel_sub, plain_sub)
                and dedup_sub == bool(kernel_sub.all())):
            raise ComputationError(
                "batch-verify paths disagree (kernel vs plain vs dedup)"
            )
    st = time_fn_stats(verify, device=device, iters=iters, warmup=1,
                       groups=iters)
    ms = st["mean_s"] * 1e3
    out = {
        "suite": "batch_verify",
        "proofs": n_proofs,
        "leaves": n_leaves,
        "arity": arity,
        "dedupe": dedupe,
        "all_valid": ok,
        "paths_consistent": True if gate else None,
        "verify_ms": ms,
        "verify_ms_p50": st["p50_s"] * 1e3,
        "verify_ms_min": st["min_s"] * 1e3,
        "proofs_per_s": n_proofs / st["mean_s"],
        "card": card(device),
    }
    if n_proofs == 5_000:
        out["vs_baseline"] = BASELINES["batch_verify_5k_ms"] / ms
        out["vs_baseline_min"] = (BASELINES["batch_verify_5k_ms"]
                                  / out["verify_ms_min"])
    return out


def bench_batch_verify_resident(n_proofs: int, n_leaves: int, arity: int,
                                iters: int = 20, device="cuda") -> Dict:
    """The deduplicated verify split into its phases, each timed alone:
    ``schedule_ms`` the host schedule and packing (``merkle._dedup_pack``),
    ``upload_ms`` the pinned upload of the packed buffer, ``device_ms``
    the device program on the resident buffer (dispatches queued back to
    back, one wait per group), and ``device_sync_ms`` the same with the
    two flags read back after each dispatch."""
    device = torch.device(device)
    pos, sib, proved, root = _host_proofs(n_proofs, n_leaves, arity, device)

    def pack():
        return merkle._dedup_pack(pos, sib, proved, root, arity)

    wire = pack()
    if wire is None:
        raise ComputationError("the dedup gates declined honest proofs")
    sched = time_fn_stats(pack, device=device, iters=iters, warmup=0,
                          groups=iters)
    up = time_fn_stats(lambda: merkle._upload(wire.packed, device),
                       device=device, iters=4 * iters, warmup=1, groups=2)
    packed = merkle._upload(wire.packed, device)

    def dispatch():
        return merkle._dedup_verify_levels(
            arity, wire.sizes, wire.kb, wire.tb, wire.lm16, packed
        )

    ok = bool(dispatch()[0].all())
    dev = time_fn_stats(dispatch, device=device, iters=3 * iters, warmup=1,
                        groups=3)
    start = time.perf_counter()
    for _ in range(iters):
        bool(dispatch()[0].all())
    device_sync_ms = (time.perf_counter() - start) / iters * 1e3
    schedule_ms, upload_ms, device_ms = (
        st["mean_s"] * 1e3 for st in (sched, up, dev)
    )
    software_min = (sched["min_s"] + up["min_s"] + dev["min_s"]) * 1e3
    out = {
        "suite": "batch_verify_resident",
        "proofs": n_proofs,
        "leaves": n_leaves,
        "arity": arity,
        "all_valid": ok,
        "iters": iters,
        "schedule_ms": schedule_ms,
        "schedule_ms_min": sched["min_s"] * 1e3,
        "upload_bytes": int(wire.packed.nbytes),
        "upload_ms": upload_ms,
        "upload_ms_min": up["min_s"] * 1e3,
        "device_ms": device_ms,
        "device_ms_min": dev["min_s"] * 1e3,
        "device_sync_ms": device_sync_ms,
        "software_ms": schedule_ms + upload_ms + device_ms,
        "software_ms_min": software_min,
        "unique_jobs": int(sum(wire.sizes)),
        "card": card(device),
    }
    if n_proofs == 5_000:
        base = BASELINES["batch_verify_5k_ms"]
        out["vs_baseline_device"] = base / device_ms
        out["vs_baseline_software"] = base / out["software_ms"]
        out["vs_baseline_software_min"] = base / software_min
    return out


def bench_batch_verify_tampered(n_proofs: int, n_leaves: int, arity: int,
                                iters: int = 5, device="cuda") -> Dict:
    """Failure isolation: one tampered proof (index ``n_proofs // 2``) in
    an otherwise valid batch.  ``verify_each`` must equal the verify
    kernel's per-proof result; the row times the isolated path, the
    honest batch and the full per-proof kernel path, all from host
    proofs, and records which proofs were flagged."""
    device = torch.device(device)
    pos, sib, proved, root = _host_proofs(n_proofs, n_leaves, arity, device)
    bad = proved.copy()
    tampered = n_proofs // 2
    bad[tampered, 0] ^= 1

    def isolated():
        return merkle.verify_each(pos, sib, bad, root, arity, dedupe=True,
                                  device=device)

    def exact():
        return merkle.verify_each(pos, sib, bad, root, arity, dedupe=False,
                                  device=device)

    def honest():
        return merkle.verify_each(pos, sib, proved, root, arity, dedupe=True,
                                  device=device)

    res = isolated()
    if not np.array_equal(res, exact()):
        raise ComputationError("isolated verdicts diverge from the exact path")
    st_iso, st_ex, st_ok = (
        time_fn_stats(fn, device=device, iters=iters, warmup=1, groups=iters)
        for fn in (isolated, exact, honest)
    )
    return {
        "suite": "batch_verify_tampered",
        "proofs": n_proofs,
        "leaves": n_leaves,
        "arity": arity,
        "tampered_index": tampered,
        "flagged": [int(i) for i in np.flatnonzero(~res)[:8]],
        "isolated_ms": st_iso["mean_s"] * 1e3,
        "isolated_ms_min": st_iso["min_s"] * 1e3,
        "honest_ms": st_ok["mean_s"] * 1e3,
        "honest_ms_min": st_ok["min_s"] * 1e3,
        "full_exact_ms": st_ex["mean_s"] * 1e3,
        "full_exact_ms_min": st_ex["min_s"] * 1e3,
        "isolated_vs_exact_speedup": st_ex["mean_s"] / st_iso["mean_s"],
        "card": card(device),
    }


def bench_incremental_update(n_leaves: int, arity: int, k: int = 64,
                             iters: int = 10, device="cuda") -> Dict:
    """``update_tree_levels`` of ``k`` random leaves of an ``n_leaves``
    tree against rebuilding it (the reference's update_leaf is a rebuild,
    merkle_tree.cpp:290-301); every level of the two must agree."""
    device = torch.device(device)
    leaves = _on(_rand_digits(n_leaves, 28), device)
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity),
                                 device=device)
    idx = np.random.default_rng(29).choice(n_leaves, size=k, replace=False)
    vals = _on(_rand_digits(k, 30), device)
    updated = leaves.clone()
    updated[torch.as_tensor(idx, device=device)] = vals

    def update():
        return merkle.update_tree_levels(tree.levels, arity, idx, vals)

    def rebuild():
        return merkle.build_tree_levels(updated, arity)

    st_up = time_fn_stats(update, device=device, iters=iters, warmup=1,
                          groups=iters)
    st_rb = time_fn_stats(rebuild, device=device, iters=3, warmup=1, groups=3)
    got, want = update(), rebuild()
    consistent = len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want)
    )
    return {
        "suite": "incremental_update",
        "leaves": n_leaves,
        "arity": arity,
        "updates": k,
        "update_ms": st_up["mean_s"] * 1e3,
        "update_ms_min": st_up["min_s"] * 1e3,
        "rebuild_ms": st_rb["mean_s"] * 1e3,
        "rebuild_ms_min": st_rb["min_s"] * 1e3,
        "speedup_vs_rebuild": st_rb["mean_s"] / st_up["mean_s"],
        "roots_consistent": consistent,
        "card": card(device),
    }


TREE_MATRIX = ((1024, 2), (4096, 4), (50_000, 8))


def bench_tree_matrix(configs=TREE_MATRIX, num_proofs: int = 100,
                      device="cuda") -> List[Dict]:
    """``merkle.benchmark_tree`` per (leaves, arity): build, proof
    generation and verify times, one JSON line each."""
    device = torch.device(device)
    out = []
    for n, a in configs:
        r = dataclasses.asdict(
            merkle.benchmark_tree(n, a, num_proofs=num_proofs, device=device)
        )
        r["suite"] = "benchmark_tree"
        r["card"] = card(device)
        out.append(r)
        print(json.dumps(r))
    return out


def bench_merkle_compare(n_leaves: int, arity: int, iters: int = 3,
                         device="cuda") -> Dict:
    """The accelerated build against the plain one on the same device,
    with the two roots held equal in the run: the analog of the
    reference's ``benchmark_cuda_vs_cpu_merkle`` (merkle_tree_cuda.cu:
    648-856) and of ``cuzk_tpu.bench.run.bench_merkle_compare``.  The
    accelerated build is ``merkle.build_tree_levels`` (K1's level loop on a
    card); the plain one the same call under ``merkle.engine_path("plain")``
    (the plain sponge on the same device, timed once).
    ``trees_consistent`` says whether the roots agree; ``main`` exits
    non-zero when they do not."""
    device = torch.device(device)
    leaves = _on(_rand_digits(n_leaves, 11), device)

    def build_fast():
        return merkle.build_tree_levels(leaves, arity)[-1]

    sec_fast = time_fn(build_fast, device=device, iters=iters, warmup=1)
    # The plain build runs once: it compiles nothing to warm up, and at
    # 50,000 leaves it takes seconds (launch-bound on the host).
    start = time.perf_counter()
    with merkle.engine_path("plain"):
        root_plain = merkle.build_tree_levels(leaves, arity)[-1]
    _wait(device)
    sec_plain = time.perf_counter() - start
    consistent = torch.equal(build_fast(), root_plain)
    return {
        "suite": "merkle_compare",
        "leaves": n_leaves,
        "arity": arity,
        "accelerated_ms": sec_fast * 1e3,
        "reference_path_ms": sec_plain * 1e3,
        "speedup": sec_plain / sec_fast,
        "trees_consistent": consistent,
        "card": card(device),
    }


SWEEP_ARITIES = tuple(range(2, 9))
SWEEP_SIZES = (64, 256, 1024, 4096)


def bench_merkle_sweep(arities=SWEEP_ARITIES, sizes=SWEEP_SIZES,
                       proofs: int = 256, device="cuda") -> List[Dict]:
    """Arity and leaf-count sweep, as the reference's benchmark-as-test
    tables (test_merkle_benchmark.cpp:39-235: arities 2-8, sizes 64-4096):
    one build row per (arity, size), then a ``dedupe=False`` verify of
    ``proofs`` proofs at the largest size per arity (the per-proof kernel).
    The verify rows skip :func:`bench_batch_verify`'s gate, whose plain
    host verify costs seconds a row: the sweep holds only that the honest
    proofs all verify (``all_valid``; ``main`` exits non-zero when they do
    not), and the kernel-against-plain check is the ``proofs`` and
    ``verify`` suites'.  One JSON line each."""
    results: List[Dict] = []
    for arity in arities:
        for n in sizes:
            res = bench_merkle_build(n, arity, iters=3, device=device)
            results.append(res)
            print(json.dumps(res))
        res = bench_batch_verify(proofs, sizes[-1], arity, iters=3,
                                 dedupe=False, device=device, gate=False)
        results.append(res)
        print(json.dumps(res))
    return results


# SURVEY.md Appendix A's golden vectors.
GOLDEN_HASH_SINGLE_42 = (
    0x066E59AED12901E110F7D8459D3C2FA7705B3CE5A5EB1C7593E7E1465F85DAFB)
GOLDEN_HASH_PAIR_10_20 = (
    0x2DD359F92D31C747E06C02B360A9F5C761777B285EDCF09724EFEF5CBD51D9BA)
VERIFY_OUT = os.path.join("chiprun_out", "CUDA_VERIFY.json")
# Leaves of the tree on which the verify suite holds the native oracle's
# merkle_root against the Python-int one (past one level at arity 8).
MERKLE_ORACLE_LEAVES = 67


def run_hardware_verify(out_path: str = VERIFY_OUT, stress: bool = False,
                        device=None, batch: int = 256, n_leaves: int = 4099,
                        proofs: int = 512) -> Dict:
    """The hardware verification, written as a JSON artifact to
    ``out_path``: the counterpart of ``cuzk_tpu.bench.run.
    run_hardware_verify`` (the reference's benchmark-gating verifier,
    poseidon_cuda_benchmarks.cpp:137-259), on ``device`` (the card by
    default).  Checks, each a bool in ``checks``:

    - the four-way differential over ``batch`` random 256-bit inputs for
      pairs, single, multiple (4 inputs) and the raw permutation: the
      kernels (K1, K4) and the plain PyTorch path on the device, and the
      native oracle, each against the port's Python-int oracle;
    - the two golden vectors of SURVEY.md Appendix A through the kernels;
    - builds of ``n_leaves`` leaves (not a power of any arity, so the
      empty-hash padding runs) at arity 2, 4 and 8 against the native
      oracle's root, which is held against the Python-int oracle's on the
      first ``MERKLE_ORACLE_LEAVES`` leaves;
    - K3 on ``proofs`` proofs at arity 4, all valid, then with one leaf
      tampered, which must flip exactly its own slot; the deduplicated
      verify on the same proofs, valid and tampered;
    - with ``stress``: a 262,144-leaf arity-8 tree (height 7) and 256 of
      its proofs through K3 and through the dedup verify.

    ``all_ok`` is the and of every check; the artifact names the device
    (the card's nvidia-smi name and power line, or "cpu")."""
    device = resolve_device(device)
    checks: Dict[str, bool] = {}

    def progress(msg: str) -> None:
        print(f"[verify] {msg}", file=sys.stderr, flush=True)

    def ints(t) -> List[int]:
        return fr.array_to_ints(t)

    progress("four-way differential...")
    l_h, r_h = _rand_digits(batch, 21), _rand_digits(batch, 22)
    groups_h = _rand_digits(batch * 4, 23).reshape(batch, 4, fr.NDIGITS)
    states_h = _rand_digits(batch * 3, 24).reshape(batch, 3, fr.NDIGITS)
    l, r = _on(l_h, device), _on(r_h, device)
    groups, states = _on(groups_h, device), _on(states_h, device)
    li, ri = ints(l_h), ints(r_h)
    gi = [ints(g) for g in groups_h]
    si = [ints(st) for st in states_h]
    want = {
        "pairs": [oracle.hash_pair(a, b) for a, b in zip(li, ri)],
        "single": [oracle.hash_single(a) for a in li],
        "multiple": [oracle.hash_multiple(g) for g in gi],
        "permutation": [oracle.permutation(st) for st in si],
    }
    ways = {
        "pairs": {
            "kernel": lambda: ints(pc.hash_pair_cuda(l, r)),
            "plain": lambda: ints(poseidon.hash_pair(l, r)),
            "native": lambda: native.batch_hash_pairs(li, ri),
        },
        "single": {
            "kernel": lambda: ints(pc.hash_single_cuda(l)),
            "plain": lambda: ints(poseidon.hash_single(l)),
            "native": lambda: [native.hash_single(a) for a in li],
        },
        "multiple": {
            "kernel": lambda: ints(pc.hash_multiple_cuda(groups)),
            "plain": lambda: ints(poseidon.hash_multiple(groups)),
            "native": lambda: [native.hash_multiple(g) for g in gi],
        },
        "permutation": {
            "kernel": lambda: [ints(st) for st in pc.permutation_cuda(states)],
            "plain": lambda: [ints(st) for st in poseidon.permutation(states)],
            "native": lambda: [native.permutation(st) for st in si],
        },
    }
    for op, by_way in ways.items():
        for way, fn in by_way.items():
            checks[f"{op}_{way}_vs_oracle"] = fn() == want[op]

    progress("golden vectors...")
    checks["golden_hash_single_42"] = ints(pc.hash_single_cuda(
        fr.ints_to_array([42], device=device)))[0] == GOLDEN_HASH_SINGLE_42
    checks["golden_hash_pair_10_20"] = ints(pc.hash_pair_cuda(
        fr.ints_to_array([10], device=device),
        fr.ints_to_array([20], device=device)))[0] == GOLDEN_HASH_PAIR_10_20

    progress(f"builds of {n_leaves} leaves at arity 2, 4, 8...")
    leaves_h = _rand_digits(n_leaves, 31)
    leaves = _on(leaves_h, device)
    leaf_ints = ints(leaves_h)
    # The native oracle's root stands in for the Python-int one at full
    # size (seconds of Python-int work a tree); the two are held equal on
    # a small tree first.
    small = leaf_ints[:MERKLE_ORACLE_LEAVES]
    checks["merkle_root_native_vs_oracle"] = all(
        native.merkle_root(small, arity) == oracle.merkle_root(small, arity)
        for arity in (2, 4, 8))
    for arity in (2, 4, 8):
        checks[f"build_arity{arity}_vs_oracle"] = (
            ints(merkle.merkle_root(leaves, arity))[0]
            == native.merkle_root(leaf_ints, arity))

    progress(f"K3 and the dedup verify on {proofs} proofs...")
    arity = 4
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity),
                                 device=device)
    idx = torch.as_tensor(np.arange(proofs) * 8 % n_leaves, device=device)
    pos, sib = tree.generate_batch_proofs(idx)
    proved = tree.levels[0][idx]
    root = tree.get_root_hash()
    checks["verify_kernel_all_valid"] = bool(
        merkle.verify_proofs(pos, sib, proved, root, arity).all())
    bad_slot = 7 % proofs
    tampered = proved.clone()
    tampered[bad_slot] ^= 1
    bad = merkle.verify_proofs(pos, sib, tampered, root, arity)
    checks["verify_kernel_detects_tamper"] = (
        torch.nonzero(~bad).flatten().tolist() == [bad_slot])
    checks["dedup_all_valid"] = merkle.verify_all(pos, sib, proved, root,
                                                  arity, dedupe=True)
    checks["dedup_detects_tamper"] = not merkle.verify_all(
        pos, sib, tampered, root, arity, dedupe=True)

    if stress:
        progress("stress: 262,144 leaves at arity 8, 256 proofs...")
        sn, sa = 262_144, 8
        stree = merkle.NaryMerkleTree(_on(_rand_digits(sn, 77), device),
                                      merkle.MerkleConfig(sa), device=device)
        sidx = torch.as_tensor(np.arange(256) * 1021 % sn, device=device)
        spos, ssib = stree.generate_batch_proofs(sidx)
        sproved = stree.levels[0][sidx]
        sroot = stree.get_root_hash()
        checks["stress_256k_height"] = stree.get_tree_height() == 7
        checks["stress_256k_proofs_verify"] = bool(
            merkle.verify_proofs(spos, ssib, sproved, sroot, sa).all())
        checks["stress_256k_dedup_verify"] = merkle.verify_all(
            spos, ssib, sproved, sroot, sa, dedupe=True)

    result = {
        "suite": "hardware_verify",
        "backend": device.type,
        "device": card(device),
        "date": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "n_random_inputs": batch,
        "tree": {"leaves": n_leaves, "arities": [2, 4, 8], "proofs": proofs},
        "stress": stress,
        "checks": checks,
        "all_ok": all(checks.values()),
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"suite": "hardware_verify", "all_ok": result["all_ok"],
                      "artifact": out_path, "card": result["device"]}))
    return result


def bench_sharded_build(n_leaves: int, arity: int,
                        n_devices: Optional[int] = None, iters: int = 3,
                        device=None, timeout_s: float = 1800) -> Dict:
    """The sharded build of ``n_leaves`` seeded leaves on ``n_devices``
    ranks (default 1), one process a rank, on ``device`` (default: the
    card): leaves sharded, local levels, one all-gather, a replicated
    tail.  Throughput counts the padded leaves, with the stages, the
    backend and whether the ranks shared a card beside it."""
    res = mp_scaling.run_build(n_devices or 1, n_leaves, arity, iters,
                               device=device, timeout_s=timeout_s)
    res["suite"] = "sharded_build"
    return res


def bench_weak_scaling(leaves_per_device: int, arity: int,
                       max_devices: Optional[int] = None, iters: int = 3,
                       device=None, timeout_s: float = 1800) -> List[Dict]:
    """Weak-scaling sweep: constant leaves a rank while the mesh grows (1,
    2, 4, ... up to ``max_devices``, default the number of cards).
    ``efficiency`` = throughput(d) / (d x throughput(1)).  Ranks that share
    a card run time-sliced, so their parallel efficiency necessarily decays
    about 1/d; ``efficiency_serialized`` = throughput(d) / throughput(1)
    (ideal 1.0) then says what the sharded program (collectives, staging,
    context switches) adds over the serialized compute.  Read
    ``efficiency`` when each rank owns a card, ``efficiency_serialized``
    when ``shared_card`` is true."""
    if max_devices is None:
        max_devices = (1 if device is not None
                       and torch.device(device).type == "cpu"
                       else torch.cuda.device_count())
    results, base, d = [], None, 1
    while d <= max_devices:
        res = bench_sharded_build(leaves_per_device * d, arity, d, iters,
                                  device=device, timeout_s=timeout_s)
        res["suite"] = "weak_scaling"
        if base is None:
            base = res["leaves_per_s"]
        results.append(mp_scaling.with_efficiency(res, base))
        d *= 2
    return results


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
        elif s == "merkle_compare":
            cfg = f"{r['leaves']} leaves a={r['arity']}"
            rows.append((s, cfg, f"{r['accelerated_ms']:.3f} ms accelerated",
                         f"{r['reference_path_ms']:.3f} ms plain "
                         f"({r['speedup']:.1f}x)", None))
        elif s == "merkle_build":
            cfg = f"{r['leaves']} leaves a={r['arity']}"
            rows.append((s, cfg, f"{r['build_ms']:.3f} ms",
                         f"{r['leaves_per_s']:,.0f} leaves/s",
                         r.get("vs_baseline")))
        elif s in ("sharded_build", "weak_scaling"):
            cfg = (f"{r['leaves']} leaves a={r['arity']} d={r['devices']} "
                   f"({r['backend']}{', shared card' if r['shared_card'] else ''})")
            rate = f"{r['leaves_per_s']:,.0f} padded leaves/s"
            if "efficiency" in r:
                rate += (f", eff {r['efficiency']:.3f}, serialized "
                         f"{r['efficiency_serialized']:.3f}")
            rows.append((s, cfg, f"{r['build_ms']:.3f} ms", rate, None))
        elif s == "proof_generation":
            cfg = f"{r['proofs']} proofs a={r['arity']}"
            rows.append((s, cfg, f"{r['gen_ms']:.3f} ms (min "
                         f"{r['gen_ms_min']:.3f})",
                         f"{r['proofs_per_s']:,.0f} proofs/s", None))
        elif s == "batch_verify":
            cfg = f"{r['proofs']} proofs a={r['arity']}"
            rows.append((s, cfg, f"{r['verify_ms']:.3f} ms (min "
                         f"{r['verify_ms_min']:.3f})",
                         f"{r['proofs_per_s']:,.0f} proofs/s",
                         r.get("vs_baseline")))
        elif s == "batch_verify_resident":
            cfg = f"{r['proofs']} proofs a={r['arity']}"
            rows.append((s, cfg, f"{r['device_ms']:.3f} ms device",
                         f"+{r['schedule_ms']:.3f} ms host "
                         f"+{r['upload_ms']:.3f} ms H2D",
                         r.get("vs_baseline_device")))
        elif s == "batch_verify_tampered":
            cfg = f"1 of {r['proofs']} tampered a={r['arity']}"
            rows.append((s, cfg, f"{r['isolated_ms']:.3f} ms isolated",
                         f"{r['full_exact_ms']:.3f} ms exact, "
                         f"{r['honest_ms']:.3f} ms honest", None))
        elif s == "incremental_update":
            cfg = f"{r['updates']} of {r['leaves']} leaves a={r['arity']}"
            rows.append((s, cfg, f"{r['update_ms']:.3f} ms (min "
                         f"{r['update_ms_min']:.3f})",
                         f"{r['speedup_vs_rebuild']:.2f}x vs rebuild", None))
        elif s == "benchmark_tree":
            cfg = (f"{r['leaf_count']} leaves a={r['arity']} "
                   f"h={r['tree_height']}")
            rows.append((s, cfg, f"{r['build_time_ms']:.3f} ms build",
                         f"+{r['proof_time_ms']:.3f} ms gen "
                         f"+{r['verify_time_ms']:.3f} ms verify", None))
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


def _int_list(text: str) -> List[int]:
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> List[Dict]:
    """The CLI; returns the suites' records (the JSON lines it printed)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--suite", default="all",
                        choices=["all", "poseidon", "merkle", "proofs",
                                 "updates", "trees", "scaling", "compare",
                                 "sweep", "verify"],
                        help="all = poseidon, merkle and proofs; the others "
                        "run when named")
    parser.add_argument(
        "--device", default=None,
        help="where the suites run: the card by default (raises without "
        "one); 'cpu' runs the plain versions (plumbing only, no device "
        "metric)",
    )
    parser.add_argument("--path", default="kernel", choices=PATHS,
                        help="poseidon suite: the kernels, or the plain "
                        "sponge on the chosen device")
    parser.add_argument("--mode", default="both",
                        choices=["both", "pairs", "single"])
    parser.add_argument("--batch", type=int, default=None,
                        help="poseidon suite: a custom batch; verify suite: "
                        "the random inputs of the differential (256)")
    parser.add_argument("--total", type=int, default=None)
    parser.add_argument("--leaves", type=int, default=None,
                        help="leaves of the tree (50,000; verify suite "
                        "4,099; scaling with --weak: a rank's)")
    parser.add_argument("--arity", type=int, default=4)
    parser.add_argument("--proofs", type=int, default=None,
                        help="proofs suite 5,000; sweep 256 a verify; "
                        "verify suite 512")
    parser.add_argument("--arities", type=_int_list, default=None,
                        help="sweep suite: comma-separated arities (2-8)")
    parser.add_argument("--sizes", type=_int_list, default=None,
                        help="sweep suite: comma-separated leaf counts "
                        "(64,256,1024,4096)")
    parser.add_argument("--verify-out", default=VERIFY_OUT,
                        help="verify suite: the artifact's path")
    parser.add_argument("--stress", action="store_true",
                        help="verify suite: add the 262,144-leaf arity-8 "
                        "tier")
    parser.add_argument("--skip-verify", action="store_true")
    parser.add_argument(
        "--devices", type=int, default=None,
        help="scaling suite: ranks of the sharded build (one process each; "
        "with --weak the largest mesh of the sweep)",
    )
    parser.add_argument(
        "--weak", action="store_true",
        help="scaling suite: weak-scaling sweep (--leaves = leaves a rank)",
    )
    parser.add_argument(
        "--no-dedupe", action="store_true",
        help="proofs suite: the per-proof verify kernel, no dedup schedule",
    )
    parser.add_argument(
        "--device-resident", action="store_true",
        help="proofs suite: also the verify split into host schedule, "
        "upload and device program",
    )
    parser.add_argument(
        "--tampered", action="store_true",
        help="proofs suite: also the failure-isolation row (one tampered "
        "proof in a valid batch)",
    )
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
    if args.sync and args.path == "plain":
        parser.error("--sync times the kernels' device loop; --path plain "
                     "has none")
    device = require_cuda() if args.device is None else torch.device(args.device)
    leaves = args.leaves or 50_000

    results: List[Dict] = []

    def emit(res: Dict) -> None:
        results.append(res)
        print(json.dumps(res), flush=True)

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
                                         device=device, path=args.path)
                res["label"] = label
                emit(res)

    if args.suite in ("all", "merkle"):
        for n_leaves, arity in dict.fromkeys(
                [(leaves, args.arity), NORTH_STAR_BUILD]):
            emit(bench_merkle_build(n_leaves, arity, device=device))

    if args.suite in ("all", "proofs"):
        shape = (args.proofs or 5_000, leaves, args.arity)
        rows = [
            lambda: bench_proof_generation(*shape, device=device),
            lambda: bench_batch_verify(
                *shape, dedupe=False if args.no_dedupe else None,
                device=device),
        ]
        if args.device_resident:
            rows.append(lambda: bench_batch_verify_resident(*shape,
                                                            device=device))
        if args.tampered:
            rows.append(lambda: bench_batch_verify_tampered(*shape,
                                                            device=device))
        for row in rows:
            emit(row())

    if args.suite == "updates":
        res = bench_incremental_update(leaves, args.arity, device=device)
        emit(res)
        if not res["roots_consistent"]:
            raise SystemExit("updates: incremental and rebuilt levels differ")

    if args.suite == "trees":
        results.extend(bench_tree_matrix(device=device))

    if args.suite == "compare":
        res = bench_merkle_compare(leaves, args.arity, device=device)
        emit(res)
        if not res["trees_consistent"]:
            raise SystemExit("compare: the plain and accelerated trees differ")

    if args.suite == "sweep":
        rows = bench_merkle_sweep(
            args.arities or SWEEP_ARITIES, args.sizes or SWEEP_SIZES,
            args.proofs or 256, device=device)
        results.extend(rows)
        declined = [r["arity"] for r in rows
                    if r["suite"] == "batch_verify" and not r["all_valid"]]
        if declined:
            raise SystemExit(f"sweep: honest proofs declined at arity "
                             f"{declined}")

    if args.suite == "verify":
        res = run_hardware_verify(
            args.verify_out, stress=args.stress, device=device,
            batch=args.batch or 256, n_leaves=args.leaves or 4099,
            proofs=args.proofs or 512)
        results.append(res)
        if not res["all_ok"]:
            failed = sorted(k for k, v in res["checks"].items() if not v)
            raise SystemExit(f"hardware verification FAILED: {failed}; see "
                             f"{args.verify_out}")

    if args.suite == "scaling":
        if args.weak:
            rows = bench_weak_scaling(leaves, args.arity, args.devices,
                                      device=args.device)
        else:
            rows = [bench_sharded_build(leaves, args.arity, args.devices,
                                        device=args.device)]
        for res in rows:
            emit(res)

    _print_summary(results, device)
    return results


if __name__ == "__main__":
    main()
