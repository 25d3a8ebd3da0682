"""Benchmark suite of the port: Poseidon hashing, Merkle builds, proofs,
updates and trees.

The counterpart of the Poseidon, tree-build, proofs, updates and trees
suites of ``cuzk_tpu.bench.run``, on one Hopper card:

- the reference's ``poseidon_benchmark`` configs {10K x 512, 100K x 1024,
  1M x 4096} (benchmark.cpp:213-235), single and pair hashing: small
  batches through the coalescing engine over the CUDA engine, as calls
  arrive from a host one batch at a time, large batches synchronously on
  tensors already on the card; ``--sync`` gives the device-loop rows;
- the Merkle build (50K leaves, arity 4 by default);
- ``proofs``: proof generation, then the batch verify of ``--proofs``
  proofs as a verifier gets them (host numpy in, one bool out, the
  deduplicated schedule by default, ``--no-dedupe`` for the per-proof
  kernel), gated on a 64-proof subset where the verify kernel, the plain
  path and the dedup path must agree; ``--device-resident`` adds the
  verify split into host schedule, upload and device program, and
  ``--tampered`` the failure-isolation row (one tampered proof);
- ``updates``: 64 incremental leaf updates against a rebuild;
- ``trees``: ``merkle.benchmark_tree`` over (1024, 2), (4096, 4), (50K, 8);
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
    python -m cuzk_tpu_torch.bench.run --suite proofs --proofs 5000 \
        --device-resident --tampered
    python -m cuzk_tpu_torch.bench.run --suite updates
    python -m cuzk_tpu_torch.bench.run --suite trees
"""

from __future__ import annotations

import argparse
import dataclasses
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
    "batch_verify_5k_ms": 14.8,
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
                       device="cuda") -> Dict:
    """The reference's batch verify (merkle_tree_cuda.cu:341-465): proofs
    on the host, one all-or-nothing bool out, ``merkle.verify_all`` with
    the schedule build, upload and readback inside the timed region.
    First a gate on a 64-proof subset: the verify kernel on the device,
    the plain path on the host and the dedup path must agree (the
    reference cross-checks its CPU and GPU results inside its benchmark,
    merkle_tree_cuda.cu:648-856); a disagreement raises."""
    device = torch.device(device)
    pos, sib, proved, root = _host_proofs(n_proofs, n_leaves, arity, device)

    def verify():
        return merkle.verify_all(pos, sib, proved, root, arity, dedupe=dedupe,
                                 device=device)

    ok = verify()
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
        "paths_consistent": True,
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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--suite", default="all",
                        choices=["all", "poseidon", "merkle", "proofs",
                                 "updates", "trees"])
    parser.add_argument("--mode", default="both",
                        choices=["both", "pairs", "single"])
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--total", type=int, default=None)
    parser.add_argument("--leaves", type=int, default=50_000)
    parser.add_argument("--arity", type=int, default=4)
    parser.add_argument("--proofs", type=int, default=5_000)
    parser.add_argument("--skip-verify", action="store_true")
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

    if args.suite in ("all", "proofs"):
        shape = (args.proofs, args.leaves, args.arity)
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
            res = row()
            results.append(res)
            print(json.dumps(res), flush=True)

    if args.suite == "updates":
        res = bench_incremental_update(args.leaves, args.arity, device=device)
        results.append(res)
        print(json.dumps(res))
        if not res["roots_consistent"]:
            raise SystemExit("updates: incremental and rebuilt levels differ")

    if args.suite == "trees":
        results.extend(bench_tree_matrix(device=device))

    _print_summary(results, device)


if __name__ == "__main__":
    main()
