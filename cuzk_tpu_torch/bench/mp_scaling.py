"""Weak-scaling benchmark of the sharded Merkle build under
``torch.distributed``, one OS process a rank.

The counterpart of ``cuzk_tpu.bench.mp_scaling``.  The launcher starts its
own workers as fresh interpreters (never a fork of a process that holds a
CUDA context); each worker joins the process group, builds the sharded tree
and times it, then times each stage of the build alone.  Rank 0 prints one
``RESULT`` line.

Ranks take card ``rank % cards``.  On a machine with one card every rank
shares it: the CUDA contexts are time-sliced, so the parallel
``efficiency`` necessarily decays about 1/d and ``efficiency_serialized``
= throughput(d) / throughput(1) (ideal 1.0: what the sharded program adds
over the serialized compute) is the number to read; each row says whether
its ranks shared a card and which backend carried the collectives (NCCL
when each rank owns a card, gloo through host memory otherwise).

Usage (the launcher spawns its own workers; ``--device cpu`` runs the
plain sponge under gloo, for the plumbing only):
    python -m cuzk_tpu_torch.bench.mp_scaling --leaves-per-device 262144 \
        --arity 8 --procs 1 2 4 --out weak_scaling_mp.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cuzk_tpu_torch import merkle
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import _build, poseidon_cuda
from cuzk_tpu_torch.parallel import distributed
from cuzk_tpu_torch.utils.device import nvidia_smi_name_power

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
POLL_S = 0.05


# ---------------------------------------------------------------------------
# Worker: one rank of the job.
# ---------------------------------------------------------------------------

def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_build(leaves, arity: int, mesh, iters: int) -> Dict:
    """The sharded build of ``leaves`` on ``mesh``, warm, then each of its
    stages alone, every one timed to completion on the device.  Returns
    ``build_ms``, the ``stages``, the sponge launches one build makes on
    this rank and the root's digits.  Collective on the mesh: every rank
    calls it with the same leaves."""
    device = mesh.device
    n = len(leaves)
    m = merkle.padded_leaf_count(n, arity)

    def timed(fn, warm: int = 1):
        """(ms a call, the last call's result)."""
        for _ in range(warm):
            fn()
        _wait(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
            _wait(device)
        return (time.perf_counter() - t0) / iters * 1e3, out

    def build():
        # The root read back is the completion barrier: the gather and the
        # tail are replicated, so every rank's levels must have run.
        return distributed.sharded_merkle_root(leaves, arity, mesh).cpu()

    build()  # warm-up (the empty hash of this arity is cached now)
    poseidon_cuda.reset_launch_counts()
    build_ms, root = timed(build, warm=0)
    launches = poseidon_cuda.launch_counts["sponge"] // iters

    stages = {}
    # The coordination floor: one tiny all-gather (one row a rank).
    tiny = fr.zeros((1,), device=device)
    stages["barrier_ms"], _ = timed(lambda: distributed.unshard(tiny, mesh))
    if m % mesh.size == 0:
        stages["shard_ms"], block = timed(
            lambda: distributed._padded_block(leaves, n, m, arity, mesh))
        r = distributed._local_subtrees(m // mesh.size, arity)
        stages["local_levels_ms"], local = timed(
            lambda: merkle._build_levels(block, arity, trees=r))
        stages["gather_ms"], gathered = timed(
            lambda: distributed.unshard(local[-1], mesh))
        stages["replicated_tail_ms"], _ = timed(
            lambda: merkle._build_levels(gathered, arity))
    return {
        "build_ms": build_ms,
        "stages": stages,
        "sponge_launches_per_build": launches,
        "root": np.asarray(root).tolist(),
    }


def join_mesh(store: str, nproc: int, rank: int, device=None):
    """A rank's first steps: join the process group of ``nproc`` ranks whose
    rendezvous is the file ``store`` (in a directory the launcher made for
    this job alone, so two jobs on one host cannot meet), and return the
    mesh over all of them, its transport set up."""
    distributed.initialize_multiprocess("", nproc, rank,
                                        init_method="file://" + store,
                                        device=device)
    mesh = distributed.make_mesh(device=device)
    # A tiny collective first: it sets up the transport while the workers
    # are moments apart, before any of them is deep in its first build.
    distributed.unshard(fr.zeros((1,), device=mesh.device), mesh)
    return mesh


def worker(argv: Sequence[str]) -> None:
    store = argv[0]
    nproc, rank, n_leaves, arity, iters = (int(v) for v in argv[1:6])
    device = None if argv[6] == "card" else argv[6]

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
    mesh = join_mesh(store, nproc, rank, device)

    # The same host value on every rank (shard_batch's contract).
    rng = np.random.default_rng(17)
    leaves = rng.integers(0, 1 << 16, (n_leaves, fr.NDIGITS), dtype=np.uint32)
    res = time_build(leaves, arity, mesh, iters)
    # The build pads the leaf count to the next power of the arity, so the
    # hashed work is m leaves, not the requested count: with arity 8 and
    # 512 leaves a rank, 2 ranks build a 4,096-leaf tree, 8 times the
    # request.  Throughput counts m.
    m = merkle.padded_leaf_count(n_leaves, arity)
    if rank == 0:
        card = "cpu"
        if mesh.device.type == "cuda":
            card = nvidia_smi_name_power().splitlines()[mesh.device.index]
        print("RESULT " + json.dumps({
            "suite": "weak_scaling_mp",
            "processes": nproc,
            "devices": mesh.size,
            "leaves": n_leaves,
            "padded_leaves": m,
            "arity": arity,
            "build_ms": res["build_ms"],
            "leaves_per_s": m / (res["build_ms"] / 1e3),
            "stages": res["stages"],
            "sponge_launches_per_build": res["sponge_launches_per_build"],
            "backend": mesh.backend,
            "shared_card": mesh.shared_card,
            "card": card,
            "root0": res["root"][0],
        }), flush=True)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Launcher: one job per process count, results aggregated.
# ---------------------------------------------------------------------------

def launch(commands: Sequence[Sequence[str]], timeout_s: float,
           env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run ``commands`` as concurrent processes, one a rank, and return
    each one's output (stdout and stderr merged) once all have exited 0.

    Each process writes to its own temp file, not a pipe: a rank whose
    output fills a pipe's buffer would block in the middle of a collective
    while the launcher reads another rank.  When a rank exits non-zero the
    others (left waiting in their next collective) are killed and
    ``RuntimeError`` carries its output; at ``timeout_s`` all are killed
    and ``subprocess.TimeoutExpired`` is raised.  Every process is reaped
    before this returns or raises."""
    logs = [
        tempfile.NamedTemporaryFile("w+", suffix=f".rank{i}.log", delete=False)
        for i in range(len(commands))
    ]
    procs: List[subprocess.Popen] = []

    def output(i: int) -> str:
        logs[i].flush()
        logs[i].seek(0)
        return logs[i].read()

    try:
        for cmd, log in zip(commands, logs):
            procs.append(subprocess.Popen(list(cmd), env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"worker {failed[0]} failed (exit {codes[failed[0]]}):\n"
                    + output(failed[0])
                )
            if all(c == 0 for c in codes):
                return [output(i) for i in range(len(procs))]
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(list(commands[0]), timeout_s)
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()  # reap: no zombies
        for log in logs:
            log.close()
            os.unlink(log.name)


def worker_env() -> Dict[str, str]:
    """The launcher's environment with the package's root on the path."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = REPO_ROOT + (os.pathsep + path if path else "")
    return env


def result_line(out: str) -> Optional[Dict]:
    """The object of the first ``RESULT`` line of a worker's output."""
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return None


def run_build(nproc: int, n_leaves: int, arity: int, iters: int,
              device=None, timeout_s: float = 1800) -> Dict:
    """One job: ``nproc`` ranks build the sharded tree of ``n_leaves``
    seeded leaves on ``device`` (default: the card; ranks take card
    ``rank % cards``) and rank 0's ``RESULT`` row comes back."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if device is None:
        _build.kernels()  # built here once, so that no worker compiles
    with tempfile.TemporaryDirectory() as workdir:
        commands = [
            [sys.executable, "-m", "cuzk_tpu_torch.bench.mp_scaling",
             "--worker", os.path.join(workdir, "store"), str(nproc), str(i),
             str(n_leaves), str(arity), str(iters),
             "card" if device is None else str(device)]
            for i in range(nproc)
        ]
        outs = launch(commands, timeout_s, env=worker_env())
    res = result_line(outs[0])
    if res is None:
        raise RuntimeError("no RESULT line from rank 0:\n" + "\n".join(outs))
    return res


def with_efficiency(res: Dict, base_leaves_per_s: float) -> Dict:
    """``res`` with its weak-scaling ratios against the one-rank rate:
    ``efficiency`` = throughput(d) / (d x throughput(1)) and
    ``efficiency_serialized`` = throughput(d) / throughput(1)."""
    ratio = res["leaves_per_s"] / base_leaves_per_s
    res["efficiency"] = ratio / res["devices"]
    res["efficiency_serialized"] = ratio
    return res


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        worker(argv[1:])
        return
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--leaves-per-device", type=int, default=262_144)
    ap.add_argument("--arity", type=int, default=8)
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain sponge under gloo; default: "
                    "the card")
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact to this path (overwrites)")
    args = ap.parse_args(argv)

    rows = []
    base = None
    # The one-rank reference point first: throughput(1).
    for nproc in dict.fromkeys([1] + args.procs):
        res = run_build(nproc, args.leaves_per_device * nproc, args.arity,
                        args.iters, device=args.device)
        if base is None:
            base = res["leaves_per_s"]
        rows.append(with_efficiency(res, base))
        print(json.dumps(res), flush=True)

    if args.out:
        artifact = {
            "date": time.strftime("%Y-%m-%d"),
            "substrate": (
                f"{rows[0]['card']}; {os.cpu_count()}-core host; "
                "torch.distributed OS processes, one rank a process (per-row "
                "shared_card and backend)"
            ),
            "leaves_per_device": args.leaves_per_device,
            "arity": args.arity,
            "rows": rows,
        }
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
