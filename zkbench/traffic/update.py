"""Update: a closed loop of leaf-write batches on one tree, one at a time.

Set-up makes ``leaves`` canonical leaves on the device from the seed and
builds their tree with the program (``merkle.build_tree_levels``); it
also makes a pool of ``pool`` x ``batch`` new canonical leaves on the
device and ``index_batches`` host arrays of ``batch`` distinct seeded
uniform leaf indices.  Batch ``b`` writes pool row ``b mod pool`` at
index array ``b mod index_batches``:
``merkle.update_tree_levels(levels, arity, indices, values)``, whose new
levels carry forward, then the new root's digits are copied to the host.

The check replays every applied batch on the benchmark's own leaves,
builds the tree after the last with the reference, and compares every row
of it with the program's levels, and its root with the last root read
back.  That covers every write of the run; the roots read back after the
earlier batches are not compared one by one.

Parameters: ``batch``, ``index_batches``, ``pool``, ``warmup``.
Configuration: ``leaves``, ``arity``.
"""

from __future__ import annotations

import numpy as np
import torch

from zkbench import common
from zkbench.reference import merkle as ref_merkle


def distinct_rows(rng: np.random.Generator, rows: int, k: int, n: int) -> np.ndarray:
    """``[rows, k]`` uniform indices below ``n``, distinct within a row."""
    out = rng.integers(0, n, (rows, k), dtype=np.int64)
    while True:
        s = np.sort(out, axis=1)
        bad = np.nonzero((s[:, 1:] == s[:, :-1]).any(axis=1))[0]
        if bad.size == 0:
            return out
        out[bad] = rng.integers(0, n, (bad.size, k), dtype=np.int64)


def setup(ctx):
    cfg, params = ctx.config, ctx.params
    n, arity = int(cfg["leaves"]), int(cfg["arity"])
    k = int(params["batch"])
    g = common.generator(ctx.seed, ctx.device)
    leaves = common.random_elements(g, (n,), ctx.device)
    pool = common.random_elements(g, (int(params["pool"]), k), ctx.device)
    idx = distinct_rows(common.host_rng(ctx.seed, 2),
                        int(params["index_batches"]), k, n)
    return {
        "ctx": ctx, "arity": arity, "leaves": leaves, "pool": pool,
        "idx": idx, "levels": ctx.program.build_tree_levels(leaves, arity),
        "applied": [], "root": None,
    }


def request(state, i: int, record: bool = True) -> None:
    ctx = state["ctx"]
    with ctx.spans("next_input"):
        ix = state["idx"][i % len(state["idx"])]
        vals = state["pool"][i % state["pool"].shape[0]]
    with ctx.spans("request"):
        levels = ctx.program.update_tree_levels(state["levels"], state["arity"],
                                                ix, vals)
    with ctx.spans("readback"):
        root = levels[-1][0].cpu()
    state["levels"] = levels
    state["applied"].append(i)
    if record:
        state["root"] = root


def end_to_end(state, window_s: float, requests: int) -> dict:
    return {"update_ms": 1e3 * window_s / requests}


def work(state) -> dict:
    return {}


def release(state) -> None:
    """Nothing but the outputs kept for the check stays alive."""


def _reference(state, hasher):
    """The reference's tree after every applied batch, from the
    benchmark's leaves and writes."""
    dev = hasher.field.device
    leaves = state["leaves"].to(dev).clone()
    idx = torch.as_tensor(state["idx"], device=dev)
    pool = state["pool"].to(dev)
    for b in state["applied"]:
        leaves[idx[b % idx.shape[0]]] = pool[b % pool.shape[0]]
    return [lv[0] for lv in ref_merkle.build_levels(hasher, leaves[None],
                                                    state["arity"])]


def control(state, hasher) -> None:
    """The levels and the last root replaced by what the control
    (``hasher``) computes for the same writes."""
    state["levels"] = _reference(state, hasher)
    state["root"] = state["levels"][-1][0].cpu()


def check(state, hasher) -> dict:
    ref = _reference(state, hasher)
    root = state["root"]
    return {
        "roots_wrong": (int(root is None
                            or not bool((root == ref[-1][0].cpu()).all())), 0),
        "rows_wrong": (common.rows_wrong(state["levels"], ref), 0),
        "_compared": {"batches_applied": len(state["applied"]),
                      "rows": common.levels_rows(ref)},
    }
