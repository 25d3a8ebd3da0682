"""Sampled commit: a closed loop of commits of ``trees`` trees, one at a
time, each after one fresh leaf is written into each tree; checked on a
seeded sample of rows, so that the check works at any size.

Set-up makes one ``[trees, leaves, 16]`` tensor of canonical leaves on the
device from the seed.  Each request writes one canonical leaf into each
tree, at an index and with a value drawn on the device from the seed (a
value equal to the old one gets its lowest bit flipped, so no two commits
hash the same leaves), and logs the writes as (request, index and old value
of each tree); then it calls ``merkle.build_tree_levels(leaves[t], arity)``
for each tree in turn and copies every root to the host.

The check keeps the levels of one commit of the window, drawn from the
seed.  It rebuilds that commit's leaves from the final ones by undoing the
later writes of the log, and compares, in every tree and at every level
L >= 1, the program's row with the reference's hash of the row's children
(the rebuilt leaves at L = 1, the program's own level L - 1 above) at these
rows: ``sample_rows`` rows drawn from the seed, the level's first and last
row (the end of the index range, where a 32-bit index would wrap), every
row on the path from the commit's written leaf to the root, and the whole
level wherever it has no more rows than the sample.  The root read back for
that commit counts as one more row of the top level.  Both counts have the
limit 0:

- ``rows_wrong``: the rows that differ; a missing or misshapen level counts
  all its rows, as does a level whose children's level is misshapen, and an
  extra level counts its own;
- ``stale_roots``: a tree whose root read back equals its root at the
  commit before, although that commit wrote a new leaf into it (every
  commit of the run, the warm-up's too).

What the sample cannot see: a wrong row outside the sample and off the
kept commit's written paths.  Each row is judged against the program's own
children, so a wrong row does not show in its parent either.  That is
accepted because the reference cannot rebuild a tree of 10^8 permutations
within a run (the plain permutation runs some 61,000 states a second on
the card); a fault spread over a level, a stale or missing tree, a wrong
root and the end of the index range all fall in the sample.

Parameters: ``sample_rows`` (``SAMPLE_ROWS`` unless given), ``warmup``,
``metric`` (the name under which the cell reports the window over the
commits completed; ``commit_ms`` unless given).  Configuration:
``leaves``, ``arity``, ``trees`` (1 unless given).
"""

from __future__ import annotations

import numpy as np
import torch

from zkbench import common, roofline
from zkbench.reference import merkle as ref_merkle

SAMPLE_ROWS = 4096


def setup(ctx):
    cfg, params = ctx.config, ctx.params
    n, arity = int(cfg["leaves"]), int(cfg["arity"])
    trees = int(cfg.get("trees", 1))
    leaves = common.random_elements(common.generator(ctx.seed, ctx.device),
                                    (trees, n), ctx.device)
    return {
        "ctx": ctx, "n": n, "arity": arity, "trees": trees, "leaves": leaves,
        "writes": common.generator(ctx.seed, ctx.device, 1),
        "sample_rows": int(params.get("sample_rows", SAMPLE_ROWS)),
        "metric": params.get("metric", "commit_ms"),
        "log": [], "roots": [],
        "sample": common.Reservoir(common.host_rng(ctx.seed, 1)),
    }


def request(state, i: int, record: bool = True) -> None:
    ctx, leaves, trees = state["ctx"], state["leaves"], state["trees"]
    with ctx.spans("next_input"):
        g = state["writes"]
        idx = torch.randint(0, state["n"], (trees,), generator=g,
                            device=ctx.device)
        new = common.random_elements(g, (trees,), ctx.device)
        each = torch.arange(trees, device=ctx.device)
        old = leaves[each, idx]
        # Flipping the lowest bit keeps the top digit, so the value stays
        # canonical.
        new[:, 0] ^= (new == old).all(dim=-1).to(new.dtype)
        leaves[each, idx] = new
        state["log"].append((i, idx, old))
    with ctx.spans("request"):
        levels = [ctx.program.build_tree_levels(leaves[t], state["arity"])
                  for t in range(trees)]
    with ctx.spans("readback"):
        roots = torch.stack([lv[-1][0] for lv in levels]).cpu()
    state["roots"].append((i, roots))
    if record:
        state["sample"].offer("commit", lambda: (i, levels, roots))


def end_to_end(state, window_s: float, requests: int) -> dict:
    return {state["metric"]: 1e3 * window_s / requests}


def work(state) -> dict:
    n, arity, trees = state["n"], state["arity"], state["trees"]
    return {
        "permutations": trees * roofline.commit_permutations(n, arity),
        "rows": trees * (n + (roofline.padded_leaves(n, arity) - 1)
                         // max(arity - 1, 1)),
    }


def release(state) -> None:
    """Nothing but the outputs kept for the check stays alive."""


def _sizes(state) -> list:
    """The rows of each level, level 0 the padded leaves."""
    m = ref_merkle.padded_count(state["n"], state["arity"])
    sizes = [m]
    while m > 1:
        m //= state["arity"]
        sizes.append(m)
    return sizes


def _shaped(levels, level: int, rows: int) -> bool:
    return (level < len(levels)
            and tuple(getattr(levels[level], "shape", ())) == (rows, 16))


def _leaf_rows(state, hasher, kept: int, t: int, cols: np.ndarray,
               written: dict) -> torch.Tensor:
    """Tree ``t``'s level 0 at the commit of request ``kept``, at the
    indices ``cols``: the final leaves with every later write undone,
    newest first (``written``: each request's indices on the host), and
    ``empty_hash`` past the leaves."""
    dev = hasher.field.device
    n = state["n"]
    src = torch.as_tensor(np.minimum(cols, n - 1), device=state["leaves"].device)
    out = state["leaves"][t, src].to(dev)
    pad = np.nonzero(cols >= n)[0]
    if pad.size:
        out[torch.as_tensor(pad, device=dev)] = ref_merkle.empty_hash(
            hasher, state["arity"])
    for j, idx, old in reversed(state["log"]):
        if j <= kept:
            break
        hit = np.nonzero(cols == written[j][t])[0]
        if hit.size:
            out[torch.as_tensor(hit, device=dev)] = old[t].to(dev)
    return out


def _judged(state, hasher):
    """The kept commit ``(request, levels, roots)``, the judged rows
    ``[(tree, level, rows, children groups)]`` and the count of rows that
    cannot be judged."""
    i, levels, roots = state["sample"].kept["commit"]
    every = torch.stack([idx for _, idx, _ in state["log"]]).cpu().numpy()
    written = {j: every[r] for r, (j, _, _) in enumerate(state["log"])}
    sizes, arity, k = _sizes(state), state["arity"], state["sample_rows"]
    rng = common.host_rng(state["ctx"].seed, 2)
    dev = hasher.field.device
    span = np.arange(arity)
    judged, unjudged = [], 0
    for t, tree in enumerate(levels):
        unjudged += sum(int(getattr(lv, "shape", (0,))[0])
                        for lv in tree[len(sizes):])
        for level in range(1, len(sizes)):
            m = sizes[level]
            if not (_shaped(tree, level, m)
                    and (level == 1 or _shaped(tree, level - 1, m * arity))):
                unjudged += m
                continue
            if m <= k:
                rows = np.arange(m)
            else:
                rows = np.unique(np.concatenate([
                    rng.choice(m, k, replace=False),
                    [0, m - 1, int(written[i][t]) // arity ** level]]))
            cols = (rows[:, None] * arity + span[None, :]).reshape(-1)
            if level == 1:
                children = _leaf_rows(state, hasher, i, t, cols, written)
            else:
                below = tree[level - 1]
                children = below[torch.as_tensor(cols, device=below.device)].to(dev)
            judged.append((t, level, rows, children.reshape(-1, arity, 16)))
    return (i, levels, roots), judged, unjudged


def _hash(hasher, judged) -> list:
    """The hasher's row of each judged group set, in one batch."""
    if not judged:
        return []
    out = hasher.hash_multiple(torch.cat([g for *_, g in judged]))
    return list(torch.split(out, [g.shape[0] for *_, g in judged]))


def control(state, hasher) -> None:
    """The kept commit's judged rows and its roots replaced by what the
    control (``hasher``) computes from the same children."""
    if "commit" not in state["sample"].kept:
        return
    (i, levels, roots), judged, _ = _judged(state, hasher)
    top = len(_sizes(state)) - 1
    roots = roots.clone()
    for (t, level, rows, _), want in zip(judged, _hash(hasher, judged)):
        lv = levels[t][level]
        lv[torch.as_tensor(rows, device=lv.device)] = want.to(lv.device)
        if level == top:
            roots[t] = want[0].cpu()
    state["sample"].kept["commit"] = (i, levels, roots)


def check(state, hasher) -> dict:
    stale = sum(int((a == b).all(dim=-1).sum())
                for (_, a), (_, b) in zip(state["roots"], state["roots"][1:]))
    sizes = _sizes(state)
    if "commit" not in state["sample"].kept:
        return {"rows_wrong": (state["trees"] * sum(sizes[1:]), 0),
                "stale_roots": (stale, 0),
                "_compared": {"rows": 0, "commits": len(state["roots"])}}
    (i, levels, roots), judged, wrong = _judged(state, hasher)
    dev = hasher.field.device
    rows_judged = 0
    for (t, level, rows, _), want in zip(judged, _hash(hasher, judged)):
        lv = levels[t][level]
        got = lv[torch.as_tensor(rows, device=lv.device)].to(dev)
        wrong += int((got != want).any(dim=-1).sum())
        rows_judged += len(rows)
        if level == len(sizes) - 1:
            wrong += int(not bool((roots[t].to(dev) == want[0]).all()))
    return {
        "rows_wrong": (wrong, 0),
        "stale_roots": (stale, 0),
        "_compared": {"rows": rows_judged, "commits": len(state["roots"]),
                      "kept_request": i, "trees": state["trees"]},
    }
