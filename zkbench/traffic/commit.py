"""Commit: a closed loop of tree builds, one at a time.

Each request commits the next of ``sets`` distinct leaf sets made on the
device from the seed at set-up: ``merkle.build_tree_levels(leaves,
arity)``, then the root's 16 digits copied to the host.  The check covers
``checked_sets`` of the sets, drawn from the seed: the root of every commit
of theirs, and every row of the levels of one commit of each, also drawn
from the seed, against the trees the reference builds for them.

Parameters: ``sets`` (distinct leaf sets), ``checked_sets``, ``warmup``
(commits before the window), ``metric`` (the name under which the cell
reports the window over the commits completed; ``commit_ms`` unless
given).  Configuration: ``leaves``, ``arity``.
"""

from __future__ import annotations

from zkbench import common, roofline
from zkbench.reference import merkle as ref_merkle


def setup(ctx):
    cfg, params = ctx.config, ctx.params
    n, arity, sets = int(cfg["leaves"]), int(cfg["arity"]), int(params["sets"])
    leaves = common.random_elements(common.generator(ctx.seed, ctx.device),
                                    (sets, n), ctx.device)
    checked = common.host_rng(ctx.seed, 4).choice(
        sets, int(params.get("checked_sets", sets)), replace=False)
    return {
        "ctx": ctx, "arity": arity, "sets": sets, "leaves": leaves,
        "metric": params.get("metric", "commit_ms"),
        "checked": sorted(int(s) for s in checked), "roots": [],
        "sample": common.Reservoir(common.host_rng(ctx.seed, 1)),
    }


def request(state, i: int, record: bool = True) -> None:
    ctx = state["ctx"]
    with ctx.spans("next_input"):
        s = i % state["sets"]
        leaves = state["leaves"][s]
    with ctx.spans("request"):
        levels = ctx.program.build_tree_levels(leaves, state["arity"])
    with ctx.spans("readback"):
        root = levels[-1][0].cpu()
    if record and s in state["checked"]:
        state["roots"].append((s, root))
        state["sample"].offer(s, lambda: levels)


def end_to_end(state, window_s: float, requests: int) -> dict:
    return {state["metric"]: 1e3 * window_s / requests}


def work(state) -> dict:
    n = int(state["leaves"].shape[1])
    return {
        "permutations": roofline.commit_permutations(n, state["arity"]),
        "rows": n + (roofline.padded_leaves(n, state["arity"]) - 1)
        // max(state["arity"] - 1, 1),
    }


def release(state) -> None:
    """Nothing but the outputs kept for the check stays alive."""


def _reference(state, hasher):
    """The reference's levels of each checked set, by set."""
    sets = state["checked"]
    ref = ref_merkle.build_levels(
        hasher, state["leaves"][sets].to(hasher.field.device), state["arity"])
    return {s: [lv[i] for lv in ref] for i, s in enumerate(sets)}


def control(state, hasher) -> None:
    """Every output replaced by what the control (``hasher``) computes for
    the same requests."""
    ref = _reference(state, hasher)
    state["roots"] = [(s, ref[s][-1][0].cpu()) for s, _ in state["roots"]]
    state["sample"].kept = {s: ref[s] for s in state["sample"].kept}


def check(state, hasher) -> dict:
    ref = _reference(state, hasher)
    ref_roots = {s: levels[-1][0].cpu() for s, levels in ref.items()}
    roots_wrong = sum(int(not bool((root == ref_roots[s]).all()))
                      for s, root in state["roots"])
    rows_wrong, rows = 0, 0
    for s, levels in state["sample"].kept.items():
        rows_wrong += common.rows_wrong(levels, ref[s])
        rows += common.levels_rows(ref[s])
    return {
        "roots_wrong": (roots_wrong, 0),
        "rows_wrong": (rows_wrong, 0),
        "_compared": {"roots": len(state["roots"]), "rows": rows,
                      "sets_checked": len(state["sample"].kept)},
    }
