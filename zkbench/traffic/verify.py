"""Verify: a closed loop of batch proof verifications, one at a time.

Set-up makes ``leaves`` canonical leaves on the device from the seed,
builds their tree with the program (``merkle.build_tree_levels``) and
generates ``batches`` batches of ``proofs`` proofs on the device
(``merkle.generate_proofs``) for seeded uniform leaf indices; in each
batch a seeded ``tampered_share`` of the proofs has one sibling digit
changed.  Each request verifies the next batch,
``merkle.verify_each(positions, siblings, leaves, root, arity)`` on the
device tensors, and reads the per-proof verdicts back to the host.
``verify_ms`` is the window over the requests completed, by the host's
clock: a request's whole latency, the port's host work in it included.

The check rebuilds the tree and the proofs with the reference, tampers
them the same way and compares the set-up's tree and proofs with them row
by row, and every verdict of every request with the reference's: true for
an untampered proof (the reference tree's own path), the reference's
verify for each tampered one.

Parameters: ``batches``, ``proofs``, ``tampered_share``, ``warmup``.
Configuration: ``leaves``, ``arity``.
"""

from __future__ import annotations

import numpy as np
import torch

from zkbench import common, roofline
from zkbench.reference import merkle as ref_merkle


def setup(ctx):
    cfg, params = ctx.config, ctx.params
    n, arity = int(cfg["leaves"]), int(cfg["arity"])
    nb, k = int(params["batches"]), int(params["proofs"])
    t = int(round(k * float(params["tampered_share"])))
    dev = ctx.device
    g = common.generator(ctx.seed, dev)
    leaves = common.random_elements(g, (n,), dev)
    idx = torch.randint(0, n, (nb, k), generator=g, device=dev)
    rows = torch.rand((nb, k), generator=g, device=dev).argsort(dim=1)[:, :t]
    levels = ctx.program.build_tree_levels(leaves, arity)
    h = len(levels) - 1
    tamper = {
        "rows": rows,
        "level": torch.randint(0, h, (nb, t), generator=g, device=dev),
        "sibling": torch.randint(0, arity - 1, (nb, t), generator=g, device=dev),
        "digit": torch.randint(0, common.NDIGITS, (nb, t), generator=g, device=dev),
        "delta": torch.randint(1, 1 << 16, (nb, t), generator=g, device=dev),
    }
    pos, sib = ctx.program.generate_proofs(levels, arity, idx.reshape(-1))
    pos = pos.reshape(nb, k, h)
    sib = _tampered(sib.reshape(nb, k, h, arity - 1, common.NDIGITS), tamper)
    return {
        "ctx": ctx, "arity": arity, "batches": nb, "leaves": leaves,
        "idx": idx, "tamper": tamper, "levels": levels,
        "root": levels[-1][0], "positions": pos, "siblings": sib,
        "proof_leaves": leaves[idx], "verdicts": [],
    }


def _tampered(sib: torch.Tensor, tamper: dict) -> torch.Tensor:
    """``sib`` with each tampered proof's one sibling digit moved by its
    delta, mod 2^16."""
    nb = sib.shape[0]
    b = torch.arange(nb, device=sib.device)[:, None].expand_as(tamper["rows"])
    at = (b, tamper["rows"], tamper["level"], tamper["sibling"], tamper["digit"])
    sib = sib.clone()
    sib[at] = (sib[at] + tamper["delta"].to(sib.device)) & 0xFFFF
    return sib


def request(state, i: int, record: bool = True) -> None:
    ctx = state["ctx"]
    with ctx.spans("next_input"):
        b = i % state["batches"]
        args = (state["positions"][b], state["siblings"][b],
                state["proof_leaves"][b], state["root"])
    with ctx.spans("request"):
        verdicts = ctx.program.verify_each(*args, state["arity"])
    if record:
        state["verdicts"].append((b, verdicts))


def end_to_end(state, window_s: float, requests: int) -> dict:
    return {"verify_ms": 1e3 * window_s / requests}


def work(state) -> dict:
    nb, k, h = state["positions"].shape
    return {
        "permutations": roofline.verify_permutations(k, h, state["arity"]),
        "rows": k * (1 + h * state["arity"]),
    }


def release(state) -> None:
    """Nothing but the outputs kept for the check stays alive."""


def _reference_inputs(state, hasher):
    """The tree, the tampered proofs and the root as the reference makes
    them from the benchmark's leaves, indices and tampering."""
    dev = hasher.field.device
    arity = state["arity"]
    ref_levels = ref_merkle.build_levels(hasher, state["leaves"].to(dev)[None],
                                         arity)
    tree = [lv[0] for lv in ref_levels]
    nb, k = state["idx"].shape
    pos, sib = ref_merkle.gather_proofs(tree, arity,
                                        state["idx"].to(dev).reshape(-1))
    h = pos.shape[1]
    tamper = {name: t.to(dev) for name, t in state["tamper"].items()}
    sib = _tampered(sib.reshape(nb, k, h, arity - 1, common.NDIGITS), tamper)
    return tree, pos.reshape(nb, k, h), sib


def _verdicts(hasher, pos, sib, leaves, root, arity):
    nb, k, h = pos.shape
    return ref_merkle.verify(
        hasher, pos.reshape(nb * k, h),
        sib.reshape(nb * k, h, arity - 1, common.NDIGITS),
        leaves.reshape(nb * k, common.NDIGITS), root, arity,
    ).reshape(nb, k).cpu().numpy()


def _reference_verdicts(state, hasher, tree, pos, sib):
    """The reference's verdict on every proof.  An untampered proof is the
    reference tree's own path, whose recomputation gives the tree's nodes
    and so its root: true by the tree's construction.  Each tampered proof
    is verified by the reference."""
    dev = hasher.field.device
    rows = state["tamper"]["rows"].to(dev)
    nb, t = rows.shape
    b = torch.arange(nb, device=dev)[:, None].expand(nb, t)
    leaves = state["proof_leaves"].to(dev)
    want = np.ones(tuple(pos.shape[:2]), dtype=bool)
    if t:
        got = _verdicts(hasher, pos[b, rows][None].flatten(1, 2),
                        sib[b, rows][None].flatten(1, 2),
                        leaves[b, rows][None].flatten(1, 2), tree[-1][0],
                        state["arity"]).reshape(nb, t)
        want[b.cpu().numpy(), rows.cpu().numpy()] = got
    return want


def control(state, hasher) -> None:
    """Every verdict replaced by what the control (``hasher``) computes
    for the same inputs in the program's place."""
    dev = hasher.field.device
    got = _verdicts(hasher, state["positions"].to(dev),
                    state["siblings"].to(dev), state["proof_leaves"].to(dev),
                    state["root"].to(dev), state["arity"])
    state["verdicts"] = [(b, got[b]) for b, _ in state["verdicts"]]


def check(state, hasher) -> dict:
    dev = hasher.field.device
    tree, pos, sib = _reference_inputs(state, hasher)
    want = _reference_verdicts(state, hasher, tree, pos, sib)
    verdicts_wrong = 0
    for b, v in state["verdicts"]:
        v = np.asarray(v)
        verdicts_wrong += (int((v != want[b]).sum()) if v.shape == want[b].shape
                           else want.shape[1])
    setup_wrong = common.rows_wrong(state["levels"], tree)
    setup_wrong += int((state["positions"].to(dev) != pos).any(dim=-1).sum())
    setup_wrong += int((state["siblings"].to(dev) != sib)
                       .flatten(2).any(dim=-1).sum())
    return {
        # Verdicts that differ from the reference's, and rows of the
        # set-up's tree and proofs that do: one count, so that the control
        # (which replaces the timed verify) reads on it.
        "answers_wrong": (verdicts_wrong + setup_wrong, 0),
        "_compared": {"requests": len(state["verdicts"]),
                      "verdicts": sum(len(v) for _, v in state["verdicts"]),
                      "verdicts_wrong": verdicts_wrong,
                      "setup_rows_wrong": setup_wrong,
                      "rejected_by_reference": int((~want).sum())},
    }
