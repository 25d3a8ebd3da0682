"""WindowPoSt's partition check: a closed loop of partition verifications,
one at a time, each proof against its own sector's root.

Set-up draws, for each of ``partitions`` partitions and each of its
``sectors`` sectors, ``challenges`` leaf indices uniform in
[0, arity^levels) from the seed, and builds each sector's sparse tree on
the device (``zkbench/reference/post.py::sparse_proofs``): the challenged
leaves, and every child of an on-path group that is on no path, are
elements drawn from the seed; every on-path node is the hash of its
children, hashed by the program (level 1 of ``merkle.build_tree_levels``
over each level's groups).  A sector's proofs share its upper nodes and
its root, ``comm_r_last``.  In each partition a seeded ``tampered_share``
of the proofs has one sibling digit moved, and a seeded
``root_swapped_share`` is paired with another sector's root.  Each
request verifies the next partition, ``merkle.verify_each(positions,
siblings, leaves, roots, arity)`` on the device tensors with ``roots
[k, 16]``, and reads the verdicts back to the host.  ``verify_ms`` is the
window over the requests completed, by the host's clock.

The check runs the reference on every tampered and root-swapped proof and
on ``sample_proofs`` seeded untampered proofs of each partition.
``answers_wrong`` counts every program verdict that differs from what is
wanted (true for an untampered proof, the reference's verdict for the
others), and every sampled untampered proof that the reference rejects,
which pins the set-up's hashing to the reference.

Parameters: ``partitions``, ``tampered_share``, ``root_swapped_share``,
``sample_proofs``, ``warmup``.  Configuration: ``arity``, ``levels``,
``sectors``, ``challenges``.
"""

from __future__ import annotations

import numpy as np
import torch

from zkbench import common, roofline
from zkbench.reference import post


def _program_hash(program, arity: int):
    """``[g, arity, 16] -> [g, 16]`` by the program: level 1 of a build
    over the groups' children."""
    def hash_groups(groups: torch.Tensor) -> torch.Tensor:
        g = groups.shape[0]
        return program.build_tree_levels(
            groups.reshape(g * arity, common.NDIGITS), arity)[1][:g]
    return hash_groups


def setup(ctx):
    cfg, params = ctx.config, ctx.params
    arity, h = int(cfg["arity"]), int(cfg["levels"])
    ns, c = int(cfg["sectors"]), int(cfg["challenges"])
    npart = int(params["partitions"])
    k = ns * c
    t = int(round(k * float(params["tampered_share"])))
    r = int(round(k * float(params["root_swapped_share"])))
    m = min(int(params["sample_proofs"]), k - t - r)
    dev = ctx.device
    g = common.generator(ctx.seed, dev)
    idx = torch.randint(0, arity ** h, (npart, ns, c), generator=g, device=dev)
    order = torch.rand((npart, k), generator=g, device=dev).argsort(dim=1)
    tamper = {
        "rows": order[:, :t],
        "level": torch.randint(0, h, (npart, t), generator=g, device=dev),
        "sibling": torch.randint(0, arity - 1, (npart, t), generator=g, device=dev),
        "digit": torch.randint(0, common.NDIGITS, (npart, t), generator=g, device=dev),
        "delta": torch.randint(1, 1 << 16, (npart, t), generator=g, device=dev),
        "swapped": order[:, t:t + r],
        "other": torch.randint(1, ns, (npart, r), generator=g, device=dev),
    }
    pos, sib, leaves, sector_roots = post.sparse_proofs(
        _program_hash(ctx.program, arity), ctx.seed,
        torch.arange(npart * ns, device=dev), idx.reshape(npart * ns, c),
        arity, h)
    pos, leaves = pos.reshape(npart, k, h), leaves.reshape(npart, k, -1)
    sib = _tampered(sib.reshape(npart, k, h, arity - 1, common.NDIGITS), tamper)
    sector_roots = sector_roots.reshape(npart, ns, -1)
    return {
        "ctx": ctx, "arity": arity, "partitions": npart, "idx": idx,
        "leaves": leaves, "tamper": tamper, "positions": pos, "siblings": sib,
        "roots": _roots(sector_roots, tamper, c),
        "k": k, "judged": order[:, :t + r + m], "altered": t + r,
        "verdicts": [],
    }


def _tampered(sib: torch.Tensor, tamper: dict) -> torch.Tensor:
    """``sib`` with each tampered proof's one sibling digit moved by its
    delta, mod 2^16."""
    rows = tamper["rows"]
    b = torch.arange(sib.shape[0], device=sib.device)[:, None].expand_as(rows)
    at = (b, rows, tamper["level"], tamper["sibling"], tamper["digit"])
    sib[at] = (sib[at] + tamper["delta"]) & 0xFFFF
    return sib


def _roots(sector_roots: torch.Tensor, tamper: dict, c: int) -> torch.Tensor:
    """``[partitions, k, 16]``: each proof's sector root, and for each
    root-swapped proof the root of another sector of its partition."""
    npart, ns = sector_roots.shape[:2]
    roots = sector_roots.repeat_interleave(c, dim=1)
    rows = tamper["swapped"]
    b = torch.arange(npart, device=roots.device)[:, None].expand_as(rows)
    other = (rows // c + tamper["other"]) % ns
    roots[b, rows] = sector_roots[b, other]
    return roots


def request(state, i: int, record: bool = True) -> None:
    ctx = state["ctx"]
    with ctx.spans("next_input"):
        b = i % state["partitions"]
        args = (state["positions"][b], state["siblings"][b],
                state["leaves"][b], state["roots"][b])
    with ctx.spans("request"):
        verdicts = ctx.program.verify_each(*args, state["arity"])
    if record:
        state["verdicts"].append((b, verdicts))


def end_to_end(state, window_s: float, requests: int) -> dict:
    return {"verify_ms": 1e3 * window_s / requests}


def work(state) -> dict:
    _, k, h = state["positions"].shape
    return {
        "permutations": roofline.verify_permutations(k, h, state["arity"]),
        "rows": k * (1 + h * state["arity"]),
    }


def release(state) -> None:
    """Only the judged proofs stay for the check; the partitions go."""
    rows = state["judged"]
    b = torch.arange(rows.shape[0], device=rows.device)[:, None].expand_as(rows)
    state["judged_proofs"] = tuple(
        state.pop(name)[b, rows].flatten(0, 1)
        for name in ("positions", "siblings", "leaves", "roots"))


def _reference_verdicts(state, hasher) -> np.ndarray:
    """``[partitions, judged]`` host bools: the reference's verdict on each
    judged proof, against the root the program was handed."""
    dev = hasher.field.device
    pos, sib, leaves, roots = (x.to(dev) for x in state["judged_proofs"])
    got = post.verify(hasher, pos, sib, leaves, roots, state["arity"])
    return got.reshape(state["judged"].shape).cpu().numpy()


def control(state, hasher) -> None:
    """Every judged proof's verdict replaced by what the control
    (``hasher``) computes for it in the program's place."""
    got = _reference_verdicts(state, hasher)
    rows = state["judged"].cpu().numpy()
    out = []
    for b, v in state["verdicts"]:
        v = np.array(v, dtype=bool)
        if v.shape == (state["k"],):
            v[rows[b]] = got[b]
        out.append((b, v))
    state["verdicts"] = out


def check(state, hasher) -> dict:
    got = _reference_verdicts(state, hasher)
    rows = state["judged"].cpu().numpy()
    altered = state["altered"]
    want = np.ones((state["partitions"], state["k"]), dtype=bool)
    for b in range(want.shape[0]):
        want[b, rows[b, :altered]] = got[b, :altered]
    sample_rejected = int((~got[:, altered:]).sum())
    verdicts_wrong = 0
    for b, v in state["verdicts"]:
        v = np.asarray(v)
        verdicts_wrong += (int((v != want[b]).sum()) if v.shape == want[b].shape
                           else state["k"])
    return {
        # Verdicts that differ from what is wanted, and sampled untampered
        # proofs the reference rejects: one count, so that the control
        # (which replaces the judged verdicts) reads on it.
        "answers_wrong": (verdicts_wrong + sample_rejected, 0),
        "_compared": {"requests": len(state["verdicts"]),
                      "verdicts": sum(len(v) for _, v in state["verdicts"]),
                      "verdicts_wrong": verdicts_wrong,
                      "judged": int(rows.size),
                      "sample_rejected": sample_rejected,
                      "rejected_by_reference": int((~got).sum())},
    }
