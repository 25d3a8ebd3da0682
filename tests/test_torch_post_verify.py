"""Proofs each checked against its own root (``root [k, 16]``), on the CPU:
the port's plain path against the benchmark's plain reference
(``zkbench/reference/post.py``) on sparse trees of several sectors, the
route a host batch of such proofs takes, and the WindowPoSt partition cell
(``filecoin-32g-wpost.verify``) run at its tiny size, sound, as the control
and with faults planted where its answers are produced.

Tolerance: none, every comparison is integer-exact.
"""

import ast
import dataclasses
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuzk_tpu_torch import merkle
from cuzk_tpu_torch.utils import errors, trace
from zkbench.reference import field as ref_field
from zkbench.reference import post
from zkbench.reference import poseidon as ref_poseidon

CPU = "cpu"  # the CPU tests ask for the plain path by name
SEED = 2_147_483_659  # above 2^31, as the benchmark's seeds are
CELL = "filecoin-32g-wpost.verify"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hasher():
    return ref_poseidon.Poseidon(ref_field.Field(torch.device(CPU)))


def sparse_case(hasher, arity, levels, sectors, challenges, seed):
    """Proofs of ``challenges`` seeded leaves in each of ``sectors`` sparse
    trees built by the reference, one root a proof; one leaf challenged
    twice in the first sector."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, arity ** levels, (sectors, challenges), generator=g)
    idx[0, 1] = idx[0, 0]
    pos, sib, leaves, roots = post.sparse_proofs(
        hasher.hash_multiple, seed, torch.arange(10, 10 + sectors), idx, arity,
        levels)
    return pos, sib, leaves, roots.repeat_interleave(challenges, dim=0)


# (arity, levels, sectors, challenges, seed)
SPARSE = [(8, 3, 3, 4, 11), (8, 2, 2, 5, 12), (4, 4, 4, 3, 13)]


@pytest.mark.parametrize("arity,levels,sectors,challenges,seed", SPARSE)
def test_plain_path_with_a_root_a_proof_agrees_with_the_reference(
        hasher, arity, levels, sectors, challenges, seed):
    """Honest proofs verify; a moved sibling digit, a tampered leaf, another
    sector's root and an out-of-range position are judged as the reference
    judges them."""
    pos, sib, leaves, roots = sparse_case(hasher, arity, levels, sectors,
                                          challenges, seed)
    k = pos.shape[0]
    assert post.verify(hasher, pos, sib, leaves, roots, arity).all()
    sib[1, levels - 1, arity - 2, 3] = (sib[1, levels - 1, arity - 2, 3] + 9) & 0xFFFF
    leaves[2, 0] ^= 1
    roots[3] = roots[k - 1]  # another sector's root
    pos = pos.to(torch.int64)
    pos[4, 0] = arity + 2
    want = post.verify(hasher, pos, sib, leaves, roots, arity)
    assert not want[1:5].any() and want[5:].all() and want[0]
    got = merkle.verify_proofs(pos, sib, leaves, roots, arity, device=CPU)
    assert torch.equal(got, want)


def test_the_reference_rebuilds_any_sector_alone_and_the_port_hashes_alike(
        hasher):
    """A sector rebuilt on its own gives the same proofs and root as in the
    whole batch, and hashing each level with the port's build (as the
    cell's set-up does) gives the reference's; a leaf challenged twice has
    one value."""
    g = torch.Generator().manual_seed(7)
    idx = torch.randint(0, 8 ** 3, (3, 4), generator=g)
    idx[1, 3] = idx[1, 0]
    sectors = torch.tensor([5, 9, 40])
    whole = post.sparse_proofs(hasher.hash_multiple, SEED, sectors, idx, 8, 3)
    alone = post.sparse_proofs(hasher.hash_multiple, SEED, sectors[1:2],
                               idx[1:2], 8, 3)
    for a, b in zip(whole[:3], alone[:3]):
        assert torch.equal(a[4:8], b)
    assert torch.equal(whole[3][1:2], alone[3])
    assert torch.equal(whole[2][4], whole[2][7])

    def port_hash(groups):
        n = groups.shape[0]
        return merkle.build_tree_levels(groups.reshape(n * 8, 16), 8,
                                        device=CPU)[1][:n]

    ported = post.sparse_proofs(port_hash, SEED, sectors, idx, 8, 3)
    assert all(torch.equal(a, b) for a, b in zip(whole, ported))
    other = post.sparse_proofs(hasher.hash_multiple, SEED + 1, sectors, idx, 8, 3)
    assert not torch.equal(whole[3], other[3])


def test_seeded_elements_are_canonical_and_follow_seed_and_key():
    keys = torch.arange(1 << 12) * 1_000_003
    a = post.seeded_elements(SEED, keys)
    assert a.shape == (1 << 12, 16) and a.min() >= 0 and a.max() < 1 << 16
    assert (a[:, -1] < post.P_TOP_DIGIT).all()
    assert torch.equal(a[5:9], post.seeded_elements(SEED, keys[5:9]))
    assert not torch.equal(a, post.seeded_elements(SEED + 1, keys))
    assert torch.unique(a, dim=0).shape[0] == a.shape[0]


def test_the_reference_imports_only_torch_and_itself():
    path = post.__file__
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n in ("__future__", "typing", "torch") or n.startswith(
                "zkbench.reference"), n


def test_a_shared_root_and_its_broadcast_give_the_same_verdicts():
    g = torch.Generator().manual_seed(3)
    tree_leaves = torch.randint(0, 1 << 16, (64, 16), generator=g)
    levels = merkle.build_tree_levels(tree_leaves, 4, device=CPU)
    idx = torch.tensor([0, 5, 17, 33, 63, 5])
    pos, sib = merkle.generate_proofs(levels, 4, idx)
    leaves = tree_leaves[idx].clone()
    leaves[2, 1] ^= 1
    root = levels[-1][0]
    wide = root.expand(6, 16).contiguous()
    one = merkle.verify_proofs(pos, sib, leaves, root, 4, device=CPU)
    assert one.tolist() == [True, True, False, True, True, True]
    assert torch.equal(merkle.verify_proofs(pos, sib, leaves, wide, 4,
                                            device=CPU), one)
    host = [x.numpy() for x in (pos, sib, leaves)]
    for r in (root, wide):
        for dedupe in (False, True):
            got = merkle.verify_each(*host, r.numpy(), 4, dedupe=dedupe,
                                     device=CPU)
            assert got.tolist() == one.tolist()
    assert merkle.verify_proof(pos[0], sib[0], leaves[0], wide[:1], 4,
                               device=CPU)
    assert not merkle.verify_all(*host, wide.numpy(), 4, device=CPU)


@pytest.mark.parametrize("shape", [(5, 16), (7, 16), (6, 15), (6, 1, 16), (17,)])
def test_wrong_root_shapes_raise(shape):
    pos = torch.zeros((6, 2), dtype=torch.int64)
    sib = torch.zeros((6, 2, 3, 16), dtype=torch.int64)
    leaves = torch.zeros((6, 16), dtype=torch.int64)
    root = torch.zeros(shape, dtype=torch.int64)
    with pytest.raises(errors.ValidationError, match="disagree"):
        merkle.verify_proofs(pos, sib, leaves, root, 4, device=CPU)
    with pytest.raises(errors.ValidationError, match="disagree"):
        merkle.verify_each(pos.numpy(), sib.numpy(), leaves.numpy(),
                           root.numpy(), 4, device=CPU)


@pytest.mark.parametrize("dedupe", [None, True])
def test_a_root_a_proof_host_batch_takes_the_exact_route(dedupe):
    """64 host proofs of one tree, h = 3: with one root the default takes
    the dedup schedule; with the same root a proof, the exact route, even
    when dedup is asked for."""
    g = torch.Generator().manual_seed(8)
    tree_leaves = torch.randint(0, 1 << 16, (64, 16), generator=g)
    levels = merkle.build_tree_levels(tree_leaves, 4, device=CPU)
    idx = torch.arange(64) * 7 % 64
    pos, sib = merkle.generate_proofs(levels, 4, idx)
    host = [x.numpy() for x in (pos, sib, tree_leaves[idx])]
    root = levels[-1][0].numpy()
    routes = {}
    for name, r in (("shared", root), ("wide", np.tile(root, (64, 1)))):
        with profile(activities=[ProfilerActivity.CPU]):
            ok = merkle.verify_each(*host, r, 4, dedupe=dedupe, device=CPU)
        assert ok.all()
        routes[name] = {k for k in trace.totals()["counters"]
                        if k.startswith("verify.route.")}
    assert routes == {"shared": {"verify.route.dedup"},
                      "wide": {"verify.route.exact"}}


# ---------------------------------------------------------------------------
# The cell at its tiny size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from zkbench import run
    from zkbench.tests.conftest import make_tiny_root

    root = str(tmp_path_factory.mktemp("wpost_tiny"))
    return run.load_cell(CELL, make_tiny_root(root), root)


def run_tiny(cell, program=None, control=False):
    from zkbench import run

    return run.run_cell(cell, SEED, 0.01, False, CPU, time.perf_counter(),
                        control=control, program=program)


class Planted:
    """The port's Merkle entry points with one fault planted where an
    answer of the cell is produced."""

    def __init__(self, fault, levels):
        self.fault = fault
        self.levels = levels
        self.builds = 0

    def build_tree_levels(self, leaves, arity):
        out = merkle.build_tree_levels(leaves, arity)
        self.builds += 1
        if self.fault == "sector_root_altered" and self.builds == self.levels:
            # The last set-up level hashes every sector's root: alter the
            # first sector's of each partition.
            out[1] = out[1].clone()
            out[1][::3, 0] ^= 1
        return out

    def verify_each(self, positions, siblings, leaves, roots, arity):
        if self.fault == "root_row_0":
            roots = roots[0]
        out = merkle.verify_each(positions, siblings, leaves, roots, arity)
        if self.fault == "verdict_flipped":
            out = out.copy()
            out[-1] = not out[-1]
        return out


def test_the_tiny_cell_runs_correct(tiny):
    r = run_tiny(tiny)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["compared"]["sample_rejected"] == 0
    assert r["compared"]["rejected_by_reference"] > 0
    assert set(r["metrics"]) == {"verify_ms", "setup_s"}


def test_the_tiny_cells_control_is_not_correct(tiny):
    r = run_tiny(tiny, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["root_row_0", "verdict_flipped",
                                   "sector_root_altered"])
def test_a_planted_fault_is_not_correct(tiny, fault):
    assert tiny.config["sectors"] == 3
    r = run_tiny(tiny, program=Planted(fault, tiny.config["levels"]))
    assert not r["correct"], (fault, r["checks"])


def test_a_setup_alteration_shows_even_where_the_program_agrees_with_it(tiny):
    """A set-up whose roots are all wrong, with verdicts that match them:
    the sampled untampered proofs that the reference rejects fail the run."""
    kind = tiny.kind
    real_setup = kind.setup

    def setup(ctx):
        state = real_setup(ctx)
        state["roots"][..., 0] ^= 1
        return state

    class Agreeing:
        build_tree_levels = staticmethod(merkle.build_tree_levels)

        @staticmethod
        def verify_each(positions, *rest):
            return np.ones(positions.shape[0], dtype=bool)

    wrapped = dataclasses.replace(
        tiny, kind=types.SimpleNamespace(**{**vars(kind), "setup": setup}))
    r = run_tiny(wrapped, program=Agreeing())
    assert not r["correct"]
    assert r["compared"]["sample_rejected"] > 0
