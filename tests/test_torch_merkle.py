"""The port's Merkle trees against the JAX package and the oracle.

Trees of 16 and 17 leaves at arities 2, 3, 4 and 8 are built by
``cuzk_tpu_torch.merkle`` (plain PyTorch on the CPU) and ``cuzk_tpu.merkle``
from the same numpy-seeded leaves; levels, proofs and ``verify_proofs``
on valid and tampered batches must agree exactly, including a sibling digit
d + 2^16 and an out-of-range position.  Each tree is built once per module.
"""

import functools

import numpy as np
import pytest
import torch

from cuzk_tpu import merkle as jmerkle
from cuzk_tpu import oracle
from cuzk_tpu.field import fr as jfr
from cuzk_tpu_torch import merkle
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.utils import errors

CPU = "cpu"  # the CPU tests ask for the plain path by name

CASES = [(n, a) for n in (16, 17) for a in (2, 3, 4, 8)]
IDS = [f"{n}leaves-arity{a}" for n, a in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def leaves_np(n: int) -> np.ndarray:
    rng = np.random.default_rng(300 + n)
    d = rng.integers(0, 1 << 16, (n, 16)).astype(np.uint32)
    d[:, 15] &= np.uint32(0x2FFF)  # keep most leaves below p
    return d


@functools.lru_cache(maxsize=None)
def trees(n: int, arity: int):
    """(port levels, JAX levels as numpy) for one case, built once."""
    lv = leaves_np(n)
    port = merkle.build_tree_levels(lv, arity, device=CPU)
    ref = [np.asarray(x) for x in jmerkle.build_tree_levels(lv, arity)]
    return port, ref


@pytest.mark.parametrize("n,arity", CASES, ids=IDS)
def test_levels_match_jax(n, arity):
    port, ref = trees(n, arity)
    assert len(port) == len(ref) == merkle.tree_height(n, arity)
    for a, b in zip(port, ref):
        assert np.array_equal(a.numpy(), b.astype(np.int64))
    root = fr.array_to_ints(port[-1])[0]
    assert root == oracle.merkle_root(jfr.array_to_ints(leaves_np(n)), arity)


@pytest.mark.parametrize("n,arity", CASES, ids=IDS)
def test_proofs_match_jax(n, arity):
    port, ref = trees(n, arity)
    idx = list(range(n))
    pos, sib = merkle.generate_proofs(port, arity, idx)
    jpos, jsib = jmerkle.generate_proofs([np.asarray(x) for x in ref], arity, idx)
    assert pos.dtype == torch.int32
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal(sib.numpy(), np.asarray(jsib).astype(np.int64))


def _tampered_batch(port, arity, n):
    """Six valid proofs plus: a leaf digit, a sibling digit, a sibling digit
    d + 2^16 (aliases d mod 2^16) and an out-of-range position."""
    idx = [0, 1, n // 2, n - 1, n - 2, 5]
    pos, sib = merkle.generate_proofs(port, arity, idx)
    leaves = port[0][idx]
    extra = [0, 1, 2, 3]
    pos = torch.cat([pos, pos[extra]])
    sib = torch.cat([sib, sib[extra]])
    leaves = torch.cat([leaves, leaves[extra]])
    leaves[6, 2] ^= 1
    sib[7, 0, 0, 4] ^= 1
    sib[8, -1, arity - 2, 1] += 1 << 16
    pos[9, 0] = arity + 1  # drops the current node, as merkle.py:285 does
    return pos, sib, leaves


@pytest.mark.parametrize("n,arity", CASES, ids=IDS)
def test_verify_matches_jax_on_valid_and_tampered(n, arity):
    port, ref = trees(n, arity)
    pos, sib, leaves = _tampered_batch(port, arity, n)
    got = merkle.verify_proofs(pos, sib, leaves, port[-1][0], arity)
    want = jmerkle.verify_proofs(
        pos.numpy(), sib.numpy().astype(np.uint32),
        leaves.numpy().astype(np.uint32), ref[-1][0], arity,
    )
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == [True] * 6 + [False] * 4


def test_appendix_a_tree_roots():
    ints = fr.ints_to_array
    root = lambda xs, a: fr.array_to_ints(  # noqa: E731
        merkle.merkle_root(ints(xs), a, device=CPU)[None])[0]
    assert root([1, 2], 2) == 0x28C245BFD4D7A4D1EE6BA330337ADC309F013D29C9326C28BA0D3CB47027FCA6
    assert root([1, 2, 3, 4], 2) == 0x236B917229EEEA3EE41C637A7C3CC01F727AC1DC5108C962F564ACC1D8730E44
    assert root([1, 2, 3, 4, 5], 3) == 0x28B819C1EB91377E70ED6E8BBB4C526B9B7ABABAFDCB021E135791FC4F3E25AA
    for a, want in [(2, 0x194324F01EFA21D2DCDD7453800FDE166A852E2906E0E6DE5DE6921EEB77FEEC),
                    (4, 0x1C7842D7703C243A99D6E6CA4033851791B5AE206220FC8C9BCDDE10E5BEFBDD),
                    (8, 0x2CA165C9C68473C20EB293F63DE5986E10A90FB68F6E54BD7932E5166048445D)]:
        assert merkle.empty_hash_int(a) == want
        empty = torch.zeros((0, 16), dtype=torch.int64)
        assert fr.array_to_ints(merkle.merkle_root(empty, a, device=CPU)[None]) == [want]
        assert fr.array_to_ints(
            merkle.merkle_root(np.zeros((0, 16)), a, device=CPU)[None]
        ) == [want]


def test_from_levels_of_a_jax_tree():
    n, arity = 17, 4
    _, ref = trees(n, arity)
    jtree = jmerkle.NaryMerkleTree(leaves_np(n), jmerkle.MerkleConfig(arity))
    tree = merkle.NaryMerkleTree.from_levels(
        [np.asarray(x, np.uint32) for x in jtree.levels], arity, n,
        device=CPU,
    )
    assert tree.get_leaf_count() == n
    assert tree.get_tree_height() == jtree.get_tree_height()
    assert tree.root_int() == jtree.root_int()
    pos, sib = tree.generate_batch_proofs([3, 16])
    jpos, jsib = jtree.generate_batch_proofs([3, 16])
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal(sib.numpy(), np.asarray(jsib).astype(np.int64))
    assert tree.verify_batch_proofs(pos, sib, tree.levels[0][[3, 16]])
    with pytest.raises(errors.ValidationError):
        merkle.NaryMerkleTree.from_levels(ref[:-1], arity, n, device=CPU)


def test_tree_object_and_single_proofs():
    n, arity = 16, 2
    lv = torch.as_tensor(leaves_np(n).astype(np.int64))
    port, _ = trees(n, arity)
    tree = merkle.NaryMerkleTree.from_levels(port, arity, n, device=CPU)
    pos, sib = tree.generate_proof(9)
    assert tree.verify_proof(pos, sib, lv[9])
    assert not tree.verify_proof(pos, sib, lv[8])
    with pytest.raises(errors.IndexError_):
        tree.generate_proof(n)
    with pytest.raises(errors.ValidationError):
        merkle.MerkleConfig(9)


def test_single_leaf_tree_compares_digits():
    leaf = torch.as_tensor(leaves_np(1).astype(np.int64))
    levels = merkle.build_tree_levels(leaf, 2, device=CPU)
    assert len(levels) == 1
    pos, sib = merkle.generate_proofs(levels, 2, [0])
    assert pos.shape == (1, 0) and sib.shape == (1, 0, 1, 16)
    assert merkle.verify_proofs(pos, sib, leaf, levels[-1][0], 2).tolist() == [True]
    other = leaf.clone()
    other[0, 0] ^= 1
    assert merkle.verify_proofs(pos, sib, other, levels[-1][0], 2).tolist() == [False]


def test_helpers_match_jax():
    for n in (0, 1, 999, 1000, 100_000, 100_001):
        assert merkle.optimal_arity(n) == jmerkle.optimal_arity(n)
    for n, a in [(1, 2), (17, 3), (50_000, 4)]:
        assert merkle.padded_leaf_count(n, a) == jmerkle.padded_leaf_count(n, a)
        assert merkle.tree_height(n, a) == jmerkle.tree_height(n, a)
    assert merkle.calculate_max_leaves(5, 4) == jmerkle.calculate_max_leaves(5, 4)
    assert np.array_equal(
        merkle.generate_test_leaves(33, 7).numpy(),
        jmerkle.generate_test_leaves(33, 7).astype(np.int64),
    )


def test_test_leaves_past_one_mt19937_64_twist():
    assert np.array_equal(
        merkle.generate_test_leaves(700, 42).numpy(),
        jmerkle.generate_test_leaves(700, 42).astype(np.int64),
    )
