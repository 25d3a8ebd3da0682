"""The port's Python-int oracle against ``cuzk_tpu.oracle``.

``cuzk_tpu_torch.oracle`` is the port's own copy of the specification; every
public function must equal the JAX package's oracle on numpy-seeded random
inputs and on the edges (0, 1, p - 1, p, 2^256 - 1, a < b, operands >= p,
the golden vectors, mt19937_64 past one twist).  Tolerance: none, every
comparison is integer-exact.  The module must import no torch, no numpy
and nothing of ``cuzk_tpu`` (checked in a fresh interpreter).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from cuzk_tpu import oracle as joracle
from cuzk_tpu_torch import oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = joracle.P
TOP = (1 << 256) - 1
EDGES = [0, 1, 2, P - 1, P, P + 1, 2 * P, 5 * P, TOP - 1, TOP]


def randoms(seed, n=12, bits=256):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % (1 << bits)
            for row in words]


def test_imports_no_torch_numpy_or_jax_package():
    code = (
        "import sys\n"
        "import cuzk_tpu_torch.oracle\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'cuzk_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", [
    "P", "K", "M256", "ZERO", "ONE", "TWO", "T", "RATE", "FULL_ROUNDS",
    "PARTIAL_ROUNDS", "TOTAL_ROUNDS", "NUM_ROUND_CONSTANTS", "DS_SINGLE",
    "DS_PAIR", "DS_MULTIPLE", "MDS", "RC", "MIN_ARITY", "MAX_ARITY",
])
def test_constants(name):
    assert getattr(oracle, name) == getattr(joracle, name)


def test_k_is_the_cpu_constant():
    """Trap (a): ...ac96341c4ffffffb, not the reference CUDA code's
    ...4fffffff."""
    assert oracle.K == (1 << 256) % P
    assert oracle.K & 0xFFFFFFFF == 0x4FFFFFFB


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_field_ops(op):
    xs = EDGES + randoms(1)
    ys = list(reversed(EDGES)) + randoms(2)
    pairs = [(a, b) for a in xs for b in ys]
    assert [getattr(oracle, op)(a, b) for a, b in pairs] == \
        [getattr(joracle, op)(a, b) for a, b in pairs]


@pytest.mark.parametrize("op", ["red", "square", "power5"])
def test_unary_field_ops(op):
    xs = EDGES + randoms(3, 32)
    assert [getattr(oracle, op)(x) for x in xs] == \
        [getattr(joracle, op)(x) for x in xs]


def test_sub_pre_adds_p_without_a_reduce():
    """a < b pre-adds p with its 2^256 carry dropped; a >= p stays >= p."""
    assert oracle.sub(0, 1) == P - 1
    assert oracle.sub(TOP, 0) == TOP  # no reduce
    assert oracle.sub(1, TOP) == (1 + P - TOP) % (1 << 256)
    assert oracle.sub(P + 5, P + 5) == 0


def test_reduce_512_drops_the_high_fold():
    """Trap (b), on products whose second fold is non-zero, and the
    high == 0 early-out."""
    prods = [a * b for a, b in zip(randoms(4, 16), randoms(5, 16))]
    prods += [TOP * TOP, (TOP * TOP) >> 1, 12345, P * P]
    assert [oracle.reduce_512(x) for x in prods] == \
        [joracle.reduce_512(x) for x in prods]
    assert any((((x >> 256) * oracle.K) >> 256) for x in prods)


def test_round_constants():
    assert oracle.round_constants() == joracle.round_constants()


def test_permutation_and_sponges():
    states = [[0, 0, 0], [1, 2, 3], [TOP, P, P - 1]] + [
        randoms(6 + i, 3) for i in range(3)]
    for st in states:
        assert oracle.permutation(st) == joracle.permutation(st)
    xs = EDGES[:4] + randoms(9, 4)
    for x in xs:
        assert oracle.hash_single(x) == joracle.hash_single(x)
        assert oracle.hash_pair(x, TOP - x) == joracle.hash_pair(x, TOP - x)
    for w in (0, 1, 2, 3, 5, 8):
        inputs = randoms(10 + w, w) if w else []
        assert oracle.hash_multiple(inputs) == joracle.hash_multiple(inputs)
        for ds in (1, 2, 3):
            assert oracle.sponge(inputs, ds) == joracle.sponge(inputs, ds)
    assert oracle.hash_multiple([]) == 0  # trap (e)


def test_golden_vectors():
    assert oracle.hash_pair(10, 20) == \
        0x2DD359F92D31C747E06C02B360A9F5C761777B285EDCF09724EFEF5CBD51D9BA
    assert oracle.hash_single(42) == \
        0x066E59AED12901E110F7D8459D3C2FA7705B3CE5A5EB1C7593E7E1465F85DAFB


@pytest.mark.parametrize("arity", [2, 3, 4, 8])
def test_trees_and_proofs(arity):
    leaves = randoms(20 + arity, 13)
    assert oracle.empty_hash(arity) == joracle.empty_hash(arity)
    for n in (0, 1, 13, 64):
        assert oracle.padded_leaf_count(n, arity) == \
            joracle.padded_leaf_count(n, arity)
        assert oracle.tree_height(n, arity) == joracle.tree_height(n, arity)
    levels = oracle.build_tree_levels(leaves, arity)
    assert levels == joracle.build_tree_levels(leaves, arity)
    assert oracle.merkle_root(leaves, arity) == joracle.merkle_root(leaves, arity)
    assert oracle.merkle_root([], arity) == joracle.merkle_root([], arity)
    for i in (0, 7, 12):
        proof = oracle.generate_proof(levels, arity, i)
        assert proof == joracle.generate_proof(levels, arity, i)
        idx, path = proof
        assert oracle.verify_proof(idx, path, leaves[i], levels[-1][0], arity)
        assert not oracle.verify_proof(idx, path, leaves[i] ^ 1,
                                       levels[-1][0], arity)
        bad = [arity] + idx[1:]
        assert oracle.verify_proof(bad, path, leaves[i], levels[-1][0], arity) \
            == joracle.verify_proof(bad, path, leaves[i], levels[-1][0], arity)


def test_tree_errors_match():
    for mod in (oracle, joracle):
        with pytest.raises(ValueError):
            mod.build_tree_levels([1], 9)
        with pytest.raises(IndexError):
            mod.generate_proof([], 2, 0)
        with pytest.raises(IndexError):
            mod.generate_proof([[1, 2], [3]], 2, 2)
    assert oracle.verify_proof([0], [], 1, 1, 2) is False


@pytest.mark.parametrize("seed,count", [(42, 1), (42, 700), (7, 313), (0, 5)])
def test_test_leaves_past_one_twist(seed, count):
    """312 draws a twist: 313 and 700 cross one and two."""
    assert oracle.generate_test_leaves(count, seed) == \
        joracle.generate_test_leaves(count, seed)
    assert oracle.mt19937_64(seed, count) == \
        joracle.generate_test_leaves(count, seed)
