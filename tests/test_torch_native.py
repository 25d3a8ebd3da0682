"""The port's native (C++) oracle against ``cuzk_tpu.native`` and the port's
Python-int oracle.

``cuzk_tpu_torch.native`` builds ``native/oracle.cpp`` with g++ at its first
call; each int-level wrapper must equal the JAX package's wrapper of the
same name and ``cuzk_tpu_torch.oracle`` on numpy-seeded random inputs and
on the edges.  A failed build raises ``KernelBuildError`` (no Python
fallback), and ``available()`` is False without a compiler.  Tolerance:
none, every comparison is integer-exact.
"""

import numpy as np
import pytest

from cuzk_tpu import native as jnative
from cuzk_tpu_torch import native, oracle
from cuzk_tpu_torch.utils import errors

P = oracle.P
TOP = (1 << 256) - 1
EDGES = [0, 1, P - 1, P, P + 1, TOP]


def randoms(seed, n=8):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(op):
    xs, ys = EDGES + randoms(1), list(reversed(EDGES)) + randoms(2)
    pairs = [(a, b) for a in xs for b in ys]
    got = [getattr(native, op)(a, b) for a, b in pairs]
    assert got == [getattr(jnative, op)(a, b) for a, b in pairs]
    assert got == [getattr(oracle, op)(a, b) for a, b in pairs]


@pytest.mark.parametrize("op", ["red", "power5", "hash_single"])
def test_unary_ops(op):
    xs = EDGES + randoms(3, 16)
    got = [getattr(native, op)(x) for x in xs]
    assert got == [getattr(jnative, op)(x) for x in xs]
    assert got == [getattr(oracle, op)(x) for x in xs]


def test_permutation():
    states = [[0, 0, 0], [1, 2, 3], [TOP, P, P - 1], randoms(4, 3)]
    for st in states:
        assert native.permutation(st) == jnative.permutation(st) == \
            oracle.permutation(st)


def test_pair_and_multiple_hashes():
    xs, ys = randoms(5), randoms(6)
    assert native.batch_hash_pairs(xs, ys) == jnative.batch_hash_pairs(xs, ys)
    assert native.batch_hash_pairs(xs, ys) == \
        [oracle.hash_pair(a, b) for a, b in zip(xs, ys)]
    assert native.hash_pair(10, 20) == oracle.hash_pair(10, 20) == \
        0x2DD359F92D31C747E06C02B360A9F5C761777B285EDCF09724EFEF5CBD51D9BA
    for w in (0, 1, 2, 5, 8):
        inputs = randoms(7 + w, w)
        assert native.hash_multiple(inputs) == jnative.hash_multiple(inputs) \
            == oracle.hash_multiple(inputs)


@pytest.mark.parametrize("arity", [2, 3, 4, 8])
def test_merkle_root(arity):
    leaves = oracle.generate_test_leaves(37, arity)
    for n in (0, 1, 37):
        assert native.merkle_root(leaves[:n], arity) == \
            jnative.merkle_root(leaves[:n], arity) == \
            oracle.merkle_root(leaves[:n], arity)


def test_values_outside_256_bits_are_refused():
    with pytest.raises(errors.ValidationError):
        native.add(1 << 256, 0)
    with pytest.raises(errors.ValidationError):
        native.red(-1)
    with pytest.raises(errors.ValidationError):
        native.batch_hash_pairs([1, 2], [3])


def test_available_and_build_naming():
    assert native.available()
    path = native.build_oracle()
    assert path.startswith(native.BUILD_DIR) and "libcuzkoracle_" in path
    assert native.build_oracle() == path  # built once per source digest


def test_available_is_false_without_a_compiler(monkeypatch):
    monkeypatch.setattr(native, "CXX", "no-such-compiler-anywhere")
    monkeypatch.setattr(native, "_oracle_lib", None)
    assert native.available() is False


def test_oracle_build_failure_propagates(monkeypatch, tmp_path):
    """A g++ error surfaces as KernelBuildError with the compiler's output,
    from ``available()`` (a compiler is there) and from every wrapper."""
    broken = tmp_path / "oracle.cpp"
    broken.write_text("extern \"C\" void cuzk_add( {\n")
    monkeypatch.setattr(native, "ORACLE_SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_oracle_lib", None)
    with pytest.raises(errors.KernelBuildError, match="error"):
        native.load_oracle()
    with pytest.raises(errors.KernelBuildError):
        native.available()
    with pytest.raises(errors.KernelBuildError):
        native.hash_pair(1, 2)
    assert native._oracle_lib is None


def test_missing_compiler_raises_from_the_wrappers(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", "no-such-compiler-anywhere")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_oracle_lib", None)
    with pytest.raises(errors.KernelBuildError, match="no-such-compiler"):
        native.mul(3, 4)
