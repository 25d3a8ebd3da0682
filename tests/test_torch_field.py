"""The port's plain field layer against the JAX package and the oracle.

``cuzk_tpu_torch.field.fr`` (torch, int64 digits) is held against
``cuzk_tpu.field.fr`` (jnp), ``cuzk_tpu.ops.fieldslab`` run directly on
slabs (as tests/test_pallas.py does) and ``cuzk_tpu.oracle``, on the same
numpy-seeded inputs.  Tolerance: none — every comparison is integer-exact.
The four reduction regimes of tests/test_field.py are covered: high == 0,
small high, large high (reduced operands), and full 256-bit (wrap).
JAX calls stay at batch 8 so they reuse the suite's compiled programs.
"""

import numpy as np
import pytest
import torch

from cuzk_tpu import oracle
from cuzk_tpu.field import fr as jfr
from cuzk_tpu.ops import fieldslab as fs
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda

BATCH = 8
TOP = (1 << 256) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only add overhead beside xdist."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ints(rng, n, bound):
    """n ints uniform in [0, bound) from a numpy generator."""
    words = rng.integers(0, 1 << 32, (n, 9), dtype=np.uint64)
    return [
        sum(int(w) << (32 * i) for i, w in enumerate(row)) % bound
        for row in words
    ]


def regimes(seed):
    """(name, a_ints, b_ints) for the four reduction regimes, 8 pairs each."""
    rng = np.random.default_rng(seed)
    return [
        ("high_zero", _ints(rng, BATCH, 1 << 128), _ints(rng, BATCH, 1 << 128)),
        ("small_high", [v + 1 for v in _ints(rng, BATCH, 10)],
         _ints(rng, BATCH, oracle.P)),
        ("large_high", _ints(rng, BATCH, oracle.P), _ints(rng, BATCH, oracle.P)),
        ("wrap", _ints(rng, BATCH - 4, 1 << 256) + [TOP, TOP, 0, oracle.P - 1],
         _ints(rng, BATCH - 4, 1 << 256) + [TOP, 1, TOP, oracle.P - 1]),
    ]


def as_np(t):
    return np.asarray(t.numpy(), dtype=np.uint32)


def to_slab(xs):
    return jfr.ints_to_array(xs).T.reshape(jfr.NDIGITS, 1, len(xs))


def from_slab(s):
    s = np.asarray(s)
    return jfr.array_to_ints(s.reshape(s.shape[0], -1).T)


BINARY = {
    # port op, JAX fr op, fieldslab op, oracle op
    "mul": (fr.mul, jfr.mul, fs.mul, oracle.mul),
    "add": (fr.add, jfr.add, fs.add_wrap_red, oracle.add),
    "wrap_add": (fr.wrap_add, jfr.wrap_add, None,
                 lambda x, y: (x + y) & TOP),
    "mul_wide": (fr.mul_wide, jfr.mul_wide, fs.mul_wide, lambda x, y: x * y),
    "mul_low": (fr.mul_low, jfr.mul_low, fs.mul_low,
                lambda x, y: (x * y) & TOP),
}
UNARY = {
    "square": (fr.square, jfr.square, fs.square, oracle.square),
    "power5": (fr.power5, jfr.power5, fs.power5, oracle.power5),
    "red": (fr.red, jfr.red, fs.red, oracle.red),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op_matches_jax_slab_and_oracle(op):
    port, jax_op, slab_op, ref = BINARY[op]
    for regime, xs, ys in regimes(11):
        want = [ref(x, y) for x, y in zip(xs, ys)]
        got = port(fr.ints_to_array(xs), fr.ints_to_array(ys))
        assert fr.array_to_ints(got) == want, (op, regime)
        jax_out = jax_op(jfr.ints_to_array(xs), jfr.ints_to_array(ys))
        assert np.array_equal(as_np(got), np.asarray(jax_out)), (op, regime)
        if slab_op is not None:
            assert from_slab(slab_op(to_slab(xs), to_slab(ys))) == want


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_op_matches_jax_slab_and_oracle(op):
    port, jax_op, slab_op, ref = UNARY[op]
    for regime, xs, _ in regimes(12):
        want = [ref(x) for x in xs]
        got = port(fr.ints_to_array(xs))
        assert fr.array_to_ints(got) == want, (op, regime)
        assert np.array_equal(as_np(got), np.asarray(jax_op(jfr.ints_to_array(xs))))
        assert from_slab(slab_op(to_slab(xs))) == want


def test_add_rr_on_reduced_operands():
    for regime, xs, ys in regimes(13):
        xs = [oracle.red(x) for x in xs]
        ys = [oracle.red(y) for y in ys]
        got = fr.add_rr(fr.ints_to_array(xs), fr.ints_to_array(ys))
        assert fr.array_to_ints(got) == [oracle.add(x, y) for x, y in zip(xs, ys)]
        assert np.array_equal(
            as_np(got), np.asarray(jfr.add_rr(jfr.ints_to_array(xs),
                                              jfr.ints_to_array(ys))))
        assert from_slab(fs.add_rr(to_slab(xs), to_slab(ys))) == fr.array_to_ints(got)


@pytest.mark.parametrize("c", sorted(set(oracle.MDS)) + [0, 1, 2, 255, 65535])
def test_mul_small_matches_mul(c):
    xs = [x for _, x_reg, _ in regimes(14) for x in x_reg][:BATCH]
    a = fr.ints_to_array(xs)
    want = [oracle.mul(x, c) for x in xs]
    assert fr.array_to_ints(fr.mul_small(a, c)) == want
    assert np.array_equal(
        as_np(fr.mul_small(a, c)),
        np.asarray(jfr.mul_small(jfr.ints_to_array(xs), np.uint32(c))),
    )
    assert from_slab(fs.mul_small(to_slab(xs), c)) == want


def test_reduce_wide_matches_jax_and_slab():
    for regime, xs, ys in regimes(15):
        prods = [x * y for x, y in zip(xs, ys)]
        w = fr.ints_to_array(prods, ndigits=fr.NDIGITS_WIDE)
        got = fr.reduce_wide(w)
        assert fr.array_to_ints(got) == [oracle.reduce_512(p) for p in prods]
        jw = jfr.ints_to_array(prods, ndigits=jfr.NDIGITS_WIDE)
        assert np.array_equal(as_np(got), np.asarray(jfr.reduce_wide(jw)))
        slab = jw.T.reshape(jfr.NDIGITS_WIDE, 1, len(prods))
        assert from_slab(fs.reduce_wide(slab)) == fr.array_to_ints(got)


def test_mul_truncation_golden():
    a = int("0x123456789abcdef0fedcba987654321011112222333344445555666677778888", 16)
    b = int("0x0fedcba987654321123456789abcdef0aaaabbbbccccddddeeeeffff00001111", 16)
    got = fr.array_to_ints(fr.mul(fr.ints_to_array([a]), fr.ints_to_array([b])))
    assert got == [0x19F690DF510F402FFEF3BF6BFC5F36BF54CAC399B184B355725667A3EEFC6378]


def test_pack16_matches_jax_including_oversized_digits():
    rng = np.random.default_rng(16)
    d = rng.integers(0, 1 << 16, (5, 16)).astype(np.uint32)
    d[1, 3] += np.uint32(1 << 16)  # packing drops what does not fit, as in JAX
    d[2, 0] = np.uint32(0xFFFFFFFF)
    got = fr.pack16(torch.as_tensor(d.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), jfr.pack16(d))
    canon = d & np.uint32(0xFFFF)
    assert np.array_equal(
        fr.unpack16(torch.as_tensor(jfr.pack16(canon).astype(np.int64))).numpy(),
        canon.astype(np.int64),
    )


def test_limbs_carry_digit_values_not_bits():
    rng = np.random.default_rng(17)
    xs = _ints(rng, 4, 1 << 256) + [TOP]
    d = fr.ints_to_array(xs)
    limbs = fr.digits_to_limbs(d)
    assert limbs.dtype == torch.int32
    assert fr.array_to_ints(fr.limbs_to_digits(limbs)) == xs
    words = [[int(w) & 0xFFFFFFFF for w in row] for row in limbs.tolist()]
    assert [sum(w << (32 * i) for i, w in enumerate(row)) for row in words] == xs
    d2 = d.clone()
    d2[0, 5] += 1 << 16  # digit d + 2^16 means value + 2^96
    d2[4, 15] += 1 << 16  # the 2^256 overflow wraps
    back = fr.array_to_ints(fr.limbs_to_digits(fr.digits_to_limbs(d2)))
    assert back[0] == (xs[0] + (1 << 96)) & TOP
    assert back[4] == xs[4]


def test_fr_op_wrapper_runs_plain_on_cpu_tensors():
    for _, xs, ys in regimes(18):
        a, b = fr.ints_to_array(xs), fr.ints_to_array(ys)
        assert torch.equal(poseidon_cuda.fr_op_cuda("mul", a, b), fr.mul(a, b))
        assert torch.equal(poseidon_cuda.fr_op_cuda("mul_small", a, c=26),
                           fr.mul_small(a, 26))
