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


# ---------------------------------------------------------------------------
# sub, geq, eq, is_zero, digits_to_int and the digit constants
# ---------------------------------------------------------------------------

def sub_operands(seed):
    """Pairs with operands >= p, a < b, a == b and the edges."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, oracle.P - 1, oracle.P, oracle.P + 1, TOP]
    xs = edges + _ints(rng, BATCH, 1 << 256) + _ints(rng, 2, oracle.P)
    ys = list(reversed(edges)) + _ints(rng, BATCH, 1 << 256) + xs[-2:]
    return xs, ys


def test_sub_matches_jax_and_oracle():
    xs, ys = sub_operands(19)
    assert any(x < y for x, y in zip(xs, ys)) and xs[-1] == ys[-1]
    got = fr.sub(fr.ints_to_array(xs), fr.ints_to_array(ys))
    assert fr.array_to_ints(got) == [oracle.sub(x, y) for x, y in zip(xs, ys)]
    jax_out = jfr.sub(jfr.ints_to_array(xs), jfr.ints_to_array(ys))
    assert np.array_equal(as_np(got), np.asarray(jax_out))
    from cuzk_tpu_torch import oracle as port_oracle

    assert fr.array_to_ints(got) == [port_oracle.sub(x, y)
                                     for x, y in zip(xs, ys)]


def test_sub_and_geq_read_non_canonical_digits_by_value():
    """A digit >= 2^16 counts by its value (trap (f)), as in every other op
    of the port: (65536 + 1, digit 0 holding 2^16 + 1) - 1 = 2^16.  The JAX
    package's digit-wise borrow reads such a digit on its own (it gives 0
    here), so the comparison with it stays on canonical digits."""
    a = fr.ints_to_array([65537, 5, 3])
    a[0, 0] += 1 << 16
    a[0, 1] -= 1  # same value 65537, digit 0 non-canonical
    a[2, 15] += 1 << 16  # value 3 + 2^256: wraps to 3
    b = fr.ints_to_array([1, 7, 3])
    assert fr.array_to_ints(fr.sub(a, b)) == [
        oracle.sub(65537, 1), oracle.sub(5, 7), oracle.sub(3, 3)]
    assert fr.geq(a, b).tolist() == [True, False, True]


def test_geq_eq_is_zero_match_jax():
    xs, ys = sub_operands(20)
    a, b = fr.ints_to_array(xs), fr.ints_to_array(ys)
    ja, jb = jfr.ints_to_array(xs), jfr.ints_to_array(ys)
    assert fr.geq(a, b).tolist() == np.asarray(jfr.geq(ja, jb)).tolist() == \
        [x >= y for x, y in zip(xs, ys)]
    assert fr.eq(a, b).tolist() == np.asarray(jfr.eq(ja, jb)).tolist() == \
        [x == y for x, y in zip(xs, ys)]
    assert fr.is_zero(a).tolist() == np.asarray(jfr.is_zero(ja)).tolist() == \
        [x == 0 for x in xs]
    assert fr.eq(a, a[3]).tolist() == [x == xs[3] for x in xs]  # broadcasts


def test_digits_to_int_and_constants():
    rng = np.random.default_rng(21)
    for x in [0, 1, oracle.P, TOP] + _ints(rng, 4, 1 << 256):
        d = jfr.int_to_digits(x)
        assert fr.digits_to_int(d) == jfr.digits_to_int(d) == x
        assert fr.digits_to_int(torch.as_tensor(d.astype(np.int64))) == x
        assert fr.digits_to_int(list(d)) == x
    wide = jfr.int_to_digits(TOP * TOP, jfr.NDIGITS_WIDE)
    assert fr.digits_to_int(wide) == TOP * TOP
    with pytest.raises(ValueError):
        fr.digits_to_int(np.zeros((2, 16)))
    for name in ("P_DIGITS", "P2_DIGITS", "P4_DIGITS", "K_DIGITS",
                 "ZERO_DIGITS", "ONE_DIGITS", "TWO_DIGITS"):
        assert np.array_equal(getattr(fr, name), getattr(jfr, name)), name
        assert getattr(fr, name).dtype == np.uint32


def test_field_package_exports_the_jax_names():
    import cuzk_tpu.field as jfield
    import cuzk_tpu_torch.field as field

    assert field.__all__ == jfield.__all__
    for name in field.__all__:
        assert getattr(field, name) is not None


# ---------------------------------------------------------------------------
# BatchFieldArithmetic
# ---------------------------------------------------------------------------

BATCH_OPS = [
    ("batch_add", 2, oracle.add),
    ("batch_subtract", 2, oracle.sub),
    ("batch_multiply", 2, oracle.mul),
    ("batch_square", 1, oracle.square),
    ("batch_power5", 1, oracle.power5),
    ("batch_reduce", 1, oracle.red),
]


@pytest.mark.parametrize("method,arity,ref", BATCH_OPS,
                         ids=[m for m, _, _ in BATCH_OPS])
def test_batch_field_arithmetic_matches_jax(method, arity, ref):
    from cuzk_tpu.field.batch import BatchFieldArithmetic as JBatch
    from cuzk_tpu_torch.field.batch import BatchFieldArithmetic

    xs, ys = sub_operands(22)
    ops = BatchFieldArithmetic(device="cpu")
    jops = JBatch()
    assert ops.initialize() is True and jops.initialize() is True
    args = [fr.ints_to_array(xs), fr.ints_to_array(ys)][:arity]
    jargs = [jfr.ints_to_array(xs), jfr.ints_to_array(ys)][:arity]
    got = getattr(ops, method)(*args)
    want = getattr(jops, method)(*jargs)
    assert np.array_equal(as_np(got), np.asarray(want))
    operands = list(zip(xs, ys)) if arity == 2 else [(x,) for x in xs]
    assert fr.array_to_ints(got) == [ref(*v) for v in operands]
    # Host data with device="cpu", and a lone element (the stats add its
    # leading axis, 16, as the JAX class does).
    getattr(ops, method)(*[np.asarray(a) for a in jargs])
    getattr(jops, method)(*jargs)
    getattr(ops, method)(*[a[0] for a in args])
    getattr(jops, method)(*[a[0] for a in jargs])
    assert ops.stats.total_hashes == jops.stats.total_hashes == 2 * len(xs) + 16
    assert ops.stats.total_time_s > 0 and ops.stats.hashes_per_second > 0
    assert ops.cleanup() is None and jops.cleanup() is None


def test_batch_field_arithmetic_devices(monkeypatch):
    """CPU tensors take the plain ops with no device given; host data with
    no device goes to the card, and raises without one."""
    from cuzk_tpu_torch.field.batch import BatchFieldArithmetic
    from cuzk_tpu_torch.utils import errors

    xs, ys = sub_operands(23)
    a, b = fr.ints_to_array(xs), fr.ints_to_array(ys)
    assert torch.equal(BatchFieldArithmetic().batch_subtract(a, b),
                       fr.sub(a, b))
    assert torch.equal(BatchFieldArithmetic().batch_add(a, b[0]),
                       fr.add(a, b[0]))  # broadcasts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.CudaUnavailableError):
        BatchFieldArithmetic().batch_multiply(np.asarray(a), np.asarray(b))
    with pytest.raises(errors.CudaUnavailableError):
        BatchFieldArithmetic().initialize()


def test_fr_op_sub_runs_plain_on_cpu_tensors():
    xs, ys = sub_operands(24)
    a, b = fr.ints_to_array(xs), fr.ints_to_array(ys)
    assert poseidon_cuda.FR_OPS["sub"] == (9, fr.sub)
    assert torch.equal(poseidon_cuda.fr_op_cuda("sub", a, b), fr.sub(a, b))
