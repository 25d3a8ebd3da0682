"""The port's plain Poseidon against the JAX package and the oracle.

``cuzk_tpu_torch.poseidon`` is held against ``cuzk_tpu.poseidon`` (whose
``hash_*_pallas`` entry points route to these same jnp functions off the
TPU, poseidon_pallas.py:607, :622) and ``cuzk_tpu.oracle`` on numpy-seeded
inputs, including unreduced inputs (>= p) and a non-canonical digit
d + 2^16, which counts by value.  Tolerance: none (integer-exact).  JAX
calls stay at batch <= 8 and width <= 8, where they share the suite's
compiled sponge programs; width 9 is checked against the oracle.
"""

import numpy as np
import pytest
import torch

from cuzk_tpu import oracle
from cuzk_tpu import poseidon as jpos
from cuzk_tpu.field import fr as jfr
from cuzk_tpu_torch import poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda

CPU = "cpu"  # the CPU tests ask for the plain path by name

BATCH = 4
TOP = (1 << 256) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def digits(rng, shape):
    """Random full-range 256-bit digits (most values are >= p)."""
    return rng.integers(0, 1 << 16, tuple(shape) + (16,)).astype(np.uint32)


def value(d) -> int:
    """Value of one digit vector, digits of any size."""
    return sum(int(v) << (16 * i) for i, v in enumerate(np.asarray(d).tolist())) & TOP


def port(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_round_constants_match_jax_and_oracle():
    assert np.array_equal(poseidon.RC_DIGITS, jpos.RC_DIGITS)
    limbs = poseidon.RC_LIMBS.reshape(-1, 8).astype(np.uint64)
    got = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in limbs]
    assert got == oracle.RC
    assert poseidon.MDS == jpos.MDS


def test_permutation_matches_jax_and_oracle():
    rng = np.random.default_rng(21)
    st = digits(rng, (BATCH, 3))
    st[0] = jfr.ints_to_array([1, 2, 3])
    st[1] = jfr.ints_to_array([TOP, oracle.P, 0])  # round 0 needs the full add
    got = poseidon.permutation(port(st))
    assert np.array_equal(got.numpy(), np.asarray(jpos.permutation(st)))
    for i in range(BATCH):
        want = oracle.permutation([value(st[i, j]) for j in range(3)])
        assert fr.array_to_ints(got[i]) == want


def test_hash_single_and_pair_match_jax_and_oracle():
    rng = np.random.default_rng(22)
    x, y = digits(rng, (BATCH,)), digits(rng, (BATCH,))
    x[0] = jfr.ints_to_array([42])
    y[1, 4] += np.uint32(1 << 16)  # non-canonical digit: counts by value
    single = poseidon.hash_single(port(x))
    pair = poseidon.hash_pair(port(x), port(y))
    assert np.array_equal(single.numpy(), np.asarray(jpos.hash_single(x)))
    assert np.array_equal(pair.numpy(), np.asarray(jpos.hash_pair(x, y)))
    assert fr.array_to_ints(single) == [oracle.hash_single(value(v)) for v in x]
    assert fr.array_to_ints(pair) == [
        oracle.hash_pair(value(a), value(b)) for a, b in zip(x, y)
    ]


@pytest.mark.parametrize("width", [0, 1, 2, 3, 5, 8, 9])
def test_hash_multiple_matches_jax_and_oracle(width):
    rng = np.random.default_rng(100 + width)
    g = digits(rng, (BATCH, width))
    if width:
        g[2, width - 1, 0] += np.uint32(1 << 16)
    got = poseidon.hash_multiple(port(g))
    assert got.shape == (BATCH, 16)
    want = [oracle.hash_multiple([value(v) for v in row]) for row in g]
    assert fr.array_to_ints(got) == want
    if width <= 8:
        assert np.array_equal(got.numpy(), np.asarray(jpos.hash_multiple(g)))
    # The kernel wrapper takes the plain version for CPU tensors.
    assert torch.equal(poseidon_cuda.hash_multiple_cuda(port(g)), got)


def test_golden_vectors():
    ints = fr.ints_to_array
    h = lambda t: fr.array_to_ints(t)[0]  # noqa: E731
    assert h(poseidon.hash_single(ints([42]))) == (
        0x066E59AED12901E110F7D8459D3C2FA7705B3CE5A5EB1C7593E7E1465F85DAFB)
    assert h(poseidon.hash_pair(ints([10]), ints([20]))) == (
        0x2DD359F92D31C747E06C02B360A9F5C761777B285EDCF09724EFEF5CBD51D9BA)
    assert h(poseidon.hash_pair(ints([42]), ints([0]))) == (
        0x0F6E1ADBCD1DE3D6161CD9CFC7DAD8C98D9ACEDC903B3E94C2CC8DF4C3001580)
    assert h(poseidon.hash_multiple(ints([1, 2, 3, 4])[None])) == (
        0x2C12B96D3926E4862876AE9CA67CDDAD85313FA6FA5F266FB7AB683826A6A497)
    assert h(poseidon.hash_multiple(torch.zeros((1, 0, 16), dtype=torch.int64))) == 0
    perm = poseidon.permutation(ints([1, 2, 3])[None])[0]
    assert fr.array_to_ints(perm) == [
        0x07B845866686A60A43F75F0CD778887CC9C304376FCD0B3DE6964E45B9630501,
        0x0EF091199ADBCCB5A4F16D125495A5088EFAD30E7157B84E7429C087D234C932,
        0x157A12C9C56AE74429660DFB6AEBDF9148E6AFB977080BE9C424CCB07472AE04,
    ]


def test_params_reject_other_parameter_sets():
    poseidon.PoseidonParams()
    with pytest.raises(ValueError):
        poseidon.PoseidonParams(full_rounds=6)


def test_cuda_wrappers_take_plain_path_on_cpu():
    rng = np.random.default_rng(23)
    x, y = port(digits(rng, (BATCH,))), port(digits(rng, (BATCH,)))
    assert torch.equal(poseidon_cuda.hash_single_cuda(x), poseidon.hash_single(x))
    assert torch.equal(poseidon_cuda.hash_pair_cuda(x, y), poseidon.hash_pair(x, y))


# ---------------------------------------------------------------------------
# K4's path: the raw permutation through the kernel wrapper and the engine
# ---------------------------------------------------------------------------

def test_permutation_cuda_and_engine_match_jax_and_oracle():
    """``permutation_cuda`` and ``TorchPoseidonEngine.batch_permutation`` on
    CPU tensors against ``cuzk_tpu.ops.permutation_pallas`` and the oracle,
    on canonical states (rows 0-3) and unreduced ones (rows 4-7, values
    >= p: round 0 needs the full wrap add)."""
    from cuzk_tpu.ops import permutation_pallas

    from cuzk_tpu_torch.engine import TorchPoseidonEngine

    rng = np.random.default_rng(24)
    st = digits(rng, (8, 3))
    st[:4] = np.stack([
        jfr.ints_to_array([int(v) % oracle.P for v in row])
        for row in rng.integers(0, 1 << 62, (4, 3)).tolist()
    ])
    st[4] = jfr.ints_to_array([TOP, TOP - oracle.RC[1], oracle.P])
    st[5] = jfr.ints_to_array([oracle.P, oracle.P - 1, 5 * oracle.P])
    got = poseidon_cuda.permutation_cuda(port(st))
    assert torch.equal(TorchPoseidonEngine(device=CPU).batch_permutation(st), got)
    assert np.array_equal(got.numpy(), np.asarray(permutation_pallas(st)))
    for i in range(8):
        assert fr.array_to_ints(got[i]) == oracle.permutation(
            [value(st[i, j]) for j in range(3)])


# ---------------------------------------------------------------------------
# Digits >= 2^32 - 2^16: the port reads them by value, as the oracle does.
# The JAX package keeps digits in uint32 and its column adds wrap at 2^32,
# so there it differs (ROADMAP Queue 3, trap (h)); the JAX package is the
# frozen reference and is not repaired.
# ---------------------------------------------------------------------------

HIGH_DIGIT = 0xFFFFFFFF


def test_permutation_reads_high_digits_by_value():
    rng = np.random.default_rng(25)
    st = digits(rng, (4, 3)).astype(np.int64)
    st[0, 0, 0] = HIGH_DIGIT  # digit 0 of lane 0
    st[1:] += rng.integers((1 << 32) - (1 << 16), 1 << 32, (3, 3, 16))
    got = poseidon.permutation(port(st))
    assert torch.equal(poseidon_cuda.permutation_cuda(port(st)), got)
    for i in range(4):
        assert fr.array_to_ints(got[i]) == oracle.permutation(
            [value(st[i, j]) for j in range(3)])
    # The JAX package wraps the digit at 2^32 and answers otherwise.
    assert fr.array_to_ints(got[0]) != jfr.array_to_ints(
        jpos.permutation(st[:1].astype(np.uint32))[0])


def test_width3_sponge_reads_high_digits_by_value():
    rng = np.random.default_rng(26)
    g = digits(rng, (4, 3)).astype(np.int64)
    g[0, 2, 0] = HIGH_DIGIT  # input 2: absorbed into a non-zero state
    g[1:] += rng.integers((1 << 32) - (1 << 16), 1 << 32, (3, 3, 16))
    got = poseidon.hash_multiple(port(g))
    assert torch.equal(poseidon_cuda.hash_multiple_cuda(port(g)), got)
    assert fr.array_to_ints(got) == [
        oracle.hash_multiple([value(v) for v in row]) for row in g]
    assert fr.array_to_ints(got[0]) != jfr.array_to_ints(
        jpos.hash_multiple(g[:1].astype(np.uint32)))


# ---------------------------------------------------------------------------
# Packed inputs (fr.pack16 words)
# ---------------------------------------------------------------------------

def test_pack16_round_trip_matches_jax():
    rng = np.random.default_rng(27)
    x = digits(rng, (9,))
    xp = fr.pack16(port(x))
    assert xp.shape == (9, 8)
    assert np.array_equal(xp.numpy(), jfr.pack16(x).astype(np.int64))
    assert torch.equal(fr.unpack16(xp), port(x))
    limbs = fr.words_to_limbs(xp)
    assert limbs.dtype == torch.int32
    assert torch.equal(fr.unpack16(limbs), port(x))
    assert torch.equal(limbs, fr.digits_to_limbs(port(x)))


@pytest.mark.parametrize("width", [0, 2, 5])
def test_packed_entry_points_match_unpacked_and_jax(width):
    from cuzk_tpu import ops as jops

    rng = np.random.default_rng(28 + width)
    g = digits(rng, (4, width))
    got = poseidon_cuda.hash_multiple_cuda_packed(fr.pack16(port(g)))
    assert torch.equal(got, poseidon_cuda.hash_multiple_cuda(port(g)))
    assert np.array_equal(
        got.numpy(), np.asarray(jops.hash_multiple_pallas_packed(jfr.pack16(g))))
    if width != 2:
        return
    x, y = digits(rng, (4,)), digits(rng, (4,))
    # int32 bit patterns are taken as well as int64 word values.
    xp = fr.words_to_limbs(fr.pack16(port(x)))
    single = poseidon_cuda.hash_single_cuda_packed(xp)
    assert torch.equal(single, poseidon_cuda.hash_single_cuda(port(x)))
    assert np.array_equal(
        single.numpy(), np.asarray(jops.hash_single_pallas_packed(jfr.pack16(x))))
    pair = poseidon_cuda.hash_pair_cuda_packed(xp, fr.pack16(port(y)))
    assert torch.equal(pair, poseidon_cuda.hash_pair_cuda(port(x), port(y)))
    assert np.array_equal(
        pair.numpy(),
        np.asarray(jops.hash_pair_pallas_packed(jfr.pack16(x), jfr.pack16(y))))


def test_device_loops_take_plain_path_on_cpu():
    rng = np.random.default_rng(29)
    x, y = port(digits(rng, (2,))), port(digits(rng, (2,)))
    assert torch.equal(poseidon_cuda.hash_pair_cuda_loop(x, y, 2),
                       poseidon.hash_pair(poseidon.hash_pair(x, y), y))
    assert torch.equal(poseidon_cuda.hash_single_cuda_loop(x, 2),
                       poseidon.hash_single(poseidon.hash_single(x)))
