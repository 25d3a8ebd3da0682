"""The port's deduplicated batch verify against the JAX package, on the CPU.

``cuzk_tpu_torch.native`` groups rows as ``cuzk_tpu.native`` does, the
port's ``_dedup_pack`` gives the JAX package's wire byte for byte (both on
the native grouping route), and ``verify_each`` gives the JAX package's
per-proof verdicts on valid batches with duplicate indices, on tampered
batches (failure isolation) and on batches the range gates decline.  The
gates also decline what only the port can be handed: int64 digits and
positions that a uint32 cast would alias (2^32 + d, d - 2^32).

Inputs are numpy-seeded; tolerance: none, every comparison is exact.
Proofs come from the port's plain build; the shapes repeat those of
``tests/test_merkle.py`` so that the JAX package compiles few programs.
"""

import functools

import numpy as np
import pytest
import torch

from cuzk_tpu import merkle as jmerkle
from cuzk_tpu import native as jnative
from cuzk_tpu_torch import merkle, native
from cuzk_tpu_torch.utils import errors

CPU = "cpu"  # the CPU tests ask for the plain path by name


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def leaves_np(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).integers(0, 1 << 16, (n, 16)).astype(np.uint32)
    d[:, 15] &= np.uint32(0x2FFF)  # keep most leaves below p
    return d


@functools.lru_cache(maxsize=None)
def tree(n: int, arity: int):
    lv = leaves_np(n, 900 + 10 * n + arity)
    return merkle.build_tree_levels(torch.as_tensor(lv.astype(np.int64)), arity, device=CPU)


def batch(n: int, arity: int, idxs):
    """(positions int32, siblings uint32, leaves uint32, root uint32) of the
    proofs of leaves ``idxs`` of an n-leaf tree, as a verifier gets them."""
    levels = tree(n, arity)
    pos, sib = merkle.generate_proofs(levels, arity, list(idxs))
    return (
        pos.numpy(),
        sib.numpy().astype(np.uint32),
        levels[0][list(idxs)].numpy().astype(np.uint32),
        levels[-1][0].numpy().astype(np.uint32),
    )


def jax_each(pos, sib, lv, root, arity):
    return np.asarray(jmerkle.verify_each(pos, sib, lv, root, arity, dedupe=True))


def port_each(pos, sib, lv, root, arity):
    return merkle.verify_each(pos, sib, lv, root, arity, dedupe=True,
                              device=CPU)


# ---------------------------------------------------------------------------
# Exact grouping and the wire
# ---------------------------------------------------------------------------

def test_group_rows_and_triples_match_native():
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 1 << 16, (37, 32)).astype(np.uint32)
    rows = pool[rng.integers(0, 37, 500)]
    rows[7, 3] ^= 1  # one row that differs from its pool twin in one digit
    for r in (rows, rows.reshape(500, 4, 8)[:, 1]):  # contiguous and strided
        got, want = native.group_rows(r), jnative.group_rows(r)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert len(native.group_rows(rows)[0]) == len(np.unique(rows, axis=0))
    a, b, c = (rng.integers(0, m, 400) for m in (5, 6, 3))
    got, want = native.group_triples(a, b, c), jnative.group_triples(a, b, c)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    with pytest.raises(errors.ValidationError):
        native.group_rows(np.zeros((4, 3), np.uint32))  # 12-byte rows


def random_proofs(seed, k, h, arity, alphabet):
    """Arbitrary (not tree-consistent) proofs over a small digit alphabet,
    so rows repeat at every level: the schedule needs no valid tree."""
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, arity, (k, h)).astype(np.int32),
        rng.integers(0, alphabet, (k, h, arity - 1, 16)).astype(np.uint32),
        rng.integers(0, alphabet, (k, 16)).astype(np.uint32),
        rng.integers(0, 1 << 16, 16).astype(np.uint32),
    )


WIRES = {
    "tree-arity2": lambda: batch(41, 2, list(range(30)) + [5, 5, 12, 29]) + (2,),
    "tree-arity3": lambda: batch(41, 3, list(range(30)) + [5, 5, 12, 29]) + (3,),
    "tree-arity8": lambda: batch(41, 8, list(range(30)) + [5, 5, 12, 29]) + (8,),
    "5x-dup-arity4": lambda: batch(64, 4, np.arange(600) % 64) + (4,),
    "random-h5": lambda: random_proofs(3, 400, 5, 3, 4) + (3,),
    "random-h1": lambda: random_proofs(4, 300, 1, 4, 3) + (4,),
    "random-wide-table": lambda: random_proofs(5, 20000, 2, 2, 1 << 16) + (2,),
}


@pytest.mark.parametrize("name", sorted(WIRES))
def test_dedup_pack_is_byte_equal_to_jax(name):
    assert jmerkle._native_scheduler()  # the JAX side groups natively too
    pos, sib, lv, root, arity = WIRES[name]()
    got = merkle._dedup_pack(pos, sib, lv, root, arity)
    want = jmerkle._dedup_pack(pos, sib, lv, root, arity)
    assert (got.sizes, got.kb, got.tb, got.lm16) == (
        want.sizes, want.kb, want.tb, want.lm16)
    assert got.packed.dtype == want.packed.dtype == np.uint32
    assert got.packed.tobytes() == want.packed.tobytes()
    keys, counts, parents = got.iso
    jkeys, jcounts, jparents = want.iso
    assert counts == jcounts and sorted(parents) == sorted(jparents)
    assert all(np.array_equal(a, b) for a, b in zip(keys, jkeys))
    assert all(np.array_equal(parents[L], jparents[L]) for L in parents)
    if name == "random-wide-table":
        assert not got.lm16  # more than 2^15 table values: two words
    if name == "5x-dup-arity4":
        assert got.tb == merkle._table_bucket(64 + 16 + 4)


def test_device_program_plain_flags_on_a_valid_wire():
    pos, sib, lv, root = batch(64, 4, np.arange(256) % 64)
    wire = merkle._dedup_pack(pos, sib, lv, root, 4)
    flags, bad = merkle._dedup_verify_levels(
        4, wire.sizes, wire.kb, wire.tb, wire.lm16,
        merkle._upload(wire.packed, torch.device("cpu")),
    )
    assert flags.tolist() == [True, True]
    assert bad.shape == (wire.kb + sum(wire.sizes[1:]),) and not bad.any()


# ---------------------------------------------------------------------------
# verify_each against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arity", [2, 3, 4, 8])
def test_verify_each_matches_jax_valid_and_tampered(arity):
    """Valid proofs with duplicate indices; then one batch with a tampered
    leaf, sibling and position in three different proofs (isolation must
    pin exactly those), and a tampered root."""
    pos, sib, lv, root = batch(41, arity, list(range(30)) + [5, 5, 12, 29])
    got = port_each(pos, sib, lv, root, arity)
    assert got.all()
    assert np.array_equal(got, jax_each(pos, sib, lv, root, arity))

    bad_lv, bad_sib, bad_pos = lv.copy(), sib.copy(), pos.copy()
    bad_lv[7, 3] ^= 1
    bad_sib[3, 1, 0, 2] ^= 1
    bad_pos[2, 0] = (bad_pos[2, 0] + 1) % arity
    got = port_each(bad_pos, bad_sib, bad_lv, root, arity)
    assert sorted(np.flatnonzero(~got)) == [2, 3, 7]
    assert np.array_equal(got, jax_each(bad_pos, bad_sib, bad_lv, root, arity))

    bad_root = root.copy()
    bad_root[0] ^= 1
    got = port_each(pos, sib, lv, bad_root, arity)
    assert not got.any()
    assert np.array_equal(got, jax_each(pos, sib, lv, bad_root, arity))


def test_duplicate_full_suffix_conflict_matches_jax():
    """Four proofs of leaf 3 with identical paths, one claiming another
    leaf: the level-0 binding check catches it."""
    pos, sib, lv, root = batch(8, 2, [3] * 4 + list(range(8)))
    conflicted = lv.copy()
    conflicted[1, 0] ^= 1
    got = port_each(pos, sib, conflicted, root, 2)
    assert np.flatnonzero(~got).tolist() == [1]
    assert np.array_equal(got, jax_each(pos, sib, conflicted, root, 2))


def test_isolation_pins_the_failing_proof(monkeypatch):
    """One tampered leaf in 256 proofs: only the suspects re-verify
    exactly; a wrong root is decided by the dedup chain alone."""
    pos, sib, lv, root = batch(64, 4, np.arange(256) % 64)
    bad_lv = lv.copy()
    bad_lv[17, 0] ^= 1
    calls = []
    real = merkle.verify_proofs

    def spy(p, s, l, r, a):
        calls.append(int(p.shape[0]))
        return real(p, s, l, r, a)

    monkeypatch.setattr(merkle, "verify_proofs", spy)
    got = port_each(pos, sib, bad_lv, root, 4)
    assert np.flatnonzero(~got).tolist() == [17]
    assert calls and max(calls) <= 8
    assert np.array_equal(got, jax_each(pos, sib, bad_lv, root, 4))

    calls.clear()
    bad_root = root.copy()
    bad_root[0] ^= 1
    assert not port_each(pos, sib, lv, bad_root, 4).any() and calls == []


def test_verify_each_takes_tensors_and_defaults():
    pos, sib, lv, root = batch(41, 4, list(range(30)) + [5, 5, 12, 29])
    t = [torch.as_tensor(x.astype(np.int64)) for x in (sib, lv, root)]
    got = merkle.verify_each(torch.as_tensor(pos), *t, 4, dedupe=True, device=CPU)
    assert got.dtype == bool and got.shape == (34,) and got.all()
    assert merkle.verify_all(pos, sib, lv, root, 4, device=CPU)  # exact path
    levels = tree(41, 4)
    obj = merkle.NaryMerkleTree.from_levels(levels, 4, 41, device=CPU)
    assert obj.verify_batch_proofs(torch.as_tensor(pos), t[0], t[1])
    with pytest.raises(errors.ValidationError, match="disagree"):
        merkle.verify_each(pos, sib[:, :, :2], lv, root, 4, device=CPU)


# ---------------------------------------------------------------------------
# Range gates: what the dedup wire cannot carry goes to the exact path
# ---------------------------------------------------------------------------

def test_gate_declines_digit_2_16_plus_d_like_jax():
    pos, sib, lv, root = batch(16, 2, range(8))
    sib = sib.copy()
    sib[3, 1, 0, 2] += np.uint32(1 << 16)  # packs to the valid d
    assert merkle._dedup_pack(pos, sib, lv, root, 2) is None
    assert jmerkle._dedup_pack(pos, sib, lv, root, 2) is None
    got = port_each(pos, sib, lv, root, 2)
    assert np.flatnonzero(~got).tolist() == [3]
    assert np.array_equal(got, jax_each(pos, sib, lv, root, 2))


@pytest.mark.parametrize("where", ["sibling", "leaf", "root"])
@pytest.mark.parametrize("shift", [1 << 32, -(1 << 32)],
                         ids=["2^32+d", "d-2^32"])
def test_gate_declines_int64_digits_a_uint32_cast_would_alias(where, shift):
    """int64 digits 2^32 + d and d - 2^32 (negative) cast to uint32 as d,
    so the wire would carry a valid proof: the gate reads them before any
    cast and the exact path rejects them.  The JAX package holds uint32
    digits and has no such input; the plain path is the reference."""
    pos, sib, lv, root = (x.astype(np.int64) for x in batch(16, 2, range(8)))
    if where == "sibling":
        sib[5, 0, 0, 4] += shift
    elif where == "leaf":
        lv[5, 4] += shift
    else:
        root[4] += shift
    assert merkle._dedup_pack(pos, sib, lv, root, 2) is None
    got = port_each(pos, sib, lv, root, 2)
    plain = merkle.verify_proofs(pos, sib, lv, root, 2, device=CPU).numpy()
    assert np.array_equal(got, plain)
    assert got.tolist() == ([False] * 8 if where == "root" else
                            [True] * 5 + [False] + [True] * 2)


def test_gate_declines_positions_outside_the_arity_like_jax():
    pos, sib, lv, root = batch(16, 2, [0, 0, 5, 9])
    for bad in (int(pos[1, -1]) + 256, -1):
        p2 = pos.copy()
        p2[1, -1] = bad  # proof 1 otherwise shares proof 0's suffix
        assert merkle._dedup_pack(p2, sib, lv, root, 2) is None
        got = port_each(p2, sib, lv, root, 2)
        assert got.tolist() == [True, False, True, True]
        assert np.array_equal(got, jax_each(p2, sib, lv, root, 2))
    p3 = pos.astype(np.int64)
    p3[1, -1] += 1 << 32  # aliases the valid position in int32
    assert merkle._dedup_pack(p3, sib, lv, root, 2) is None
    assert port_each(p3, sib, lv, root, 2).tolist() == [True, False, True, True]


def test_gate_declines_arity_above_8():
    k, h = 8, 2
    pos = np.zeros((k, h), np.int32)
    leaves, root = np.zeros((k, 16), np.uint32), np.zeros(16, np.uint32)
    sib9 = np.zeros((k, h, 8, 16), np.uint32)
    assert merkle._dedup_pack(pos, sib9, leaves, root, 9) is None
    assert jmerkle._dedup_pack(pos, sib9, leaves, root, 9) is None
    sib8 = np.zeros((k, h, 7, 16), np.uint32)
    assert merkle._dedup_pack(pos, sib8, leaves, root, 8) is not None
    with pytest.raises(errors.ValidationError, match="arity"):
        merkle.verify_each(pos, sib9, leaves, root, 9, dedupe=True,
                           device=CPU)
