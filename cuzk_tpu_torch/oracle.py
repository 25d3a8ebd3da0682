"""Exact Python-integer oracle of the cuZK reference semantics.

The counterpart of ``cuzk_tpu.oracle`` and the port's own specification:
the plain PyTorch versions, the CUDA kernels and the native C++ oracle
(:mod:`cuzk_tpu_torch.native`) must agree with these functions bit for
bit.  Pure Python ints on :mod:`cuzk_tpu_torch.constants`; it imports no
torch, no numpy and nothing of ``cuzk_tpu``, so it runs wherever Python
does.

The reference's CPU quirks are the contract (SURVEY.md Appendix A/B):

- ``k = 2**256 mod p`` is the CPU constant ``...ac96341c4ffffffb``, not the
  reference CUDA code's ``...4fffffff`` (cuda_field_element.cuh:314);
- ``reduce_512`` is a truncated k-fold: it drops ``(mh * k) >> 256``
  (field_arithmetic.cpp:250-330);
- ``add`` wraps at 2**256 before the subtractive reduce; ``sub`` pre-adds
  p (dropping the 2**256 carry) when a < b and drops the final borrow,
  with no reduce;
- the empty-input sponge returns 0 with no permutation
  (poseidon.cpp:103-126).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from cuzk_tpu_torch import constants

P = constants.P
K = constants.K
M256 = (1 << 256) - 1
assert K == 0x0E0A77C19A07DF2F666EA36F7879462E36FC76959F60CD29AC96341C4FFFFFFB

ZERO = 0
ONE = 1
TWO = 2


# ---------------------------------------------------------------------------
# Field arithmetic — field_arithmetic.cpp semantics
# ---------------------------------------------------------------------------

def red(a: int) -> int:
    """``while (a >= p) a -= p`` (field_arithmetic.cpp:244-248): at most 5
    subtractions for a < 2**256."""
    while a >= P:
        a -= P
    return a


def add(a: int, b: int) -> int:
    """Add that wraps at 2**256 before reducing (field_arithmetic.cpp:
    172-182)."""
    return red((a + b) & M256)


def sub(a: int, b: int) -> int:
    """Subtract (field_arithmetic.cpp:184-219): if a < b, p is pre-added
    once with its 2**256 carry dropped; the final borrow is dropped too.
    No reduce, so operands >= p can give a result >= p."""
    if a < b:
        a = (a + P) & M256
    return (a - b) & M256


def reduce_512(prod: int) -> int:
    """The truncated k-fold 512 -> 256 reduction (field_arithmetic.cpp:
    250-330): when ``mh != 0`` the term ``(mh * k) >> 256`` is dropped, and
    the combining adds wrap at 2**256.  Not ``prod mod p``."""
    low, high = prod & M256, prod >> 256
    if high == 0:
        return red(low)
    m = high * K
    hc, mh = m & M256, m >> 256
    if mh != 0:
        hc = add(hc, (mh * K) & M256)
    return add(low, hc)


def mul(a: int, b: int) -> int:
    """Exact 512-bit product, then the truncated reduction
    (field_arithmetic.cpp:221-238, :250-330)."""
    return reduce_512(a * b)


def square(a: int) -> int:
    """field_arithmetic.cpp:240-242."""
    return mul(a, a)


def power5(a: int) -> int:
    """a^5 = ((a^2)^2) * a (field_arithmetic.cpp:332-338)."""
    a2 = mul(a, a)
    return mul(mul(a2, a2), a)


# ---------------------------------------------------------------------------
# Poseidon — poseidon.cpp semantics; t=3, c=1, r=2, R_F=8, R_P=56, x^5
# ---------------------------------------------------------------------------

T = constants.T
RATE = constants.RATE
FULL_ROUNDS = constants.FULL_ROUNDS
PARTIAL_ROUNDS = constants.PARTIAL_ROUNDS
TOTAL_ROUNDS = constants.TOTAL_ROUNDS
NUM_ROUND_CONSTANTS = TOTAL_ROUNDS * T

DS_SINGLE = constants.DS_SINGLE
DS_PAIR = constants.DS_PAIR
DS_MULTIPLE = constants.DS_MULTIPLE

MDS = constants.MDS

_RC_MUL = 0x123456789ABCDEF
_RC_ADD = 0x987654321


def round_constants() -> List[int]:
    """RC[i] = add(mul(i + 1, 0x123456789ABCDEF), i * 0x987654321)
    (poseidon.cpp:33-44), through this module's field ops."""
    return [add(mul(i + 1, _RC_MUL), i * _RC_ADD)
            for i in range(NUM_ROUND_CONSTANTS)]


RC = round_constants()
assert RC == constants.RC


def permutation(state: Sequence[int]) -> List[int]:
    """64-round permutation: 4 full, 56 partial, 4 full (poseidon.cpp:
    60-87).  Each round adds its constants, applies the S-box (to every
    lane in a full round, lane 0 in a partial one), then the MDS."""
    st = list(state)
    if len(st) != T:
        raise ValueError(f"a state has {T} elements, got {len(st)}")
    half = FULL_ROUNDS // 2
    for r in range(TOTAL_ROUNDS):
        st = [add(st[i], RC[T * r + i]) for i in range(T)]
        if r < half or r >= half + PARTIAL_ROUNDS:
            st = [power5(x) for x in st]
        else:
            st[0] = power5(st[0])
        nxt = []
        for i in range(T):
            acc = 0
            for j in range(T):
                acc = add(acc, mul(MDS[T * i + j], st[j]))
            nxt.append(acc)
        st = nxt
    return st


def sponge(inputs: Sequence[int], domain_separator: int) -> int:
    """ds in state[0], absorb pairs into state[1..2] with :func:`add`, one
    permutation per block, squeeze state[1] (poseidon.cpp:103-126).  The
    empty input runs no permutation and returns 0."""
    st = [domain_separator, 0, 0]
    for i in range(0, len(inputs), RATE):
        for j, x in enumerate(inputs[i:i + RATE]):
            st[1 + j] = add(st[1 + j], x)
        st = permutation(st)
    return st[1]


def hash_single(x: int) -> int:
    """poseidon.cpp:89-91 (ds=1)."""
    return sponge([x], DS_SINGLE)


def hash_pair(left: int, right: int) -> int:
    """poseidon.cpp:93-96 (ds=2)."""
    return sponge([left, right], DS_PAIR)


def hash_multiple(inputs: Sequence[int]) -> int:
    """poseidon.cpp:98-101 (ds=3)."""
    return sponge(list(inputs), DS_MULTIPLE)


# ---------------------------------------------------------------------------
# N-ary Merkle tree — merkle_tree.cpp semantics
# ---------------------------------------------------------------------------

MIN_ARITY = constants.MIN_ARITY
MAX_ARITY = constants.MAX_ARITY


def empty_hash(arity: int) -> int:
    """hash_multiple(arity zeros) (merkle_tree.cpp:345-357)."""
    return hash_multiple([0] * arity)


def padded_leaf_count(n: int, arity: int) -> int:
    """Next power of arity >= n, minimum 1 (merkle_tree.cpp:49-53)."""
    padded = 1
    while padded < n:
        padded *= arity
    return padded


def tree_height(leaf_count: int, arity: int) -> int:
    """Levels including the leaves, ceil(log_a(n)) + 1, in exact integer
    arithmetic (the reference uses floating-point logs,
    merkle_tree.cpp:359-367; SURVEY.md Appendix B.9)."""
    padded, height = 1, 1
    while padded < leaf_count:
        padded *= arity
        height += 1
    return height


def build_tree_levels(leaves: Sequence[int], arity: int) -> List[List[int]]:
    """All levels bottom-up (merkle_tree.cpp:44-100): level[0] the leaves
    padded with ``empty_hash(arity)``, level[-1] ``[root]``.  Empty input
    returns []."""
    if not MIN_ARITY <= arity <= MAX_ARITY:
        raise ValueError(f"arity must be in [{MIN_ARITY},{MAX_ARITY}], got {arity}")
    if len(leaves) == 0:
        return []
    e = empty_hash(arity)
    level = list(leaves) + [e] * (padded_leaf_count(len(leaves), arity)
                                  - len(leaves))
    levels = [level]
    while len(level) > 1:
        level = [hash_multiple(level[i:i + arity])
                 for i in range(0, len(level), arity)]
        levels.append(level)
    return levels


def merkle_root(leaves: Sequence[int], arity: int) -> int:
    """The root; empty input gives ``empty_hash(arity)``
    (merkle_tree.cpp:338-343)."""
    levels = build_tree_levels(leaves, arity)
    return levels[-1][0] if levels else empty_hash(arity)


def generate_proof(levels: Sequence[Sequence[int]], arity: int,
                   leaf_index: int) -> Tuple[List[int], List[List[int]]]:
    """One leaf's proof ``(indices, path)``, leaf to root
    (merkle_tree.cpp:130-211): ``indices[l]`` the node's position in its
    group, ``path[l]`` its arity-1 siblings in child order."""
    if not levels:
        raise IndexError("empty tree")
    if leaf_index >= len(levels[0]):
        raise IndexError("leaf index out of range")
    indices: List[int] = []
    path: List[List[int]] = []
    idx = leaf_index
    for lvl in range(len(levels) - 1):
        pos = idx % arity
        start = idx - pos
        indices.append(pos)
        path.append([levels[lvl][start + i] for i in range(arity) if i != pos])
        idx //= arity
    return indices, path


def verify_proof(indices: Sequence[int], path: Sequence[Sequence[int]],
                 leaf_value: int, root_hash: int, arity: int) -> bool:
    """Recompute the root from the leaf and its siblings
    (merkle_tree.cpp:214-254)."""
    if len(indices) != len(path):
        return False
    current = leaf_value
    for pos, siblings in zip(indices, path):
        if pos >= arity or len(siblings) != arity - 1:
            return False
        current = hash_multiple(
            list(siblings[:pos]) + [current] + list(siblings[pos:]))
    return current == root_hash


# ---------------------------------------------------------------------------
# Deterministic test leaves (merkle_tree.cpp:443-457)
# ---------------------------------------------------------------------------

_MT_N, _MT_M = 312, 156
_MASK64 = (1 << 64) - 1


def mt19937_64(seed: int, count: int) -> List[int]:
    """The first ``count`` outputs of ``std::mt19937_64(seed)``."""
    mt = [seed & _MASK64]
    for i in range(1, _MT_N):
        mt.append((6364136223846793005 * (mt[-1] ^ (mt[-1] >> 62)) + i)
                  & _MASK64)
    out: List[int] = []
    while len(out) < count:
        for i in range(_MT_N):  # the twist
            y = (mt[i] & 0xFFFFFFFF80000000) | (mt[(i + 1) % _MT_N] & 0x7FFFFFFF)
            mt[i] = (mt[(i + _MT_M) % _MT_N] ^ (y >> 1)
                     ^ (0xB5026F5AA96619E9 * (y & 1)))
        for x in mt[:count - len(out)]:  # tempering
            x ^= (x >> 29) & 0x5555555555555555
            x ^= (x << 17) & 0x71D67FFFEDA60000
            x ^= (x << 37) & 0xFFF7EEE000000000
            out.append((x ^ (x >> 43)) & _MASK64)
    return out


def generate_test_leaves(count: int, seed: int = 42) -> List[int]:
    """``mt19937_64(seed)``, one u64 draw per leaf (merkle_tree.cpp:
    443-457)."""
    return mt19937_64(seed, count)
