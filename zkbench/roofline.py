"""The work a cell requires and the least time one H100 could take for it.

Work is counted from the workload, never from a kernel: the permutations
that the cuZK semantics require for a commit or a verify, whatever code
computes them.  A commit of a tree of ``n`` leaves padded to ``a^L`` hashes
``a^(L-1) + ... + 1`` groups, each ``ceil(a / 2)`` permutations (the
sponge absorbs two inputs a permutation); a verify of ``k`` proofs of
``L`` levels hashes ``k * L`` groups.

A permutation at the reference's semantics computes 44,096 32 x 32-bit limb
products, each two 32-bit multiply results (the low and the high word):
its 80 S-boxes (8 full rounds of 3, 56 partial rounds of 1) take 436 limb
products each (power5 = three multiplies, each a schoolbook product plus
the truncated k-fold), and its 64 MDS layers 9 one-limb products of 16
limbs each (576 of 16).  So 88,192 multiply results a permutation.

The card's multiply peak: 132 SMs x 64 integer multiply-adds a clock
(CUDA C Programming Guide, throughput table, compute capability 9.0) x
1.98 GHz (``clocks.max.sm`` of the NVIDIA H100 80GB HBM3 at 700 W),
counting one 32-bit result per slot.  ``calibrate_imad.py`` measured it on
the card: IMAD issues 64 a clock on an SM, IMAD.WIDE.U32 (both words of a
product) and IMAD.HI 29.5-31.6, so a wide product takes two slots and
gives one result a slot; the peak stands at 1.673e13 results a second.
The bytes a commit or verify moves (its digit rows read once and written
once) need under 2% of the multiply bound, so the bound is the
multiplies.
"""

from __future__ import annotations

SMS = 132
CLOCK_HZ = 1.98e9
IMAD_PER_CLOCK_PER_SM = 64
# 32-bit multiply results one multiply slot gives, as calibrate_imad.py
# measured it on the card (PERF.md records the run).
RESULTS_PER_SLOT = 1
MULTIPLY_PEAK_PER_S = SMS * IMAD_PER_CLOCK_PER_SM * CLOCK_HZ * RESULTS_PER_SLOT

LIMB_PRODUCTS_PER_PERMUTATION = 80 * 436 + 576 * 16
MULTIPLIES_PER_PERMUTATION = 2 * LIMB_PRODUCTS_PER_PERMUTATION
HBM_BYTES_PER_S = 3.35e12
ROW_BYTES = 16 * 8  # one element as the port's [16] int64 digits


def permutations_per_group(arity: int) -> int:
    return (arity + 1) // 2


def padded_leaves(n: int, arity: int) -> int:
    padded = 1
    while padded < n:
        padded *= arity
    return padded


def commit_permutations(leaves: int, arity: int) -> int:
    """Permutations of one tree build of ``leaves`` leaves."""
    groups, level = 0, padded_leaves(leaves, arity)
    while level > 1:
        level //= arity
        groups += level
    return groups * permutations_per_group(arity)


def verify_permutations(proofs: int, levels: int, arity: int) -> int:
    """Permutations of one batch verify of ``proofs`` proofs of ``levels``
    levels."""
    return proofs * levels * permutations_per_group(arity)


def multiply_bound_s(permutations: int) -> float:
    """The least time of ``permutations`` permutations on the card."""
    return permutations * MULTIPLIES_PER_PERMUTATION / MULTIPLY_PEAK_PER_S


def bytes_bound_s(rows: int) -> float:
    """The least time to move ``rows`` digit rows through device memory."""
    return rows * ROW_BYTES / HBM_BYTES_PER_S
