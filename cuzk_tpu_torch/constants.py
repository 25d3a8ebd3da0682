"""The constants of the reference's BN254-Fr field and Poseidon instance.

The port's own copy of the numbers it hashes with, so that it runs with no
other package of this repo: the modulus, the CPU reduction constant ``k``,
the Poseidon shape, domain separators, MDS matrix and round constants
(field_arithmetic.cpp:12-17, :257-258; poseidon.cpp:33-58, :89-101).
The CPU tests hold each against ``cuzk_tpu.oracle``.
"""

# BN254 scalar field modulus.
P = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
# k = 2^256 mod p, the reference CPU constant (not its CUDA code's
# ...4fffffff).
K = (1 << 256) % P

# Poseidon: t=3, capacity 1, rate 2, 8 full and 56 partial rounds, x^5.
T = 3
RATE = 2
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56
TOTAL_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS

DS_SINGLE = 1
DS_PAIR = 2
DS_MULTIPLE = 3

# 3x3 MDS matrix, row-major.
MDS = (7, 23, 8, 26, 5, 4, 15, 20, 9)

# RC[i] = add(mul(i + 1, 0x123456789ABCDEF), i * 0x987654321).  Every
# product and sum stays far below p, so the field ops are plain integer ops.
RC = [
    (i + 1) * 0x123456789ABCDEF + i * 0x987654321
    for i in range(TOTAL_ROUNDS * T)
]

# Merkle arity bounds (merkle_tree.hpp:17-32).
MIN_ARITY = 2
MAX_ARITY = 8
