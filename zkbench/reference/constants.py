"""The numbers the reference hashes with (field_arithmetic.cpp:12-17,
:257-258; poseidon.cpp:33-58, :89-101), copied as literals."""

P = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
# k = 2^256 mod p, the reference's CPU constant.
K = (1 << 256) % P
# The constant the cuZK CUDA sources carry instead (SURVEY.md Appendix B.1):
# k + 4.  The benchmark's control computes with it.
K_CUDA = K + 4

T = 3
RATE = 2
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56
TOTAL_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
HALF_FULL = FULL_ROUNDS // 2

DS_MULTIPLE = 3

MDS = (7, 23, 8, 26, 5, 4, 15, 20, 9)

# RC[i] = add(mul(i + 1, 0x123456789ABCDEF), i * 0x987654321); every value
# stays far below p, so these are plain integer expressions.
RC = [
    (i + 1) * 0x123456789ABCDEF + i * 0x987654321
    for i in range(TOTAL_ROUNDS * T)
]
