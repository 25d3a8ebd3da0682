// BN254-Fr device arithmetic on 8 x u32 little-endian limbs, with the
// reference's CPU semantics (SURVEY.md Appendix A), quirks included:
//   - adds wrap at 2^256 before the subtractive reduce;
//   - multiplication reduces with the truncated k-fold, which drops
//     (mh * k) >> 256 and keeps the mh == 0 select;
//   - k = 2^256 mod p is the CPU constant ...ac96341c4ffffffb, not the
//     reference CUDA code's ...4fffffff.
//
// Replaces the TPU slab library cuzk_tpu/ops/fieldslab.py (carry,
// cond_sub_const, red, add_rr, add_wrap_red, mul_wide, mul_low,
// reduce_wide, mul_small, square_wide, power5) and the permutation
// cuzk_tpu/ops/poseidon_pallas.py::_permute.  The TPU keeps 16-bit digits
// so that every digit product fits a u32 vector lane; here one thread owns
// one element in registers and uses 32-bit limbs with 64-bit products.
// What bounds it on Hopper: integer multiply-add issue rate (about 2/3 of a
// permutation's instructions are IMAD/IADD chains); it reads and writes
// only 32 bytes per absorbed input, so memory is never the limit.
#pragma once

#include <cstdint>

namespace fr254 {

#define FR254_P \
  0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, \
  0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u
#define FR254_P2 \
  0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u, \
  0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u
#define FR254_P4 \
  0xc0000004u, 0x0f87d64fu, 0xe6e5c245u, 0xa0cfa121u, \
  0x06056174u, 0xe14116dau, 0x84c680a6u, 0xc19139cbu
#define FR254_K \
  0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, \
  0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u

constexpr int NL = 8;          // limbs per element
constexpr int T = 3;           // Poseidon state width
constexpr int ROUNDS = 64;     // 4 full + 56 partial + 4 full
constexpr int HALF_FULL = 4;

// Round constants RC[r][i] as limbs, uploaded once per device by the host
// (cuzk_set_round_constants).  Every thread of a warp reads the same round
// at the same time, which is the access the constant cache broadcasts.
__constant__ uint32_t ROUND_CONSTANTS[ROUNDS * T * NL];

// Inlining: the 512-bit product and reduction routines are forced inline
// into their callers, while mul, square, power5 and mul_small stay calls.
// With every level forced inline, nvcc 12.9's front end crashes (segfault)
// on this file; with nothing inlined the kernels ran 2.2-2.9x slower
// (NVIDIA H100 80GB HBM3, 700 W: K1 5.80 -> 2.00 ms, K3 20.6 -> 9.3 ms).
#define FR254_INNER __forceinline__
#define FR254_OUTER __noinline__

typedef uint32_t Fe[NL];
typedef uint32_t Wide[2 * NL];

__device__ __forceinline__ void copy(Fe r, const Fe a) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = a[i];
}

// r = a + b mod 2^256; returns the carry out of the top limb.
__device__ __forceinline__ uint32_t add_raw(Fe r, const Fe a, const Fe b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    c += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// a = a - m if a >= m (fieldslab.cond_sub_const).
__device__ __forceinline__ void cond_sub(Fe a, const Fe m) {
  uint32_t d[NL];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t t = (uint64_t)a[i] - m[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  const bool ge = borrow == 0;
#pragma unroll
  for (int i = 0; i < NL; i++) a[i] = ge ? d[i] : a[i];
}

// a mod p for any a < 2^256: conditional subtracts of 4p, 2p, p give the
// residue of the reference's `while (a >= p) a -= p` (2^256 < 6p).
__device__ __forceinline__ void red(Fe a) {
  const uint32_t p4[NL] = {FR254_P4};
  const uint32_t p2[NL] = {FR254_P2};
  const uint32_t p[NL] = {FR254_P};
  cond_sub(a, p4);
  cond_sub(a, p2);
  cond_sub(a, p);
}

// The reference's add for any canonical operands: wrap at 2^256, reduce.
__device__ __forceinline__ void add_wrap_red(Fe r, const Fe a, const Fe b) {
  add_raw(r, a, b);
  red(r);
}

// Add for reduced operands (a, b < p): never wraps, one subtract of p.
// Bit-identical to add_wrap_red there.
__device__ __forceinline__ void add_rr(Fe r, const Fe a, const Fe b) {
  const uint32_t p[NL] = {FR254_P};
  add_raw(r, a, b);
  cond_sub(r, p);
}

// Exact 512-bit product.
__device__ FR254_INNER void mul_wide(Wide r, const Fe a, const Fe b) {
#pragma unroll
  for (int i = 0; i < 2 * NL; i++) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      uint64_t t = (uint64_t)a[i] * b[j] + r[i + j] + c;
      r[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    r[i + NL] = (uint32_t)c;
  }
}

// Low 256 bits of the product.
__device__ FR254_INNER void mul_low(Fe r, const Fe a, const Fe b) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL - i; j++) {
      uint64_t t = (uint64_t)a[i] * b[j] + r[i + j] + c;
      r[i + j] = (uint32_t)t;
      c = t >> 32;
    }
  }
}

// Exact 512-bit square: each off-diagonal product once, doubled, plus the
// diagonal (28 + 8 limb products instead of 64).
__device__ FR254_INNER void square_wide(Wide r, const Fe a) {
#pragma unroll
  for (int i = 0; i < 2 * NL; i++) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NL - 1; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < NL; j++) {
      uint64_t t = (uint64_t)a[i] * a[j] + r[i + j] + c;
      r[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    r[i + NL] = (uint32_t)c;
  }
  // Off-diagonal sum < 2^511: doubling drops nothing.
#pragma unroll
  for (int i = 2 * NL - 1; i > 0; i--) r[i] = (r[i] << 1) | (r[i - 1] >> 31);
  r[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t sq = (uint64_t)a[i] * a[i];
    uint64_t t = (uint64_t)r[2 * i] + (uint32_t)sq + c;
    r[2 * i] = (uint32_t)t;
    t = (uint64_t)r[2 * i + 1] + (sq >> 32) + (t >> 32);
    r[2 * i + 1] = (uint32_t)t;
    c = t >> 32;
  }
}

// The truncated k-fold 512 -> 256 reduction (field_arithmetic.cpp:250-330):
//   m = high * k; hc = m mod 2^256; mh = m >> 256;
//   if mh != 0: hc = add(hc, (mh * k) mod 2^256)   -- (mh*k) >> 256 dropped
//   return add(low, hc)
// The reference's high == 0 early-out needs no branch: it gives hc == 0 and
// add(low, 0) == red(low).
__device__ FR254_INNER void reduce_wide(Fe r, const Wide w) {
  const uint32_t k[NL] = {FR254_K};
  uint32_t lo[NL], hi[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) {
    lo[i] = w[i];
    hi[i] = w[i + NL];
  }
  uint32_t m[2 * NL];
  mul_wide(m, hi, k);
  uint32_t hc[NL], mh[NL];
  uint32_t mh_any = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    hc[i] = m[i];
    mh[i] = m[i + NL];
    mh_any |= mh[i];
  }
  if (mh_any != 0) {
    uint32_t t[NL];
    mul_low(t, mh, k);
    add_wrap_red(hc, hc, t);
  }
  add_wrap_red(r, lo, hc);
}

__device__ FR254_OUTER void mul(Fe r, const Fe a, const Fe b) {
  uint32_t w[2 * NL];
  mul_wide(w, a, b);
  reduce_wide(r, w);
}

__device__ FR254_OUTER void square(Fe r, const Fe a) {
  uint32_t w[2 * NL];
  square_wide(w, a);
  reduce_wide(r, w);
}

// a^5 = ((a^2)^2) * a (field_arithmetic.cpp:332-338).
__device__ FR254_OUTER void power5(Fe r, const Fe a) {
  uint32_t a2[NL], a4[NL];
  square(a2, a);
  square(a4, a2);
  mul(r, a4, a);
}

// mul(a, c) for a one-limb constant c, bit-identical to the general mul:
// the product is 9 limbs, so both k-folds are one-limb-by-field products.
__device__ FR254_OUTER void mul_small(Fe r, const Fe a, uint32_t c) {
  const uint32_t k[NL] = {FR254_K};
  uint32_t lo[NL];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t t = (uint64_t)a[i] * c + carry;
    lo[i] = (uint32_t)t;
    carry = t >> 32;
  }
  const uint32_t high = (uint32_t)carry;
  uint32_t hc[NL];
  carry = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t t = (uint64_t)k[i] * high + carry;
    hc[i] = (uint32_t)t;
    carry = t >> 32;
  }
  const uint32_t mh = (uint32_t)carry;
  if (mh != 0) {
    uint32_t t8[NL];
    carry = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
      uint64_t t = (uint64_t)k[i] * mh + carry;
      t8[i] = (uint32_t)t;
      carry = t >> 32;
    }
    add_wrap_red(hc, hc, t8);
  }
  add_wrap_red(r, lo, hc);
}

__device__ __forceinline__ const uint32_t* round_constant(int r, int i) {
  return ROUND_CONSTANTS + (r * T + i) * NL;
}

// The 64 rounds of the Poseidon permutation (poseidon.cpp:60-87) after the
// round-0 constant add: per round, S-box, MDS, add RC[r+1].  The state is
// reduced on entry, so every operand is reduced and each add is add_rr,
// which equals the reference's add there.  The MDS coefficients are
// immediates.
__device__ __forceinline__ void permute_rounds(uint32_t (&s)[T][NL]) {
  const uint32_t mds[T * T] = {7, 23, 8, 26, 5, 4, 15, 20, 9};
#pragma unroll 1
  for (int r = 0; r < ROUNDS; r++) {
    const bool full = r < HALF_FULL || r >= ROUNDS - HALF_FULL;
    power5(s[0], s[0]);
    if (full) {
      power5(s[1], s[1]);
      power5(s[2], s[2]);
    }
    uint32_t ns[T][NL];
#pragma unroll
    for (int i = 0; i < T; i++) {
      uint32_t m0[NL], m1[NL], m2[NL];
      mul_small(m0, s[0], mds[T * i + 0]);
      mul_small(m1, s[1], mds[T * i + 1]);
      mul_small(m2, s[2], mds[T * i + 2]);
      add_rr(ns[i], m0, m1);
      add_rr(ns[i], ns[i], m2);
      if (r + 1 < ROUNDS) {
        uint32_t rc[NL];
        copy(rc, round_constant(r + 1, i));
        add_rr(ns[i], ns[i], rc);
      }
    }
#pragma unroll
    for (int i = 0; i < T; i++) copy(s[i], ns[i]);
  }
}

// The permutation on the reduced state the sponge feeds it: round 0's
// constant add is add_rr too.
__device__ __forceinline__ void permute(uint32_t (&s)[T][NL]) {
#pragma unroll
  for (int i = 0; i < T; i++) {
    uint32_t rc[NL];
    copy(rc, round_constant(0, i));
    add_rr(s[i], s[i], rc);
  }
  permute_rounds(s);
}

// The permutation on a state of any 256-bit values (the reference's
// batch_permutation): round 0 adds with the full wrap at 2^256 and the
// 4p/2p/p reduce, the same op the sponge's absorb uses.
__device__ __forceinline__ void permute_full(uint32_t (&s)[T][NL]) {
#pragma unroll
  for (int i = 0; i < T; i++) {
    uint32_t rc[NL];
    copy(rc, round_constant(0, i));
    add_wrap_red(s[i], s[i], rc);
  }
  permute_rounds(s);
}

}  // namespace fr254
