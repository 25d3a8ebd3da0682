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
// reduce_wide, mul_small_reduced, square_wide, power5) and the permutation
// cuzk_tpu/ops/poseidon_pallas.py::_permute.
//
// What bounds it on Hopper: integer multiplies.  A permutation is 80
// S-boxes of 436 limb products (square 36 + 100 for the reduction, mul
// 64 + 100) plus 576 one-limb MDS products, about 44K 32 x 32 -> 64-bit
// products (88K multiply results); it reads and writes 32 bytes per
// absorbed input.  Below a wave of resident threads, what bounds a launch
// is one state's latency instead: 64 dependent rounds.  The design:
//
//   - Elements are values (Fe, a struct of eight limbs) held in registers;
//     every routine is inlined, so no operand passes through local memory.
//   - Products and adds are PTX carry chains (mad.lo.cc / madc.hi.cc /
//     addc.cc): one instruction per multiply result or limb add, and every
//     constant an immediate.
//   - Operations are batched over N independent elements (Vec<N>), so that
//     independent chains interleave.
//   - One thread holds an element.  Splitting its limbs across 4 or 8 lanes
//     of a warp was built and measured on an H100: a multiply then takes
//     14-16 dependent shuffle and ballot rounds, which cost more than the
//     products they divide, slower at every measured shape (PERF.md).  What
//     pays below a wave is splitting the state's three elements across
//     lanes instead (poseidon.cuh).
//   - One thread a state (K4, and K1 and K3 at G = 1) runs forms of its
//     own, for the pipes of a full wave (section "The one-thread core"
//     below); the element split and the per-op check kernel use the ones
//     above.
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
// (cuzk_set_round_constants).
__constant__ uint32_t ROUND_CONSTANTS[ROUNDS * T * NL];

#define FR254_UNROLL _Pragma("unroll")

// ---------------------------------------------------------------------------
// Carry-chain primitives.  On the device each is one PTX instruction that
// reads and/or writes the carry flag; a chain is a run of them with no
// other flag writer between.  The host form models the flag, so that the
// header also builds with a host compiler.
// ---------------------------------------------------------------------------

#if defined(__CUDA_ARCH__)
#define FR254_CC3(name, op)                                              \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {     \
    uint32_t r;                                                          \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));         \
    return r;                                                            \
  }
#define FR254_CC4(name, op)                                                \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,         \
                                           uint32_t c) {                   \
    uint32_t r;                                                            \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                              \
  }
FR254_CC3(add_cc, "add.cc.u32")
FR254_CC3(addc_cc, "addc.cc.u32")
FR254_CC3(addc, "addc.u32")
FR254_CC3(sub_cc, "sub.cc.u32")
FR254_CC3(subc_cc, "subc.cc.u32")
FR254_CC3(subc, "subc.u32")
FR254_CC4(mad_lo_cc, "mad.lo.cc.u32")
FR254_CC4(madc_lo_cc, "madc.lo.cc.u32")
FR254_CC4(madc_lo, "madc.lo.u32")
FR254_CC4(mad_hi_cc, "mad.hi.cc.u32")
FR254_CC4(madc_hi_cc, "madc.hi.cc.u32")
FR254_CC4(madc_hi, "madc.hi.u32")
#undef FR254_CC3
#undef FR254_CC4
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}
#else
inline thread_local uint32_t carry_flag = 0;
inline uint32_t cc_set(uint64_t t) {
  carry_flag = (uint32_t)(t >> 32) & 1u;
  return (uint32_t)t;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  return cc_set((uint64_t)a + b + carry_flag);
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + carry_flag; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a - b); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  return cc_set((uint64_t)a - b - carry_flag);
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - carry_flag; }
inline uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((uint64_t)(a * b) + c);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((uint64_t)(a * b) + c + carry_flag);
}
inline uint32_t madc_lo(uint32_t a, uint32_t b, uint32_t c) {
  return a * b + c + carry_flag;
}
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((uint64_t)mul_hi(a, b) + c);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((uint64_t)mul_hi(a, b) + c + carry_flag);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return mul_hi(a, b) + c + carry_flag;
}
#endif

// ---------------------------------------------------------------------------
// Elements
// ---------------------------------------------------------------------------

struct Fe {
  uint32_t v[NL];
};

// N independent elements, operated on together.
template <int N>
struct Vec {
  Fe e[N];
};

// A 512-bit product.
struct Wide {
  uint32_t lo[NL], hi[NL];
};

__device__ __forceinline__ Fe zero() {
  Fe r;
  FR254_UNROLL
  for (int i = 0; i < NL; i++) r.v[i] = 0;
  return r;
}

// ---------------------------------------------------------------------------
// Limb products
// ---------------------------------------------------------------------------

// r = a * b: 16 limbs, exact.  Row i adds a[i] * b at limb i: a chain of
// low halves, then a chain of high halves one limb up.
__device__ __forceinline__ void rows(uint32_t (&r)[2 * NL],
                                     const uint32_t (&a)[NL],
                                     const uint32_t (&b)[NL]) {
  FR254_UNROLL
  for (int j = 0; j < NL; j++) r[j] = a[0] * b[j];
  r[1] = mad_hi_cc(a[0], b[0], r[1]);
  FR254_UNROLL
  for (int j = 1; j < NL - 1; j++) r[j + 1] = madc_hi_cc(a[0], b[j], r[j + 1]);
  r[NL] = madc_hi(a[0], b[NL - 1], 0);
  FR254_UNROLL
  for (int i = 1; i < NL; i++) {
    r[i] = mad_lo_cc(a[i], b[0], r[i]);
    FR254_UNROLL
    for (int j = 1; j < NL; j++) r[i + j] = madc_lo_cc(a[i], b[j], r[i + j]);
    r[i + NL] = addc(0, 0);
    r[i + 1] = mad_hi_cc(a[i], b[0], r[i + 1]);
    FR254_UNROLL
    for (int j = 1; j < NL - 1; j++)
      r[i + j + 1] = madc_hi_cc(a[i], b[j], r[i + j + 1]);
    // The running sum is below 2^(32 (i + 9)): nothing carries out.
    r[i + NL] = madc_hi(a[i], b[NL - 1], r[i + NL]);
  }
}

// r = a * c for one word c: 9 limbs, exact.
__device__ __forceinline__ void rows_word(uint32_t (&r)[NL + 1],
                                          const uint32_t (&a)[NL], uint32_t c) {
  FR254_UNROLL
  for (int j = 0; j < NL; j++) r[j] = a[j] * c;
  r[1] = mad_hi_cc(a[0], c, r[1]);
  FR254_UNROLL
  for (int j = 1; j < NL - 1; j++) r[j + 1] = madc_hi_cc(a[j], c, r[j + 1]);
  r[NL] = madc_hi(a[NL - 1], c, 0);
}

// Low 256 bits of a * b.
__device__ __forceinline__ void rows_low(uint32_t (&r)[NL],
                                         const uint32_t (&a)[NL],
                                         const uint32_t (&b)[NL]) {
  FR254_UNROLL
  for (int j = 0; j < NL; j++) r[j] = a[0] * b[j];
  r[1] = mad_hi_cc(a[0], b[0], r[1]);
  FR254_UNROLL
  for (int j = 1; j < NL - 2; j++) r[j + 1] = madc_hi_cc(a[0], b[j], r[j + 1]);
  r[NL - 1] = madc_hi(a[0], b[NL - 2], r[NL - 1]);
  FR254_UNROLL
  for (int i = 1; i < NL; i++) {
    if (i == NL - 1) {
      r[i] = a[i] * b[0] + r[i];
      continue;
    }
    r[i] = mad_lo_cc(a[i], b[0], r[i]);
    FR254_UNROLL
    for (int j = 1; j < NL - 1 - i; j++)
      r[i + j] = madc_lo_cc(a[i], b[j], r[i + j]);
    r[NL - 1] = madc_lo(a[i], b[NL - 1 - i], r[NL - 1]);
    if (i == NL - 2) {
      r[NL - 1] = mul_hi(a[i], b[0]) + r[NL - 1];
      continue;
    }
    r[i + 1] = mad_hi_cc(a[i], b[0], r[i + 1]);
    FR254_UNROLL
    for (int j = 1; j < NL - 2 - i; j++)
      r[i + j + 1] = madc_hi_cc(a[i], b[j], r[i + j + 1]);
    r[NL - 1] = madc_hi(a[i], b[NL - 2 - i], r[NL - 1]);
  }
}

// ---------------------------------------------------------------------------
// Adds and the reduce
// ---------------------------------------------------------------------------

// r = a + b mod 2^256 for each element: the carry out of 2^256 is dropped,
// as the reference's add drops it.
template <int N>
__device__ __forceinline__ Vec<N> add_wrap(const Vec<N>& a, const Vec<N>& b) {
  Vec<N> r;
  FR254_UNROLL
  for (int e = 0; e < N; e++) {
    r.e[e].v[0] = add_cc(a.e[e].v[0], b.e[e].v[0]);
    FR254_UNROLL
    for (int i = 1; i < NL - 1; i++) r.e[e].v[i] = addc_cc(a.e[e].v[i], b.e[e].v[i]);
    r.e[e].v[NL - 1] = addc(a.e[e].v[NL - 1], b.e[e].v[NL - 1]);
  }
  return r;
}

// a = a - m if a >= m (fieldslab.cond_sub_const).
__device__ __forceinline__ void cond_sub(uint32_t (&a)[NL],
                                         const uint32_t (&m)[NL]) {
  uint32_t d[NL];
  d[0] = sub_cc(a[0], m[0]);
  FR254_UNROLL
  for (int i = 1; i < NL; i++) d[i] = subc_cc(a[i], m[i]);
  const uint32_t borrow = subc(0, 0);
  FR254_UNROLL
  for (int i = 0; i < NL; i++) a[i] = borrow ? a[i] : d[i];
}

// a mod p for any a < 2^256: the residue of the reference's
// `while (a >= p) a -= p`, by conditional subtracts of 4p, 2p, p
// (2^256 < 6p).
template <int N>
__device__ __forceinline__ Vec<N> red(const Vec<N>& a) {
  Vec<N> r = a;
  const uint32_t p4[NL] = {FR254_P4};
  const uint32_t p2[NL] = {FR254_P2};
  const uint32_t p[NL] = {FR254_P};
  FR254_UNROLL
  for (int e = 0; e < N; e++) {
    cond_sub(r.e[e].v, p4);
    cond_sub(r.e[e].v, p2);
    cond_sub(r.e[e].v, p);
  }
  return r;
}

// The reference's add for any canonical operands: wrap at 2^256, reduce.
template <int N>
__device__ __forceinline__ Vec<N> add_wrap_red(const Vec<N>& a,
                                               const Vec<N>& b) {
  return red(add_wrap(a, b));
}

// Add for reduced operands (a, b < p): never wraps, one conditional
// subtract of p.  Bit-identical to add_wrap_red there.
template <int N>
__device__ __forceinline__ Vec<N> add_rr(const Vec<N>& a, const Vec<N>& b) {
  Vec<N> s = add_wrap(a, b);
  const uint32_t p[NL] = {FR254_P};
  FR254_UNROLL
  for (int e = 0; e < N; e++) cond_sub(s.e[e].v, p);
  return s;
}

// The reference's subtract (field_arithmetic.cpp:184-219) for any operands
// < 2^256: d = a - b mod 2^256 by a borrow chain; when it borrows (a < b),
// p is added with its 2^256 carry dropped.  That is (a + p) - b mod 2^256,
// the reference's pre-add of p, with no reduce.  The borrow selects p as a
// mask, so the add runs unconditionally.
template <int N>
__device__ __forceinline__ Vec<N> sub(const Vec<N>& a, const Vec<N>& b) {
  Vec<N> r;
  const uint32_t p[NL] = {FR254_P};
  FR254_UNROLL
  for (int e = 0; e < N; e++) {
    uint32_t d[NL];
    d[0] = sub_cc(a.e[e].v[0], b.e[e].v[0]);
    FR254_UNROLL
    for (int i = 1; i < NL; i++) d[i] = subc_cc(a.e[e].v[i], b.e[e].v[i]);
    const uint32_t mask = subc(0, 0);  // all ones after a borrow
    r.e[e].v[0] = add_cc(d[0], p[0] & mask);
    FR254_UNROLL
    for (int i = 1; i < NL - 1; i++) r.e[e].v[i] = addc_cc(d[i], p[i] & mask);
    r.e[e].v[NL - 1] = addc(d[NL - 1], p[NL - 1] & mask);
  }
  return r;
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// Exact 512-bit products a[e] * b[e].
template <int N>
__device__ __forceinline__ void mul_wide(Wide (&w)[N], const Vec<N>& a,
                                         const Vec<N>& b) {
  FR254_UNROLL
  for (int e = 0; e < N; e++) {
    uint32_t r[2 * NL];
    rows(r, a.e[e].v, b.e[e].v);
    FR254_UNROLL
    for (int i = 0; i < NL; i++) {
      w[e].lo[i] = r[i];
      w[e].hi[i] = r[NL + i];
    }
  }
}

// Exact 512-bit squares: each off-diagonal product once, doubled, plus
// the diagonal (28 + 8 limb products instead of 64).
template <int N>
__device__ __forceinline__ void square_wide(Wide (&w)[N], const Vec<N>& a) {
  FR254_UNROLL
  for (int e = 0; e < N; e++) {
    const uint32_t(&x)[NL] = a.e[e].v;
    uint32_t r[2 * NL];
    FR254_UNROLL
    for (int i = 0; i < 2 * NL; i++) r[i] = 0;
    FR254_UNROLL
    for (int i = 0; i < NL - 1; i++) {
      // Row i: x[i] * x[j], j > i, at limbs i + j (low) and i + j + 1
      // (high); limb i + 8 is still zero.
      r[2 * i + 1] = mad_lo_cc(x[i], x[i + 1], r[2 * i + 1]);
      FR254_UNROLL
      for (int j = i + 2; j < NL; j++) r[i + j] = madc_lo_cc(x[i], x[j], r[i + j]);
      r[i + NL] = addc(0, 0);
      // The running sum is below 2^(32 (i + 9)): nothing carries out
      // of limb i + 8.
      if (i == NL - 2) {
        r[2 * i + 2] = mul_hi(x[i], x[i + 1]) + r[2 * i + 2];
      } else {
        r[2 * i + 2] = mad_hi_cc(x[i], x[i + 1], r[2 * i + 2]);
        FR254_UNROLL
        for (int j = i + 2; j < NL - 1; j++)
          r[i + j + 1] = madc_hi_cc(x[i], x[j], r[i + j + 1]);
        r[i + NL] = madc_hi(x[i], x[NL - 1], r[i + NL]);
      }
    }
    // Off-diagonal sum < 2^511: doubling drops nothing.
    FR254_UNROLL
    for (int i = 2 * NL - 1; i > 0; i--) r[i] = (r[i] << 1) | (r[i - 1] >> 31);
    r[0] <<= 1;
    r[0] = mad_lo_cc(x[0], x[0], r[0]);
    r[1] = madc_hi_cc(x[0], x[0], r[1]);
    FR254_UNROLL
    for (int i = 1; i < NL - 1; i++) {
      r[2 * i] = madc_lo_cc(x[i], x[i], r[2 * i]);
      r[2 * i + 1] = madc_hi_cc(x[i], x[i], r[2 * i + 1]);
    }
    r[2 * NL - 2] = madc_lo_cc(x[NL - 1], x[NL - 1], r[2 * NL - 2]);
    r[2 * NL - 1] = madc_hi(x[NL - 1], x[NL - 1], r[2 * NL - 1]);
    FR254_UNROLL
    for (int i = 0; i < NL; i++) {
      w[e].lo[i] = r[i];
      w[e].hi[i] = r[NL + i];
    }
  }
}

// The truncated k-fold 512 -> 256 reduction (field_arithmetic.cpp:250-330):
//   m = high * k; hc = m mod 2^256; mh = m >> 256;
//   if mh != 0: hc = add(hc, (mh * k) mod 2^256)   -- (mh*k) >> 256 dropped
//   return add(low, hc)
// The fold is computed for every element and kept where mh != 0, which
// is the reference's select.  Its high == 0 early-out needs no branch: it
// gives hc == 0 and add(low, 0) == red(low).
template <int N>
__device__ __forceinline__ Vec<N> reduce_wide(const Wide (&w)[N]) {
  const uint32_t k[NL] = {FR254_K};
  Vec<N> lo, hc, t;
  bool mh_any[N];
  FR254_UNROLL
  for (int e = 0; e < N; e++) {
    uint32_t m[2 * NL], mh[NL];
    rows(m, w[e].hi, k);
    uint32_t any = 0;
    FR254_UNROLL
    for (int i = 0; i < NL; i++) {
      lo.e[e].v[i] = w[e].lo[i];
      hc.e[e].v[i] = m[i];
      mh[i] = m[NL + i];
      any |= mh[i];
    }
    mh_any[e] = any != 0;
    rows_low(t.e[e].v, mh, k);
  }
  const Vec<N> folded = add_wrap_red(hc, t);
  FR254_UNROLL
  for (int e = 0; e < N; e++) {
    if (mh_any[e]) hc.e[e] = folded.e[e];
  }
  return add_wrap_red(lo, hc);
}

template <int N>
__device__ __forceinline__ Vec<N> mul(const Vec<N>& a, const Vec<N>& b) {
  Wide w[N];
  mul_wide(w, a, b);
  return reduce_wide(w);
}

template <int N>
__device__ __forceinline__ Vec<N> square(const Vec<N>& a) {
  Wide w[N];
  square_wide(w, a);
  return reduce_wide(w);
}

// a^5 = ((a^2)^2) * a (field_arithmetic.cpp:332-338).
template <int N>
__device__ __forceinline__ Vec<N> power5(const Vec<N>& a) {
  return mul(square(square(a)), a);
}

// mul(a, c) for reduced a (a < p) and a one-limb c <= 26, bit-identical to
// the general mul.  The product is 9 limbs, so both k-folds are one limb
// by field products, and the second fold never runs: a c < 26 p < 5 2^256,
// so high = (a c) >> 256 <= 4, and high k < 4 2^252 < 2^256 leaves mh = 0.
// (fieldslab.mul_small_reduced.)
template <int N>
__device__ __forceinline__ Vec<N> mul_small_rr(const Vec<N>& a,
                                               const uint32_t (&c)[N]) {
  const uint32_t k[NL] = {FR254_K};
  Vec<N> lo, hc;
  FR254_UNROLL
  for (int e = 0; e < N; e++) {
    uint32_t r[NL + 1];
    rows_word(r, a.e[e].v, c[e]);
    FR254_UNROLL
    for (int i = 0; i < NL; i++) lo.e[e].v[i] = r[i];
    rows_word(r, k, r[NL]);
    FR254_UNROLL
    for (int i = 0; i < NL; i++) hc.e[e].v[i] = r[i];
  }
  return add_wrap_red(lo, hc);
}

// ---------------------------------------------------------------------------
// The one-thread core (K4's body, and K1's and K3's at G = 1): the same
// values as mul_wide, square_wide, reduce_wide, red and mul_small_rr,
// formed for the pipes of a full wave.  The element split keeps the forms
// above.
//
// What bounds the forms above at a full wave is the integer ALU pipe, not
// the multiplier: each multiply result costs one IMAD and one IADD3.X
// (ptxas turns a mad.*.cc chain into products plus carry adds), and every
// conditional subtract eight IADD3.X and eight SEL.  Hopper's IMAD.WIDE.U32
// adds a whole 64-bit product into a register pair with carry in and out,
// so here:
//   - products are sums of 64-bit products, each a limb pair.  A row's
//     products at even limb offsets go to one accumulator (E) and those at
//     odd offsets to another (O, one limb down), so that no two products of
//     a chain overlap; each chain is one carry chain of IMAD.WIDE.U32, and
//     E + O 2^32 is one add chain at the end;
//   - the reduce of a < 2^256 (a mod p, the value red gives) takes its
//     quotient from the top limb: q = floor(a_7 / (p_7 + 1)) is floor(a / p)
//     or one below it, so a + q (2^256 - p) (two chains of IMAD.WIDE.U32)
//     and one conditional subtract of p leave a mod p.  Two subtracts fewer
//     than red's 4p, 2p, p;
//   - the mh != 0 fold of reduce_wide is a branch: it runs only where the
//     reference's select keeps it (mh == 0 only when high < 19).
// ---------------------------------------------------------------------------

#define FR254_PNEG /* 2^256 - p */ \
  0x0fffffffu, 0xbc1e0a6cu, 0x86468f6eu, 0xd7cc17b7u, \
  0x7e7ea7a2u, 0x47afba49u, 0x1ece5fd6u, 0xcf9bb18du

// acc[p .. p + 2n) += sum_t a b[j0 + 2t] 2^(64 t): n 64-bit products in one
// carry chain, then the carry into acc[p + 2n] where acc has it.
template <int M>
__device__ __forceinline__ void mad_pairs(uint32_t (&acc)[M], int p, uint32_t a,
                                          const uint32_t (&b)[NL], int j0, int n) {
  if (n <= 0) return;
  acc[p] = mad_lo_cc(a, b[j0], acc[p]);
  acc[p + 1] = madc_hi_cc(a, b[j0], acc[p + 1]);
  FR254_UNROLL
  for (int t = 1; t < n; t++) {
    acc[p + 2 * t] = madc_lo_cc(a, b[j0 + 2 * t], acc[p + 2 * t]);
    acc[p + 2 * t + 1] = madc_hi_cc(a, b[j0 + 2 * t], acc[p + 2 * t + 1]);
  }
  if (p + 2 * n < M) acc[p + 2 * n] = addc(acc[p + 2 * n], 0);
}

// r = E + O 2^32 over 2N limbs (O has 2N - 1), the carry out dropped.
template <int N>
__device__ __forceinline__ void join_pairs(uint32_t (&r)[N], const uint32_t (&E)[N],
                                           const uint32_t (&O)[N - 1]) {
  r[0] = E[0];
  r[1] = add_cc(E[1], O[0]);
  FR254_UNROLL
  for (int k = 2; k < N - 1; k++) r[k] = addc_cc(E[k], O[k - 1]);
  r[N - 1] = addc(E[N - 1], O[N - 2]);
}

template <int N>
__device__ __forceinline__ void clear(uint32_t (&a)[N]) {
  FR254_UNROLL
  for (int k = 0; k < N; k++) a[k] = 0;
}

// r = a * b, 16 limbs, exact (rows).  Row i's products a_i b_j sit at limb
// i + j: those with i + j even in E, odd in O.  Every chain ends below a
// limb that holds at most the earlier rows' carries, so nothing carries
// further; the total is below 2^512.
__device__ __forceinline__ void mul_wide_pairs(uint32_t (&r)[2 * NL],
                                               const uint32_t (&a)[NL],
                                               const uint32_t (&b)[NL]) {
  uint32_t E[2 * NL], O[2 * NL - 1];
  clear(E);
  clear(O);
  FR254_UNROLL
  for (int i = 0; i < NL; i++) {
    const int je = i & 1, jo = je ^ 1;
    mad_pairs(E, i + je, a[i], b, je, NL / 2);
    mad_pairs(O, i + jo - 1, a[i], b, jo, NL / 2);
  }
  join_pairs(r, E, O);
}

// Low 256 bits of a * b (rows_low): the products at limbs below 8, the
// one at limb 7 by its low word alone, every carry out of limb 7 dropped.
__device__ __forceinline__ void mul_low_pairs(uint32_t (&r)[NL],
                                              const uint32_t (&a)[NL],
                                              const uint32_t (&b)[NL]) {
  uint32_t E[NL], O[NL - 1];
  clear(E);
  clear(O);
  FR254_UNROLL
  for (int i = 0; i < NL; i++) {
    const int je = i & 1, jo = je ^ 1;
    // E: pairs at limbs i + je + 2t up to limb 6, so each ends at limb 7.
    mad_pairs(E, i + je, a[i], b, je, (NL - 2 - (i + je)) / 2 + 1);
    // O: pairs at odd limbs up to 5, then the low word at limb 7.
    const int p0 = i + jo, n = p0 <= NL - 3 ? (NL - 3 - p0) / 2 + 1 : 0;
    const int jl = jo + 2 * n;
    if (n > 0) {
      O[p0 - 1] = mad_lo_cc(a[i], b[jo], O[p0 - 1]);
      O[p0] = madc_hi_cc(a[i], b[jo], O[p0]);
      FR254_UNROLL
      for (int t = 1; t < n; t++) {
        O[p0 - 1 + 2 * t] = madc_lo_cc(a[i], b[jo + 2 * t], O[p0 - 1 + 2 * t]);
        O[p0 + 2 * t] = madc_hi_cc(a[i], b[jo + 2 * t], O[p0 + 2 * t]);
      }
      O[NL - 2] = madc_lo(a[i], b[jl], O[NL - 2]);
    } else {
      O[NL - 2] = a[i] * b[jl] + O[NL - 2];
    }
  }
  join_pairs(r, E, O);
}

// r = x^2, 16 limbs, exact (square_wide): the off-diagonal products once
// in E and O, joined, doubled, plus the diagonal.
__device__ __forceinline__ void square_wide_pairs(uint32_t (&r)[2 * NL],
                                                  const uint32_t (&x)[NL]) {
  uint32_t E[2 * NL], O[2 * NL - 1];
  clear(E);
  clear(O);
  FR254_UNROLL
  for (int i = 0; i < NL - 1; i++) {
    mad_pairs(E, 2 * i + 2, x[i], x, i + 2, (NL - 1 - i) / 2);
    mad_pairs(O, 2 * i, x[i], x, i + 1, (NL - i) / 2);
  }
  join_pairs(r, E, O);
  // Off-diagonal sum < 2^511: doubling drops nothing.
  FR254_UNROLL
  for (int i = 2 * NL - 1; i > 0; i--) r[i] = (r[i] << 1) | (r[i - 1] >> 31);
  r[0] <<= 1;
  r[0] = mad_lo_cc(x[0], x[0], r[0]);
  r[1] = madc_hi_cc(x[0], x[0], r[1]);
  FR254_UNROLL
  for (int i = 1; i < NL - 1; i++) {
    r[2 * i] = madc_lo_cc(x[i], x[i], r[2 * i]);
    r[2 * i + 1] = madc_hi_cc(x[i], x[i], r[2 * i + 1]);
  }
  r[2 * NL - 2] = madc_lo_cc(x[NL - 1], x[NL - 1], r[2 * NL - 2]);
  r[2 * NL - 1] = madc_hi(x[NL - 1], x[NL - 1], r[2 * NL - 1]);
}

// a += q c mod 2^256 for one word q: the even limbs of c, then the odd.
__device__ __forceinline__ void add_word_times(uint32_t (&a)[NL], uint32_t q,
                                               const uint32_t (&c)[NL]) {
  a[0] = mad_lo_cc(q, c[0], a[0]);
  a[1] = madc_hi_cc(q, c[0], a[1]);
  FR254_UNROLL
  for (int j = 2; j < NL - 2; j += 2) {
    a[j] = madc_lo_cc(q, c[j], a[j]);
    a[j + 1] = madc_hi_cc(q, c[j], a[j + 1]);
  }
  a[NL - 2] = madc_lo_cc(q, c[NL - 2], a[NL - 2]);
  a[NL - 1] = madc_hi(q, c[NL - 2], a[NL - 1]);
  a[1] = mad_lo_cc(q, c[1], a[1]);
  a[2] = madc_hi_cc(q, c[1], a[2]);
  FR254_UNROLL
  for (int j = 3; j < NL - 1; j += 2) {
    a[j] = madc_lo_cc(q, c[j], a[j]);
    a[j + 1] = madc_hi_cc(q, c[j], a[j + 1]);
  }
  a[NL - 1] = madc_lo(q, c[NL - 1], a[NL - 1]);
}

// a mod p for any a < 2^256: the value red gives.  With D = p_7 + 1,
// floor(a_7 / D) <= floor(a / p) <= floor((a_7 + 1) / p_7), and the two
// bounds differ by at most one (a_7 < 2^32), so after subtracting
// q = floor(a_7 / D) times p one conditional subtract remains.  q itself:
// floor(5 a_7 / 2^32) is floor(a_7 / D) or one below it (5 = floor(2^32 /
// D)), and one compare settles it; q <= 5.
__device__ __forceinline__ void red_quotient(uint32_t (&a)[NL]) {
  const uint32_t pneg[NL] = {FR254_PNEG};
  const uint32_t p[NL] = {FR254_P};
  constexpr uint32_t D = 0x30644e73u;
  uint32_t q = mul_hi(a[NL - 1], 5u);
  q += a[NL - 1] >= (q + 1) * D ? 1u : 0u;
  add_word_times(a, q, pneg);
  cond_sub(a, p);
}

__device__ __forceinline__ Fe add_wrap_red_quotient(const Fe& a, const Fe& b) {
  Vec<1> x, y;
  x.e[0] = a;
  y.e[0] = b;
  Fe r = add_wrap(x, y).e[0];
  red_quotient(r.v);
  return r;
}

// reduce_wide of the product p (low limbs first).
__device__ __forceinline__ Fe reduce_wide_pairs(const uint32_t (&p)[2 * NL]) {
  const uint32_t k[NL] = {FR254_K};
  uint32_t hi[NL], m[2 * NL], mh[NL];
  Fe lo, hc;
  FR254_UNROLL
  for (int i = 0; i < NL; i++) {
    lo.v[i] = p[i];
    hi[i] = p[NL + i];
  }
  mul_wide_pairs(m, hi, k);
  uint32_t any = 0;
  FR254_UNROLL
  for (int i = 0; i < NL; i++) {
    hc.v[i] = m[i];
    mh[i] = m[NL + i];
    any |= mh[i];
  }
  if (any != 0) {
    Fe t;
    mul_low_pairs(t.v, mh, k);
    hc = add_wrap_red_quotient(hc, t);
  }
  return add_wrap_red_quotient(lo, hc);
}

// a^5 = ((a^2)^2) * a.
__device__ __forceinline__ Fe power5_pairs(const Fe& a) {
  uint32_t p[2 * NL];
  square_wide_pairs(p, a.v);
  Fe x = reduce_wide_pairs(p);
  square_wide_pairs(p, x.v);
  x = reduce_wide_pairs(p);
  mul_wide_pairs(p, x.v, a.v);
  return reduce_wide_pairs(p);
}

// mul_small_rr(a, c) for one element: lo + high k mod 2^256 (high <= 4),
// then the reduce.
__device__ __forceinline__ Fe mul_small_quotient(const Fe& a, uint32_t c) {
  const uint32_t k[NL] = {FR254_K};
  uint32_t r[NL + 1];
  rows_word(r, a.v, c);
  Fe x;
  FR254_UNROLL
  for (int i = 0; i < NL; i++) x.v[i] = r[i];
  add_word_times(x.v, r[NL], k);
  red_quotient(x.v);
  return x;
}

// ---------------------------------------------------------------------------
// Digit I/O: the public format, [.., 16] int64 digits of 16 bits each
// ---------------------------------------------------------------------------

// One element from 16 int64 digits, read by value: sum d[i] 2^(16 i) mod
// 2^256, each digit taken as the signed 64-bit value it holds.  Never a
// bit-pack, so d + 2^16 does not alias d and 2^32 + d does not become d
// (ROADMAP traps (f) and (i)); where fr.digits_to_limbs is exact (digits in
// [0, 2^40)) the limbs are the same.  Word w collects the pieces that land
// in it, each below 2^32 in size:
//   d[2w] low 32 bits, d[2w - 2] >> 32 (signed)      -- even digits at 32 w
//   (d[2w + 1] & 0xffff) << 16, bits 16..47 of d[2w - 1], d[2w - 3] >> 48
//                                                    -- odd digits at 32 w + 16
// and one signed carry runs from word to word; pieces above word 7 and the
// last carry are the part at and above 2^256.
__device__ __forceinline__ Fe load_digits(const int64_t* d) {
  Fe r;
  int64_t carry = 0;
  FR254_UNROLL
  for (int w = 0; w < NL; w++) {
    int64_t s = carry + (int64_t)(uint32_t)d[2 * w] +
                (int64_t)((uint64_t)(d[2 * w + 1] & 0xffff) << 16);
    if (w >= 1) s += (d[2 * w - 2] >> 32) + (int64_t)(uint32_t)(d[2 * w - 1] >> 16);
    if (w >= 2) s += d[2 * w - 3] >> 48;
    r.v[w] = (uint32_t)s;
    carry = s >> 32;
  }
  return r;
}

// An element as 16 int64 digits below 2^16.
__device__ __forceinline__ void store_digits(int64_t* d, const Fe& a) {
  FR254_UNROLL
  for (int i = 0; i < NL; i++) {
    d[2 * i] = a.v[i] & 0xffffu;
    d[2 * i + 1] = a.v[i] >> 16;
  }
}

// mul(a, c) for any a < 2^256 and any one-limb c: the general form of
// mul_small_rr, with the second fold and its mh != 0 select (the per-op
// check kernel holds it on arbitrary operands).
__device__ __forceinline__ Vec<1> mul_small(const Vec<1>& a, uint32_t c) {
  const uint32_t k[NL] = {FR254_K};
  Vec<1> lo, hc, t;
  uint32_t r[NL + 1];
  rows_word(r, a.e[0].v, c);
  FR254_UNROLL
  for (int i = 0; i < NL; i++) lo.e[0].v[i] = r[i];
  rows_word(r, k, r[NL]);
  const uint32_t mh = r[NL];
  FR254_UNROLL
  for (int i = 0; i < NL; i++) hc.e[0].v[i] = r[i];
  rows_word(r, k, mh);
  FR254_UNROLL
  for (int i = 0; i < NL; i++) t.e[0].v[i] = r[i];
  const Vec<1> folded = add_wrap_red(hc, t);
  if (mh != 0) hc = folded;
  return add_wrap_red(lo, hc);
}

// ---------------------------------------------------------------------------
// The per-op check kernel's operations (poseidon_kernels.cu::fr_op_digits_kernel)
// ---------------------------------------------------------------------------

enum FrOp {
  OP_MUL = 0,
  OP_SQUARE = 1,
  OP_POWER5 = 2,
  OP_ADD_WRAP_RED = 3,
  OP_ADD_RR = 4,
  OP_MUL_SMALL = 5,
  OP_REDUCE_WIDE = 6,
  OP_RED = 7,
  OP_MUL_SMALL_RR = 8,
  OP_SUB = 9,
};

// One operation on x (and y, or the constant c); reduce_wide reduces the
// product whose low half is x and high half x_hi.
__device__ __forceinline__ Fe fr_op_apply(int op, const Fe& x, const Fe& x_hi,
                                          const Fe& y, uint32_t c) {
  Vec<1> a, b, r;
  a.e[0] = x;
  b.e[0] = y;
  switch (op) {
    case OP_MUL: r = mul(a, b); break;
    case OP_SQUARE: r = square(a); break;
    case OP_POWER5: r = power5(a); break;
    case OP_ADD_WRAP_RED: r = add_wrap_red(a, b); break;
    case OP_ADD_RR: r = add_rr(a, b); break;
    case OP_MUL_SMALL: r = mul_small(a, c); break;
    case OP_REDUCE_WIDE: {
      Wide w[1];
#pragma unroll
      for (int i = 0; i < NL; i++) {
        w[0].lo[i] = x.v[i];
        w[0].hi[i] = x_hi.v[i];
      }
      r = reduce_wide(w);
      break;
    }
    case OP_RED: r = red(a); break;
    case OP_SUB: r = sub(a, b); break;
    default: {  // OP_MUL_SMALL_RR
      const uint32_t cs[1] = {c};
      r = mul_small_rr(a, cs);
      break;
    }
  }
  return r.e[0];
}

}  // namespace fr254
