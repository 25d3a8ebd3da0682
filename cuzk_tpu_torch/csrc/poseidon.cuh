// The Poseidon permutation and the per-item bodies of the sponge (K1) and
// verify (K3) kernels, in two mappings: one thread per state, on the same
// permutation body as the raw permutation (K4), and the element split
// (three lanes per state, below).  Each body is what one thread or one lane
// group computes for one row or one proof; the kernels in
// poseidon_kernels.cu map them onto the grid.
#pragma once

#include "fr254.cuh"

namespace fr254 {

__device__ __forceinline__ Fe load(const uint32_t* p) {
  Fe r;
  FR254_UNROLL
  for (int i = 0; i < NL; i++) r.v[i] = p[i];
  return r;
}

__device__ __forceinline__ void store(uint32_t* p, const Fe& a) {
  FR254_UNROLL
  for (int i = 0; i < NL; i++) p[i] = a.v[i];
}

// RC[r][0..2].
__device__ __forceinline__ Vec<T> round_constants(int r) {
  Vec<T> c;
  FR254_UNROLL
  for (int i = 0; i < T; i++) c.e[i] = load(ROUND_CONSTANTS + (r * T + i) * NL);
  return c;
}

// ---------------------------------------------------------------------------
// The one-thread permutation: K4's body, and K1's and K3's at G = 1.  At a
// full wave every thread of the launch is resident at once, about four
// warps a scheduler, so what bounds it is the issue rate.  With one branch
// a round on its kind and every routine inlined, the permutation compiles
// to about 9,500 SASS instructions (150 KB) and issues 0.44 instructions a
// clock a scheduler there (PERF.md): its warps wait on instruction fetch
// and on the ALU pipe.  Here:
//   - one S-box's code serves every round: a full round runs it three
//     times, rotating the state, a partial round once (K4 is about 2,200
//     instructions);
//   - the products and reduces are fr254.cuh's one-thread forms (limb
//     pairs on the multiply pipe, the quotient reduce), so the multiply
//     pipe, not the ALU, carries most of the work;
//   - the MDS rows keep their sums in order, add_rr(add_rr(m0, m1), m2),
//     then the round constant.
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe mds_row_quotient(const Vec<T>& s,
                                               const uint32_t (&coef)[T]) {
  Vec<1> a, b, c;
  a.e[0] = mul_small_quotient(s.e[0], coef[0]);
  b.e[0] = mul_small_quotient(s.e[1], coef[1]);
  c.e[0] = mul_small_quotient(s.e[2], coef[2]);
  return add_rr(add_rr(a, b), c).e[0];
}

// The 64 rounds of the Poseidon permutation (poseidon.cpp:60-87) after the
// round-0 constant add: per round, S-box, MDS, add RC[r+1].  The state is
// reduced on entry, so every operand is reduced and each add is add_rr,
// which equals the reference's add there.
__device__ __forceinline__ void permute_rounds_ilp(Vec<T>& s) {
  const uint32_t mds[T * T] = {7, 23, 8, 26, 5, 4, 15, 20, 9};
#pragma unroll 1
  for (int r = 0; r < ROUNDS; r++) {
    const bool full = r < HALF_FULL || r >= ROUNDS - HALF_FULL;
#pragma unroll 1
    for (int e = 0; e < (full ? T : 1); e++) {
      const Fe x = power5_pairs(s.e[0]);
      if (full) {
        s.e[0] = s.e[1];
        s.e[1] = s.e[2];
        s.e[2] = x;
      } else {
        s.e[0] = x;
      }
    }
    Vec<T> ns;
    FR254_UNROLL
    for (int q = 0; q < T; q++) {
      const uint32_t coef[T] = {mds[T * q], mds[T * q + 1], mds[T * q + 2]};
      ns.e[q] = mds_row_quotient(s, coef);
    }
    if (r + 1 < ROUNDS) ns = add_rr(ns, round_constants(r + 1));
    s = ns;
  }
}

// The permutation on the reduced state the sponge feeds it (K1, K3): round
// 0's constant add is add_rr too.
__device__ __forceinline__ void permute(Vec<T>& s) {
  s = add_rr(s, round_constants(0));
  permute_rounds_ilp(s);
}

// The permutation on a state of any 256-bit values (K4, the reference's
// batch_permutation): round 0 adds with the full wrap at 2^256 and the
// 4p/2p/p reduce, the same op the sponge's absorb uses.
__device__ __forceinline__ void permute_full_ilp(Vec<T>& s) {
  s = add_wrap_red(s, round_constants(0));
  permute_rounds_ilp(s);
}

__device__ __forceinline__ Vec<T> initial_state(uint32_t ds) {
  Vec<T> s;
  FR254_UNROLL
  for (int i = 0; i < T; i++) s.e[i] = zero();
  s.e[0].v[0] = ds;
  return s;
}

// Absorb x0 (and x1 when two) into s[1] (and s[2]) with the full
// wrapping add (inputs may be >= p), then permute.
__device__ __forceinline__ void absorb(Vec<T>& s, const Fe& x0, const Fe& x1,
                                       bool two) {
  if (two) {
    Vec<2> st, v;
    st.e[0] = s.e[1];
    st.e[1] = s.e[2];
    v.e[0] = x0;
    v.e[1] = x1;
    st = add_wrap_red(st, v);
    s.e[1] = st.e[0];
    s.e[2] = st.e[1];
  } else {
    Vec<1> st, v;
    st.e[0] = s.e[1];
    v.e[0] = x0;
    s.e[1] = add_wrap_red(st, v).e[0];
  }
  permute(s);
}

// K1's two input forms: an input is 8 u32 limbs, or 16 int64 digits read by
// value (fr254.cuh::load_digits, as fr.digits_to_limbs reads them), so that
// a caller holding digits converts nothing before the launch.  INPUT_WORDS<E>
// is an input's width in words of its form.
template <typename E>
constexpr int INPUT_WORDS = sizeof(E) == sizeof(uint32_t) ? NL : 2 * NL;

__device__ __forceinline__ Fe load_input(const uint32_t* x) { return load(x); }

__device__ __forceinline__ Fe load_input(const int64_t* x) {
  return load_digits(x);
}

// K1's body: the width-dynamic sponge (poseidon.cpp:103-126) over the n
// inputs at x (n inputs of either form).  State [ds, 0, 0]; per block of
// two inputs, absorb, then permute; squeeze state[1].  An odd last block
// absorbs one input: the TPU kernel's padded zero is a no-op on the
// reduced state.
template <typename E>
__device__ __forceinline__ Fe sponge_row(const E* x, int n, uint32_t ds) {
  Vec<T> s = initial_state(ds);
  for (int i = 0; i < n; i += 2) {
    const bool two = i + 1 < n;
    const Fe x0 = load_input(x + (int64_t)i * INPUT_WORDS<E>);
    const Fe x1 = two ? load_input(x + (int64_t)(i + 1) * INPUT_WORDS<E>) : x0;
    absorb(s, x0, x1, two);
  }
  return s.e[1];
}

// K3's root, 16 int64 digits, compared with the recomputed digest cur digit
// by digit: digit 2i against cur.v[i] & 0xffff and digit 2i + 1 against
// cur.v[i] >> 16.  The digest's digits are canonical, so a root digit
// outside [0, 2^16) never matches, even where the root's value equals the
// digest (the plain path's (current == root).all(); ROADMAP trap (f)).
__device__ __forceinline__ bool root_matches(const Fe& cur, const int64_t* root) {
  uint64_t diff = 0;
  FR254_UNROLL
  for (int i = 0; i < NL; i++) {
    diff |= (uint64_t)(root[2 * i] ^ (int64_t)(cur.v[i] & 0xffffu));
    diff |= (uint64_t)(root[2 * i + 1] ^ (int64_t)(cur.v[i] >> 16));
  }
  return diff == 0;
}

// A position clamped to [-1, arity]: every position outside [0, arity)
// builds the same group as -1 or arity.
__device__ __forceinline__ int clamp_position(int p, int arity) {
  return p < -1 ? -1 : (p > arity ? arity : p);
}

// K3's body: one proof.  pos [h] int32, sib [h, a-1, 16], leaf [16] and
// root [16] int64 digits, the leaf and siblings read by value
// (fr254.cuh::load_digits).  Per level, slot j of the arity group holds the
// current digest when j == pos, else sibling j - (j > pos) clamped to
// [0, a-2] (cuzk_tpu_torch/merkle.py::_insert_at_position, so an
// out-of-range pos drops the digest exactly as the JAX path does); then a
// ds=3 sponge over the group.  The running digest never leaves registers.
__device__ __forceinline__ bool verify_proof(const int32_t* pos,
                                             const int64_t* sib,
                                             const int64_t* leaf,
                                             const int64_t* root, int h,
                                             int arity) {
  constexpr uint32_t DS_MULTIPLE = 3;
  constexpr int W = 2 * NL;
  Fe cur = load_digits(leaf);
  for (int lvl = 0; lvl < h; lvl++) {
    const int p = clamp_position(pos[lvl], arity);
    const int64_t* sb = sib + (int64_t)lvl * (arity - 1) * W;
    auto slot = [&](int j) {
      if (j == p) return cur;
      int q = j - (j > p ? 1 : 0);
      q = q < 0 ? 0 : (q > arity - 2 ? arity - 2 : q);
      return load_digits(sb + q * W);
    };
    Vec<T> s = initial_state(DS_MULTIPLE);
    for (int j = 0; j < arity; j += 2) {
      const bool two = j + 1 < arity;
      const Fe x0 = slot(j);
      absorb(s, x0, two ? slot(j + 1) : x0, two);
    }
    cur = s.e[1];
  }
  return root_matches(cur, root);
}

// ---------------------------------------------------------------------------
// Element-split mapping (lanes = 3): three lanes of a four-lane group hold
// one state, lane i the whole element s[i] (lane 3 mirrors lane 0 and is
// never read).  The arithmetic is fr254.cuh's batched forms, with no carry
// across lanes: a full round's three S-boxes and the MDS's three rows run
// one per lane, and one shuffle round a round gathers the state for the
// MDS.  Partial rounds compute every lane's S-box and keep lane 0's.
// ---------------------------------------------------------------------------

constexpr int SPLIT_LANES = 3;
constexpr int SPLIT_WIDTH = 4;

// Collectives run on the whole warp, converged: every lane of a warp
// executes the same shuffles in the same order (the kernels keep the lanes
// of a partial last warp working on a copy of a valid item).  A mask per
// group would let the groups of a warp diverge and serialize.
constexpr uint32_t WARP = 0xffffffffu;

__device__ __forceinline__ Fe split_shfl(const Fe& x, int src) {
  Fe r;
  FR254_UNROLL
  for (int i = 0; i < NL; i++) r.v[i] = __shfl_sync(WARP, x.v[i], src, SPLIT_WIDTH);
  return r;
}

// This lane's element: s[row] of the state, row = lane (lane 3: row 0).
struct SplitLane {
  uint32_t row;
  uint32_t coef[T];  // mds[row][0..2]
};

__device__ __forceinline__ SplitLane make_split_lane(uint32_t warp_lane) {
  const uint32_t mds[T * T] = {7, 23, 8, 26, 5, 4, 15, 20, 9};
  SplitLane sl;
  const uint32_t idx = warp_lane % SPLIT_WIDTH;
  sl.row = idx < T ? idx : 0;
  FR254_UNROLL
  for (int j = 0; j < T; j++)
    sl.coef[j] = sl.row == 0 ? mds[j] : (sl.row == 1 ? mds[T + j] : mds[2 * T + j]);
  return sl;
}

// One row of the MDS on the reduced state s:
// coef[0] s0 + coef[1] s1 + coef[2] s2, each product a reduced mul_small
// and the sums add_rr.
__device__ __forceinline__ Fe mds_row(const Vec<T>& s,
                                      const uint32_t (&coef)[T]) {
  const Vec<T> m = mul_small_rr(s, coef);
  Vec<1> a, b, c;
  a.e[0] = m.e[0];
  b.e[0] = m.e[1];
  c.e[0] = m.e[2];
  return add_rr(add_rr(a, b), c).e[0];
}

__device__ __forceinline__ Fe split_round_constant(int r, const SplitLane& sl) {
  return load(ROUND_CONSTANTS + (r * T + sl.row) * NL);
}

__device__ __forceinline__ void permute_rounds_split(Fe& mine,
                                                     const SplitLane& sl) {
#pragma unroll 1
  for (int r = 0; r < ROUNDS; r++) {
    Vec<1> x;
    x.e[0] = mine;
    x = power5(x);
    if (r < HALF_FULL || r >= ROUNDS - HALF_FULL || sl.row == 0) mine = x.e[0];
    Vec<T> s;
    FR254_UNROLL
    for (int j = 0; j < T; j++) s.e[j] = split_shfl(mine, j);
    Vec<1> ns;
    ns.e[0] = mds_row(s, sl.coef);
    if (r + 1 < ROUNDS) {
      Vec<1> rc;
      rc.e[0] = split_round_constant(r + 1, sl);
      ns = add_rr(ns, rc);
    }
    mine = ns.e[0];
  }
}

// Round 0's constant add (add_rr: the sponge's state is reduced), then the
// rounds.
__device__ __forceinline__ void permute_split(Fe& mine, const SplitLane& sl) {
  Vec<1> x, rc;
  x.e[0] = mine;
  rc.e[0] = split_round_constant(0, sl);
  mine = add_rr(x, rc).e[0];
  permute_rounds_split(mine, sl);
}

// Lanes 1 and 2 absorb x0 and (when two) x1 into s[1] and s[2].
__device__ __forceinline__ void absorb_split(Fe& mine, const Fe& x, bool takes,
                                             const SplitLane& sl) {
  if (takes) {
    Vec<1> s, v;
    s.e[0] = mine;
    v.e[0] = x;
    mine = add_wrap_red(s, v).e[0];
  }
  permute_split(mine, sl);
}

// K1's body (sponge_row) in the element-split mapping, on either input
// form; every lane returns s[1].
template <typename E>
__device__ __forceinline__ Fe sponge_row_split(const E* x, int n, uint32_t ds,
                                               const SplitLane& sl) {
  Fe mine = zero();
  if (sl.row == 0) mine.v[0] = ds;
  for (int i = 0; i < n; i += 2) {
    const int j = i + (int)sl.row - 1;  // lane 1 takes input i, lane 2 i + 1
    const bool takes = sl.row > 0 && j < n;
    const Fe v = takes ? load_input(x + (int64_t)j * INPUT_WORDS<E>) : mine;
    absorb_split(mine, v, takes, sl);
  }
  return split_shfl(mine, 1);
}

// K3's body (verify_proof) in the element-split mapping.
__device__ __forceinline__ bool verify_proof_split(const int32_t* pos,
                                                   const int64_t* sib,
                                                   const int64_t* leaf,
                                                   const int64_t* root, int h,
                                                   int arity,
                                                   const SplitLane& sl) {
  constexpr uint32_t DS_MULTIPLE = 3;
  constexpr int W = 2 * NL;
  Fe cur = load_digits(leaf);
  for (int lvl = 0; lvl < h; lvl++) {
    const int p = clamp_position(pos[lvl], arity);
    const int64_t* sb = sib + (int64_t)lvl * (arity - 1) * W;
    Fe mine = zero();
    if (sl.row == 0) mine.v[0] = DS_MULTIPLE;
    for (int j0 = 0; j0 < arity; j0 += 2) {
      const int j = j0 + (int)sl.row - 1;
      const bool takes = sl.row > 0 && j < arity;
      Fe v = cur;
      if (takes && j != p) {
        int q = j - (j > p ? 1 : 0);
        q = q < 0 ? 0 : (q > arity - 2 ? arity - 2 : q);
        v = load_digits(sb + q * W);
      }
      absorb_split(mine, v, takes, sl);
    }
    cur = split_shfl(mine, 1);
  }
  return root_matches(cur, root);
}

}  // namespace fr254
