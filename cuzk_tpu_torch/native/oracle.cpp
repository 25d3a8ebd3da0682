// Native host oracle of cuzk_tpu_torch: BN254-Fr arithmetic, Poseidon, Merkle.
//
// Implements the exact reference semantics pinned in SURVEY.md Appendix A
// (verified against the compiled reference CPU sources): wrap-at-2^256 adds,
// the truncated k-fold 512->256 reduction with the CPU k constant, the
// t=3 Poseidon sponge, and n-ary Merkle roots.  This is an independent
// implementation (4x64 limbs via __uint128_t intrinsics; the Python oracle
// uses bignums, the JAX paths use 16-bit digit vectors) used as a fast
// cross-check and golden-vector generator.  A copy of cuzk_tpu's
// native/oracle.cpp, so that the port needs nothing of that package.
//
// C ABI; built as a shared library by cuzk_tpu_torch.native.build_oracle().

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using u64 = std::uint64_t;
using u128 = unsigned __int128;

struct Fe {
  u64 v[4];  // little-endian 64-bit limbs
};

// BN254 Fr modulus and k = 2^256 mod p (the CPU constant — the CUDA copy in
// the reference is off by +4 and is deliberately NOT used; SURVEY.md B.1).
constexpr Fe P = {{0x43E1F593F0000001ull, 0x2833E84879B97091ull,
                   0xB85045B68181585Dull, 0x30644E72E131A029ull}};
constexpr Fe KFOLD = {{0xAC96341C4FFFFFFBull, 0x36FC76959F60CD29ull,
                       0x666EA36F7879462Eull, 0x0E0A77C19A07DF2Full}};

inline int cmp(const Fe &a, const Fe &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] < b.v[i] ? -1 : 1;
  }
  return 0;
}

// (a + b) mod 2^256; returns nothing extra — the carry out is dropped,
// matching the reference's wrapping limb add.
inline Fe wrap_add(const Fe &a, const Fe &b) {
  Fe r;
  u128 acc = 0;
  for (int i = 0; i < 4; ++i) {
    acc += (u128)a.v[i] + b.v[i];
    r.v[i] = (u64)acc;
    acc >>= 64;
  }
  return r;
}

// (a - b) mod 2^256 (final borrow dropped).
inline Fe wrap_sub(const Fe &a, const Fe &b) {
  Fe r;
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return r;
}

// Subtractive reduction: while (a >= p) a -= p (<= 5 iterations for a < 2^256).
inline Fe red(Fe a) {
  while (cmp(a, P) >= 0) a = wrap_sub(a, P);
  return a;
}

// Field add: wrap at 2^256, then reduce.
inline Fe fadd(const Fe &a, const Fe &b) { return red(wrap_add(a, b)); }

// Field subtract with modulus pre-add when a < b.
inline Fe fsub(const Fe &a, const Fe &b) {
  Fe t = a;
  if (cmp(a, b) < 0) t = wrap_add(a, P);  // 2^256 carry dropped
  return wrap_sub(t, b);
}

// Exact 512-bit schoolbook product.
inline void mul_wide(const Fe &a, const Fe &b, u64 out[8]) {
  std::memset(out, 0, 8 * sizeof(u64));
  for (int i = 0; i < 4; ++i) {
    u64 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)a.v[i] * b.v[j] + out[i + j] + carry;
      out[i + j] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    out[i + 4] += carry;
  }
}

// The truncated k-fold reduction (SURVEY.md Appendix A): when mh != 0 the
// (mh*k) >> 256 term is dropped and the combining adds wrap at 2^256.
inline Fe reduce_wide(const u64 prod[8]) {
  Fe low = {{prod[0], prod[1], prod[2], prod[3]}};
  Fe high = {{prod[4], prod[5], prod[6], prod[7]}};
  if ((high.v[0] | high.v[1] | high.v[2] | high.v[3]) == 0) return red(low);

  u64 m[8];
  mul_wide(high, KFOLD, m);
  Fe hc = {{m[0], m[1], m[2], m[3]}};
  Fe mh = {{m[4], m[5], m[6], m[7]}};
  if ((mh.v[0] | mh.v[1] | mh.v[2] | mh.v[3]) != 0) {
    u64 mk[8];
    mul_wide(mh, KFOLD, mk);
    Fe mk_low = {{mk[0], mk[1], mk[2], mk[3]}};  // high half dropped entirely
    hc = fadd(hc, mk_low);
  }
  return fadd(low, hc);
}

inline Fe fmul(const Fe &a, const Fe &b) {
  u64 prod[8];
  mul_wide(a, b, prod);
  return reduce_wide(prod);
}

inline Fe fpow5(const Fe &a) {
  Fe a2 = fmul(a, a);
  Fe a4 = fmul(a2, a2);
  return fmul(a4, a);
}

// ---------------------------------------------------------------------------
// Poseidon t=3, R_F=8, R_P=56 (poseidon.cpp:8-126 semantics)
// ---------------------------------------------------------------------------

constexpr int T = 3;
constexpr int FULL_ROUNDS = 8;
constexpr int PARTIAL_ROUNDS = 56;
constexpr int NUM_RC = (FULL_ROUNDS + PARTIAL_ROUNDS) * T;
constexpr u64 MDS_FLAT[9] = {7, 23, 8, 26, 5, 4, 15, 20, 9};

Fe g_rc[NUM_RC];
bool g_rc_ready = false;

inline Fe fe_from_u64(u64 x) { return Fe{{x, 0, 0, 0}}; }

void init_rc() {
  if (g_rc_ready) return;
  // RC[i] = add(mul(i+1, 0x123456789ABCDEF), i*0x987654321).
  for (int i = 0; i < NUM_RC; ++i) {
    Fe m = fmul(fe_from_u64((u64)i + 1), fe_from_u64(0x123456789ABCDEFull));
    g_rc[i] = fadd(m, fe_from_u64((u64)i * 0x987654321ull));
  }
  g_rc_ready = true;
}

void permute(Fe st[T]) {
  init_rc();
  int r = 0;
  auto round = [&](bool full) {
    for (int i = 0; i < T; ++i) st[i] = fadd(st[i], g_rc[T * r + i]);
    ++r;
    if (full) {
      for (int i = 0; i < T; ++i) st[i] = fpow5(st[i]);
    } else {
      st[0] = fpow5(st[0]);
    }
    Fe ns[T];
    for (int i = 0; i < T; ++i) {
      Fe acc = {{0, 0, 0, 0}};
      for (int j = 0; j < T; ++j) {
        acc = fadd(acc, fmul(fe_from_u64(MDS_FLAT[T * i + j]), st[j]));
      }
      ns[i] = acc;
    }
    for (int i = 0; i < T; ++i) st[i] = ns[i];
  };
  for (int k = 0; k < FULL_ROUNDS / 2; ++k) round(true);
  for (int k = 0; k < PARTIAL_ROUNDS; ++k) round(false);
  for (int k = 0; k < FULL_ROUNDS / 2; ++k) round(true);
}

// Sponge: ds in state[0], absorb into state[1..2], squeeze state[1].
// Empty input => no permutation => returns 0 (reference quirk, B.4).
Fe sponge(const Fe *inputs, std::size_t n, u64 ds) {
  Fe st[T] = {fe_from_u64(ds), {{0, 0, 0, 0}}, {{0, 0, 0, 0}}};
  std::size_t i = 0;
  while (i < n) {
    for (int j = 0; j < 2 && i < n; ++j, ++i) {
      st[1 + j] = fadd(st[1 + j], inputs[i]);
    }
    permute(st);
  }
  return st[1];
}

}  // namespace

extern "C" {

// All buffers are little-endian u64 limb quadruples per element.

void cuzk_add(const u64 *a, const u64 *b, u64 *out) {
  Fe r = fadd(*(const Fe *)a, *(const Fe *)b);
  std::memcpy(out, r.v, 32);
}

void cuzk_sub(const u64 *a, const u64 *b, u64 *out) {
  Fe r = fsub(*(const Fe *)a, *(const Fe *)b);
  std::memcpy(out, r.v, 32);
}

void cuzk_mul(const u64 *a, const u64 *b, u64 *out) {
  Fe r = fmul(*(const Fe *)a, *(const Fe *)b);
  std::memcpy(out, r.v, 32);
}

void cuzk_red(const u64 *a, u64 *out) {
  Fe r = red(*(const Fe *)a);
  std::memcpy(out, r.v, 32);
}

void cuzk_power5(const u64 *a, u64 *out) {
  Fe r = fpow5(*(const Fe *)a);
  std::memcpy(out, r.v, 32);
}

void cuzk_permutation(u64 *state /* 3*4 limbs, in-place */) {
  Fe st[T];
  std::memcpy(st, state, 96);
  permute(st);
  std::memcpy(state, st, 96);
}

void cuzk_hash_single(const u64 *x, u64 *out) {
  Fe in = *(const Fe *)x;
  Fe r = sponge(&in, 1, 1);
  std::memcpy(out, r.v, 32);
}

void cuzk_hash_pair(const u64 *l, const u64 *r, u64 *out) {
  Fe in[2] = {*(const Fe *)l, *(const Fe *)r};
  Fe h = sponge(in, 2, 2);
  std::memcpy(out, h.v, 32);
}

void cuzk_hash_multiple(const u64 *inputs, std::size_t n, u64 *out) {
  Fe h = sponge((const Fe *)inputs, n, 3);
  std::memcpy(out, h.v, 32);
}

// Batched hashing (the host-native analog of the reference's batch kernels).
void cuzk_batch_hash_pairs(const u64 *l, const u64 *r, u64 *out,
                           std::size_t n) {
  for (std::size_t i = 0; i < n; ++i) {
    cuzk_hash_pair(l + 4 * i, r + 4 * i, out + 4 * i);
  }
}

void cuzk_batch_hash_single(const u64 *x, u64 *out, std::size_t n) {
  for (std::size_t i = 0; i < n; ++i) cuzk_hash_single(x + 4 * i, out + 4 * i);
}

// Merkle root: pad leaves to the next power of arity with
// empty_hash(arity) = hash_multiple(arity zeros), then level-by-level
// group hashing (merkle_tree.cpp:44-100 semantics).
void cuzk_merkle_root(const u64 *leaves, std::size_t n, std::size_t arity,
                      u64 *out) {
  if (n == 0 || arity < 2 || arity > 8) {
    std::vector<Fe> zeros(arity, Fe{{0, 0, 0, 0}});
    Fe e = sponge(zeros.data(), arity, 3);
    std::memcpy(out, e.v, 32);
    return;
  }
  std::vector<Fe> zeros(arity, Fe{{0, 0, 0, 0}});
  Fe empty = sponge(zeros.data(), arity, 3);

  std::size_t padded = 1;
  while (padded < n) padded *= arity;
  std::vector<Fe> level(padded);
  std::memcpy(level.data(), leaves, 32 * n);
  for (std::size_t i = n; i < padded; ++i) level[i] = empty;

  while (level.size() > 1) {
    std::vector<Fe> next(level.size() / arity);
    for (std::size_t g = 0; g < next.size(); ++g) {
      next[g] = sponge(level.data() + g * arity, arity, 3);
    }
    level.swap(next);
  }
  std::memcpy(out, level[0].v, 32);
}

}  // extern "C"
