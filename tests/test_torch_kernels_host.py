"""The CUDA field core and kernel bodies (``csrc/fr254.cuh``,
``csrc/poseidon.cuh``) built by the host C++ compiler and run on the CPU,
against the plain PyTorch versions.

There is no CUDA compiler here, but the headers' device code is plain C++
apart from the carry flag (which the headers model on the host) and the
warp shuffles.  The harness below emulates one lane group of the element
split (G = 3): four threads, one per lane, meet at a barrier for each
shuffle, so the split runs its real arithmetic and exchanges.  Small
sizes: an emulated permutation takes well under a second.  The card runs
the same code (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: none, every comparison is integer-exact.
"""

import ctypes
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cuzk_tpu_torch import constants, merkle, poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import _build

CPU = "cpu"  # the CPU tests ask for the plain path by name

HARNESS = r"""
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __constant__
static std::barrier<>* g_bar;
static uint32_t g_slots[2][8];
thread_local int emu_lane, emu_phase;
inline uint32_t __shfl_sync(uint32_t, uint32_t v, int src, int width) {
  int ph = emu_phase; emu_phase ^= 1;
  g_slots[ph][emu_lane] = v; g_bar->arrive_and_wait(); return g_slots[ph][src % width];
}
#include "poseidon.cuh"
using namespace fr254;

template <typename F> void run_split(F f) {
  std::barrier<> bar(SPLIT_WIDTH); g_bar = &bar;
  std::vector<std::thread> ts;
  for (int l = 0; l < SPLIT_WIDTH; l++) ts.emplace_back([&, l] { emu_lane = l; emu_phase = 0; f(l); });
  for (auto& t : ts) t.join();
}
template <typename E> void sponge_rows(const E* in, uint32_t* out, int64_t batch, int n, uint32_t ds, int G) {
  const int64_t w = INPUT_WORDS<E>;
  if (G == 1) { for (int64_t b = 0; b < batch; b++) store(out + b * NL, sponge_row(in + b * n * w, n, ds)); return; }
  run_split([&](int l) { for (int64_t b = 0; b < batch; b++) { SplitLane sl = make_split_lane(l);
    Fe r = sponge_row_split(in + b * n * w, n, ds, sl); if (l == 0) store(out + b * NL, r); } });
}
void verify_rows(const int32_t* pos, const int64_t* sib, const int64_t* leaf, const int64_t* root, uint8_t* ok, int64_t k, int h, int arity, int G) {
  const int64_t w = 2 * NL;
  if (G == 1) { for (int64_t t = 0; t < k; t++) ok[t] = verify_proof(pos + t * h, sib + t * h * (arity - 1) * w, leaf + t * w, root, h, arity); return; }
  run_split([&](int l) { for (int64_t t = 0; t < k; t++) { SplitLane sl = make_split_lane(l);
    bool same = verify_proof_split(pos + t * h, sib + t * h * (arity - 1) * w, leaf + t * w, root, h, arity, sl);
    if (l == 0) ok[t] = same; } });
}
extern "C" {
void h_set_rc(const uint32_t* rc) { memcpy(ROUND_CONSTANTS, rc, sizeof(ROUND_CONSTANTS)); }
void h_sponge(const uint32_t* in, uint32_t* out, int64_t batch, int n, uint32_t ds, int G) { sponge_rows(in, out, batch, n, ds, G); }
void h_sponge_digits(const int64_t* in, uint32_t* out, int64_t batch, int n, uint32_t ds, int G) { sponge_rows(in, out, batch, n, ds, G); }
void h_verify_digits(const int32_t* pos, const int64_t* sib, const int64_t* leaf, const int64_t* root, uint8_t* ok, int64_t k, int h, int arity, int G) { verify_rows(pos, sib, leaf, root, ok, k, h, arity, G); }
void h_perm(const uint32_t* in, uint32_t* out, int64_t batch) {
  for (int64_t b = 0; b < batch; b++) { Vec<T> s; for (int i = 0; i < T; i++) s.e[i] = load(in + (b * T + i) * NL);
    permute_full_ilp(s); for (int i = 0; i < T; i++) store(out + (b * T + i) * NL, s.e[i]); } }
void h_perm_digits(const int64_t* in, int64_t* out, int64_t batch) {
  for (int64_t b = 0; b < batch; b++) { Vec<T> s; for (int i = 0; i < T; i++) s.e[i] = load_digits(in + (b * T + i) * 16);
    permute_full_ilp(s); for (int i = 0; i < T; i++) store_digits(out + (b * T + i) * 16, s.e[i]); } }
void h_load_digits(const int64_t* d, uint32_t* out, int64_t n) { for (int64_t e = 0; e < n; e++) store(out + e * NL, load_digits(d + e * 16)); }
void h_store_digits(const uint32_t* l, int64_t* d, int64_t n) { for (int64_t e = 0; e < n; e++) store_digits(d + e * 16, load(l + e * NL)); }
void h_red_quotient(const uint32_t* in, uint32_t* out, int64_t n) { for (int64_t e = 0; e < n; e++) { Fe a = load(in + e * NL); red_quotient(a.v); store(out + e * NL, a); } }
void h_fr_op_digits(int op, const int64_t* a, const int64_t* b, uint32_t c, int64_t* out, int64_t n) {
  const int w = op == OP_REDUCE_WIDE ? 32 : 16;
  for (int64_t e = 0; e < n; e++) { const int64_t* x = a + e * w;
    store_digits(out + e * 16, fr_op_apply(op, load_digits(x), w == 32 ? load_digits(x + 16) : zero(), load_digits(b + e * 16), c)); } }
void h_fr_op(int op, const uint32_t* a, const uint32_t* b, uint32_t c, uint32_t* out, int64_t n) {
  for (int64_t e = 0; e < n; e++) { Vec<1> x, y, r; x.e[0] = load(a + e * NL);
    if (op == 0) { y.e[0] = load(b + e * NL); r = mul(x, y); }
    else if (op == 1) r = square(x);
    else if (op == 2) r = power5(x);
    else if (op == 3) { y.e[0] = load(b + e * NL); r = add_wrap_red(x, y); }
    else if (op == 4) { y.e[0] = load(b + e * NL); r = add_rr(x, y); }
    else if (op == 5) r = mul_small(x, c);
    else if (op == 6) { Wide w[1]; for (int i = 0; i < NL; i++) { w[0].lo[i] = a[e*16+i]; w[0].hi[i] = a[e*16+8+i]; } r = reduce_wide(w); }
    else if (op == 7) r = red(x);
    else if (op == 8) { const uint32_t cs[1] = {c}; r = mul_small_rr(x, cs); }
    else { y.e[0] = load(b + e * NL); r = sub(x, y); }
    store(out + e * NL, r.e[0]); } }
}
"""

OPS = {"mul": 0, "square": 1, "power5": 2, "add_wrap_red": 3, "add_rr": 4,
       "mul_small": 5, "reduce_wide": 6, "red": 7, "mul_small_rr": 8,
       "sub": 9}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build the kernel headers on the host")
    d = tmp_path_factory.mktemp("fr254_host")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    out = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", f"-I{_build.CSRC_DIR}", "-o", str(lib),
         str(src)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    h = ctypes.CDLL(str(lib))
    p, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
    h.h_set_rc.argtypes = [p]
    h.h_sponge.argtypes = [p, p, i64, i32, u32, i32]
    h.h_sponge_digits.argtypes = [p, p, i64, i32, u32, i32]
    h.h_verify_digits.argtypes = [p, p, p, p, p, i64, i32, i32, i32]
    h.h_perm.argtypes = [p, p, i64]
    h.h_fr_op.argtypes = [i32, p, p, u32, p, i64]
    h.h_perm_digits.argtypes = [p, p, i64]
    h.h_load_digits.argtypes = [p, p, i64]
    h.h_store_digits.argtypes = [p, p, i64]
    h.h_red_quotient.argtypes = [p, p, i64]
    h.h_fr_op_digits.argtypes = [i32, p, p, u32, p, i64]
    rc = np.ascontiguousarray(poseidon.RC_LIMBS, dtype=np.uint32)
    h.h_set_rc(rc.ctypes.data)
    return h


def limbs(d):
    return np.ascontiguousarray(
        fr.digits_to_limbs(d).numpy().view(np.uint32))


def digits_of(limb_array):
    return fr.limbs_to_digits(torch.from_numpy(limb_array.view(np.int32)))


def rnd(rng, shape):
    return torch.as_tensor(rng.integers(0, 1 << 16, tuple(shape) + (16,)))


@pytest.mark.parametrize("op", sorted(OPS))
def test_field_op_body(op, host_kernels):
    rng = np.random.default_rng(40 + OPS[op])
    edges = fr.ints_to_array([0, 1, constants.P - 1, constants.P,
                              (1 << 256) - 1])
    a = torch.cat([rnd(rng, (6,)), edges])
    b = torch.cat([rnd(rng, (6,)), edges.flip(0)])
    ra, rb = fr.red(a), fr.red(b)
    cases = {
        "mul": (a, b, 0, fr.mul(a, b)),
        "square": (a, b, 0, fr.square(a)),
        "power5": (a, b, 0, fr.power5(a)),
        "add_wrap_red": (a, b, 0, fr.add(a, b)),
        "add_rr": (ra, rb, 0, fr.add_rr(ra, rb)),
        "mul_small": (a, b, 65535, fr.mul_small(a, 65535)),
        "red": (a, b, 0, fr.red(a)),
        # the reduced operand at its edge: (p - 1) 26 >> 256 = 4
        "mul_small_rr": (ra, rb, 26, fr.mul_small(ra, 26)),
        # operands >= p, a < b (the pre-add of p) and a == b, by value
        "sub": (a, b, 0, fr.sub(a, b)),
    }
    if op == "reduce_wide":
        wide = fr.mul_wide(a, b)
        x = wide.reshape(-1, 2, fr.NDIGITS)
        cases[op] = (x, b, 0, fr.reduce_wide(wide))
    x, y, c, want = cases[op]
    n = a.shape[0]
    out = np.zeros((n, 8), np.uint32)
    xl, yl = limbs(x), limbs(y)
    host_kernels.h_fr_op(OPS[op], xl.ctypes.data, yl.ctypes.data, c,
                         out.ctypes.data, n)
    assert torch.equal(digits_of(out), want)


@pytest.mark.parametrize("lanes", [1, 3])
def test_sponge_body_under_each_lane_count(lanes, host_kernels):
    rng = np.random.default_rng(50 + lanes)
    for width in (1, 2, 3, 5):
        g = rnd(rng, (2, width))
        g[1, width - 1, 0] += 1 << 16  # non-canonical digit: by value
        x = limbs(g)
        out = np.zeros((2, 8), np.uint32)
        host_kernels.h_sponge(x.ctypes.data, out.ctypes.data, 2, width, 3,
                              lanes)
        assert torch.equal(digits_of(out), poseidon.hash_multiple(g)), width


@pytest.mark.parametrize("lanes", [1, 3])
def test_verify_body_under_each_lane_count(lanes, host_kernels):
    rng = np.random.default_rng(60)
    levels = merkle.build_tree_levels(rnd(rng, (5,)), 4, device=CPU)
    pos, sib = merkle.generate_proofs(levels, 4, [0, 3, 4])
    leaves = levels[0][[0, 3, 4]].clone()
    pos = pos.to(torch.int64)
    pos[1, 0] = 5  # out of range: the digest is dropped
    leaves[2, 0] ^= 1
    root = levels[-1][0]
    want = merkle._verify_plain(pos, sib, leaves, root, 4)
    got = run_k3_digits(host_kernels, pos, sib, leaves, root, 4, lanes)
    assert got == want.tolist() == [True, False, False]


def test_raw_permutation_body(host_kernels):
    rng = np.random.default_rng(70)
    st = rnd(rng, (2, 3))
    st[1, 0, 0] = 0xFFFFFFFF  # read by value, above 2^16
    x = limbs(st)
    out = np.zeros_like(x)
    host_kernels.h_perm(x.ctypes.data, out.ctypes.data, 2)
    assert torch.equal(digits_of(out), poseidon.permutation(st))


def test_sub_body_on_every_edge_pair(host_kernels):
    """The device subtract on every pair of 0, 1, p - 1, p, p + 1, 2^256 - 1
    and a random value: a < b (p pre-added, its 2^256 carry dropped),
    a == b, and operands >= p (no reduce), against plain ``fr.sub`` and
    the oracle."""
    from cuzk_tpu_torch import oracle

    vals = [0, 1, constants.P - 1, constants.P, constants.P + 1,
            (1 << 256) - 1, 0x1234 << 200]
    pairs = [(x, y) for x in vals for y in vals]
    a = fr.ints_to_array([x for x, _ in pairs])
    b = fr.ints_to_array([y for _, y in pairs])
    out = np.zeros((len(pairs), 8), np.uint32)
    al, bl = limbs(a), limbs(b)
    host_kernels.h_fr_op(OPS["sub"], al.ctypes.data, bl.ctypes.data, 0,
                         out.ctypes.data, len(pairs))
    got = digits_of(out)
    assert torch.equal(got, fr.sub(a, b))
    assert fr.array_to_ints(got) == [oracle.sub(x, y) for x, y in pairs]


# ---------------------------------------------------------------------------
# K4's own body (permute_full_ilp) and the digit I/O of K4 and fr_op
# ---------------------------------------------------------------------------

def edge_states():
    """Every combination of 0, 1, p - 1, p and 2^256 - 1 in the three lanes
    (125 states; canonical digits)."""
    vals = [0, 1, constants.P - 1, constants.P, (1 << 256) - 1]
    combos = list(itertools.product(vals, repeat=3))
    return fr.ints_to_array([v for c in combos for v in c]).reshape(-1, 3, 16)


def run_k4(host_kernels, st, form):
    """K4's body on ``[B, 3, 16]`` digits, through its limb form (the digits
    converted by ``fr.digits_to_limbs``) or its digit form (the body reads
    and writes the digits itself)."""
    n = st.shape[0]
    if form == "limbs":
        x = limbs(st)
        out = np.zeros_like(x)
        host_kernels.h_perm(x.ctypes.data, out.ctypes.data, n)
        return digits_of(out)
    x = np.ascontiguousarray(st.numpy().astype(np.int64))
    out = np.zeros_like(x)
    host_kernels.h_perm_digits(x.ctypes.data, out.ctypes.data, n)
    assert out.min() >= 0 and out.max() < 1 << 16
    return torch.from_numpy(out)


@pytest.mark.parametrize("form", ["limbs", "digits"])
def test_k4_body_against_plain_jax_and_oracle(form, host_kernels):
    """K4's body on the edge rows, a digit d + 2^16 and a digit
    0xFFFFFFFF (read by value), against the plain permutation and the
    oracle; against the JAX package on every row whose digits are below
    2^32 - 2^16 (ROADMAP trap (h))."""
    from cuzk_tpu import oracle
    from cuzk_tpu import poseidon as jpos

    rng = np.random.default_rng(71)
    odd = rnd(rng, (3, 3))
    odd[0, 1, 5] += 1 << 16
    odd[1, 0, 0] = 0xFFFFFFFF
    st = torch.cat([edge_states(), rnd(rng, (4, 3)), odd])
    got = run_k4(host_kernels, st, form)
    assert torch.equal(got, poseidon.permutation(st))
    for row, out in zip(st.tolist(), got.tolist()):
        want = oracle.permutation([fr.digits_to_int(d) % (1 << 256) for d in row])
        assert [fr.digits_to_int(d) for d in out] == want
    below = (st < (1 << 32) - (1 << 16)).flatten(1).all(dim=1)
    assert int(below.sum()) == st.shape[0] - 1
    jax_out = np.array(jpos.permutation(st[below].numpy().astype(np.uint32)))
    assert torch.equal(got[below], torch.from_numpy(jax_out.astype(np.int64)))


def run_k1(host_kernels, g, lanes):
    """K1's body under ``lanes`` on ``[B, n, 16]`` digit rows, ds = 3."""
    b, n = g.shape[:2]
    x = limbs(g)
    out = np.zeros((b, 8), np.uint32)
    host_kernels.h_sponge(x.ctypes.data, out.ctypes.data, b, n, 3, lanes)
    return digits_of(out)


def run_k1_digits(host_kernels, g, lanes):
    """K1's body under ``lanes`` on its digit form: ``[B, n, 16]`` int64
    rows read by value, ds = 3."""
    b, n = g.shape[:2]
    x = np.ascontiguousarray(g.numpy().astype(np.int64))
    out = np.zeros((b, 8), np.uint32)
    host_kernels.h_sponge_digits(x.ctypes.data, out.ctypes.data, b, n, 3,
                                 lanes)
    return digits_of(out)


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("arity", [2, 8])
def test_digit_input_sponge_body_equals_the_limb_body(arity, lanes,
                                                      host_kernels):
    """K1's digit form (each input read by value, as fr.digits_to_limbs
    reads it) against its limb form and the plain sponge, on arity-2 and
    arity-8 rows: random and edge elements, digits d + 2^16 and 2^32 + d
    (neither may alias to d), and the top digit at 0xFFFF and at 2^40 - 1,
    the end of the range fr.carry is exact in (the value wraps at
    2^256)."""
    rng = np.random.default_rng(75 + arity)
    edges = [0, 1, constants.P - 1, constants.P, (1 << 256) - 1]
    g = torch.cat([
        fr.ints_to_array([edges[(r + i) % 5] for r in range(2)
                          for i in range(arity)]).reshape(2, arity, 16),
        rnd(rng, (4, arity))])
    g[2, arity - 1, 3] += 1 << 16
    g[3, 0, 0] += 1 << 32
    g[4, 0, 15] = 0xFFFF
    g[5, arity - 1, 15] = (1 << 40) - 1
    got = run_k1_digits(host_kernels, g, lanes)
    assert torch.equal(got, run_k1(host_kernels, g, lanes))
    assert torch.equal(got, poseidon.hash_multiple(g))


@pytest.mark.parametrize("body,size", [("k1", w) for w in range(1, 9)]
                         + [("k3", a) for a in (2, 4, 8)])
def test_one_thread_body_equals_the_split_and_the_oracle(body, size,
                                                         host_kernels):
    """K1 and K3 at G = 1 (the permutation body K4 runs) against G = 3 (the
    element split).  K1 at widths 1-8 (the arity-8 sponge's four
    permutations) on rows holding 0, 1, p - 1, p and 2^256 - 1 and a digit
    d + 2^16, also against the plain sponge and the oracle; K3 at arity 2,
    4 and 8 on valid and tampered proofs, also against the plain verify."""
    from cuzk_tpu import oracle

    rng = np.random.default_rng(72 + size)
    if body == "k1":
        edges = [0, 1, constants.P - 1, constants.P, (1 << 256) - 1]
        g = torch.cat([
            fr.ints_to_array([edges[(r + i) % 5] for r in range(2)
                              for i in range(size)]).reshape(2, size, 16),
            rnd(rng, (2, size))])
        g[2, size - 1, 3] += 1 << 16  # non-canonical digit: by value
        one = run_k1(host_kernels, g, 1)
        assert torch.equal(one, run_k1(host_kernels, g, 3))
        assert torch.equal(one, poseidon.hash_multiple(g))
        assert fr.array_to_ints(one) == [
            oracle.hash_multiple([fr.digits_to_int(d) % (1 << 256) for d in row])
            for row in g.tolist()]
        return
    arity = size
    levels = merkle.build_tree_levels(rnd(rng, (arity + 3,)), arity, device=CPU)
    idx = [0, 1, arity + 2]
    pos, sib = merkle.generate_proofs(levels, arity, idx)
    leaves = levels[0][idx].clone()
    leaves[1, 0] ^= 1
    sib[2, 0, arity - 2, 5] += 1 << 16
    root = levels[-1][0]
    want = merkle._verify_plain(pos, sib, leaves, root, arity).tolist()
    assert want == [True, False, False]
    assert run_k3_digits(host_kernels, pos, sib, leaves, root, arity, 1) == want
    assert run_k3_digits(host_kernels, pos, sib, leaves, root, arity, 3) == want


def run_k3_digits(host_kernels, pos, sib, leaves, root, arity, lanes):
    """K3's body under ``lanes``, one verdict a proof: int32 positions as
    they are (the body clamps them), int64 digits read by value, the root
    compared digit by digit."""
    k, h = pos.shape
    p = np.ascontiguousarray(pos.to(torch.int32).numpy())
    s, lv, r = (np.ascontiguousarray(t.numpy().astype(np.int64))
                for t in (sib, leaves, root))
    ok = np.zeros(k, np.uint8)
    host_kernels.h_verify_digits(p.ctypes.data, s.ctypes.data, lv.ctypes.data,
                                 r.ctypes.data, ok.ctypes.data, k, h, arity,
                                 lanes)
    return ok.astype(bool).tolist()


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("arity", [2, 4, 8])
def test_digit_input_verify_body_equals_the_plain_verify(arity, lanes,
                                                         host_kernels):
    """K3's body (leaf and siblings read by value, the root compared digit
    by digit, positions clamped in the body) against the plain verify, on
    two-level proofs: honest, a tampered leaf, a sibling digit d + 2^16 and
    one 2^32 + d (neither may alias to d), a leaf's top digit at 2^40 - 1,
    positions 5, -7 and 2^31 - 1 left unclamped, and a sibling with
    non-canonical digits of the same value (verifies: by value).  Then a
    root with a digit >= 2^16 whose value is the digest's: like the plain
    path, the body never verifies it."""
    rng = np.random.default_rng(90 + arity)
    levels = merkle.build_tree_levels(rnd(rng, (arity + 1,)), arity,
                                      device=CPU)
    idx = [0, 1, 2, arity - 1, arity, 0, 1, arity]
    pos, sib = merkle.generate_proofs(levels, arity, idx)
    leaves = levels[0][idx].clone()
    root = levels[-1][0]
    pos = pos.to(torch.int64)
    leaves[1, 0] ^= 1
    sib[2, 0, 0, 4] += 1 << 16
    sib[3, 1, 0, 2] += 1 << 32
    leaves[4, 15] = (1 << 40) - 1
    pos[5, 1], pos[6, 0], pos[4, 1] = 5, -7, (1 << 31) - 1
    sib[7, 1, 0, 6] += 1 << 16
    sib[7, 1, 0, 7] -= 1
    assert int(sib[7, 1, 0, 7]) >= 0
    want = merkle._verify_plain(pos, sib, leaves, root, arity).tolist()
    assert want[0] and want[7] and not any(want[1:5])
    got = run_k3_digits(host_kernels, pos, sib, leaves, root, arity, lanes)
    assert got == want
    alias = root.clone()
    alias[0] += 1 << 16
    alias[1] -= 1
    assert int(alias[1]) >= 0 and fr.digits_to_int(alias) == fr.digits_to_int(root)
    one = (pos[:1], sib[:1], leaves[:1])
    assert run_k3_digits(host_kernels, *one, root, arity, lanes) == [True]
    assert merkle._verify_plain(*one, alias, arity).tolist() == [False]
    assert run_k3_digits(host_kernels, *one, alias, arity, lanes) == [False]


def test_digit_read_and_write_against_fr(host_kernels):
    """load_digits against fr.digits_to_limbs on digits up to 2^40 - 1 (the
    range fr.carry is exact in) and against the value mod 2^256 on any int64
    digits, negative ones included; store_digits against
    fr.limbs_to_digits."""
    rng = np.random.default_rng(73)
    d = rng.integers(0, 1 << 40, (64, 16), dtype=np.int64)
    d[0] = (1 << 40) - 1
    d[1] = rng.integers(0, 1 << 16, 16) + (1 << 16)  # d + 2^16
    d[2, 0] = (1 << 32) + 5  # 2^32 + d must not become d
    got = np.zeros((64, 8), np.uint32)
    host_kernels.h_load_digits(d.ctypes.data, got.ctypes.data, 64)
    assert np.array_equal(got, limbs(torch.as_tensor(d)))
    wild = rng.integers(-(1 << 63), (1 << 63) - 1, (64, 16), dtype=np.int64)
    got = np.zeros((64, 8), np.uint32)
    host_kernels.h_load_digits(wild.ctypes.data, got.ctypes.data, 64)
    assert [sum(int(v) << (32 * i) for i, v in enumerate(r)) for r in got] == [
        sum(int(v) << (16 * i) for i, v in enumerate(r)) % (1 << 256)
        for r in wild]
    back = np.zeros((64, 16), np.int64)
    host_kernels.h_store_digits(got.ctypes.data, back.ctypes.data, 64)
    assert torch.equal(torch.from_numpy(back),
                       fr.limbs_to_digits(torch.from_numpy(got.view(np.int32))))


def test_quotient_reduce_at_its_boundaries(host_kernels):
    """red_quotient (K4's reduce of any a < 2^256) against a mod p: a near
    every multiple of p up to 5p, a top limb at and around every multiple
    of p_7 + 1, 2^256 - 1 and random values."""
    rng = np.random.default_rng(74)
    p = constants.P
    d = (p >> 224) + 1
    vals = [m * p + e for m in range(6) for e in range(-3, 4) if 0 <= m * p + e]
    for m in range(7):
        for e in (-1, 0, 1):
            top = m * d + e
            if 0 <= top < 1 << 32:
                vals += [top << 224, (top << 224) | ((1 << 224) - 1)]
                vals += [(top << 224) | int(v) for v in
                         rng.integers(0, 1 << 62, 4) << 150]
    vals += [(1 << 256) - 1] + [int.from_bytes(rng.bytes(32), "little")
                                for _ in range(512)]
    vals = [v for v in vals if v < 1 << 256]
    a = limbs(fr.ints_to_array(vals))
    out = np.zeros_like(a)
    host_kernels.h_red_quotient(a.ctypes.data, out.ctypes.data, len(vals))
    assert fr.array_to_ints(digits_of(out)) == [v % p for v in vals]


@pytest.mark.parametrize("op", sorted(OPS))
def test_field_op_digit_form(op, host_kernels):
    """The check kernel's digit form (each element read by value, written
    below 2^16) against the plain fr op, on random, edge and
    non-canonical rows (d + 2^16, 2^40 - 1); the plain op reads those
    through fr.carry, the canonical digits of the same value."""
    rng = np.random.default_rng(80 + OPS[op])
    edges = fr.ints_to_array([0, 1, constants.P - 1, constants.P,
                              (1 << 256) - 1])
    a = torch.cat([rnd(rng, (6,)), edges])
    b = torch.cat([rnd(rng, (6,)), edges.flip(0)])
    a[0, 3] += 1 << 16
    a[1, 15] = (1 << 40) - 1
    b[2, 0] += 1 << 16
    if op in ("add_rr", "mul_small_rr"):  # reduced operands
        a, b = fr.red(fr.carry(a)), fr.red(fr.carry(b))
    c = {"mul_small": 65535, "mul_small_rr": 26}.get(op, 0)
    x = torch.cat([a, b], dim=1) if op == "reduce_wide" else a
    ca, cb = fr.carry(a), fr.carry(b)
    plain = {
        "mul": lambda: fr.mul(ca, cb), "square": lambda: fr.square(ca),
        "power5": lambda: fr.power5(ca), "add_wrap_red": lambda: fr.add(ca, cb),
        "add_rr": lambda: fr.add_rr(ca, cb), "red": lambda: fr.red(ca),
        "mul_small": lambda: fr.mul_small(ca, c),
        "mul_small_rr": lambda: fr.mul_small(ca, c),
        "reduce_wide": lambda: fr.reduce_wide(torch.cat([ca, cb], dim=1)),
        "sub": lambda: fr.sub(a, b),
    }[op]()
    xs = np.ascontiguousarray(x.numpy().astype(np.int64))
    ys = np.ascontiguousarray(b.numpy().astype(np.int64))
    out = np.zeros((a.shape[0], 16), np.int64)
    host_kernels.h_fr_op_digits(OPS[op], xs.ctypes.data, ys.ctypes.data, c,
                                out.ctypes.data, a.shape[0])
    assert out.min() >= 0 and out.max() < 1 << 16
    assert torch.equal(torch.from_numpy(out), plain)
