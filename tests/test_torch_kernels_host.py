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
extern "C" {
void h_set_rc(const uint32_t* rc) { memcpy(ROUND_CONSTANTS, rc, sizeof(ROUND_CONSTANTS)); }
void h_sponge(const uint32_t* in, uint32_t* out, int64_t batch, int n, uint32_t ds, int G) {
  if (G == 1) { for (int64_t b = 0; b < batch; b++) store(out + b * NL, sponge_row(in + b * n * NL, n, ds)); return; }
  run_split([&](int l) { for (int64_t b = 0; b < batch; b++) { SplitLane sl = make_split_lane(l);
    Fe r = sponge_row_split(in + b * n * NL, n, ds, sl); if (l == 0) store(out + b * NL, r); } });
}
void h_verify(const int32_t* pos, const uint32_t* sib, const uint32_t* leaf, const uint32_t* root, uint8_t* ok, int64_t k, int h, int arity, int G) {
  if (G == 1) { for (int64_t t = 0; t < k; t++) ok[t] = verify_proof(pos + t * h, sib + t * h * (int64_t)(arity - 1) * NL, leaf + t * NL, root, h, arity); return; }
  run_split([&](int l) { for (int64_t t = 0; t < k; t++) { SplitLane sl = make_split_lane(l);
    bool same = verify_proof_split(pos + t * h, sib + t * h * (int64_t)(arity - 1) * NL, leaf + t * NL, root, h, arity, sl);
    if (l == 0) ok[t] = same; } });
}
void h_perm(const uint32_t* in, uint32_t* out, int64_t batch) {
  for (int64_t b = 0; b < batch; b++) { Vec<T> s; for (int i = 0; i < T; i++) s.e[i] = load(in + (b * T + i) * NL);
    permute_full(s); for (int i = 0; i < T; i++) store(out + (b * T + i) * NL, s.e[i]); } }
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
    else { const uint32_t cs[1] = {c}; r = mul_small_rr(x, cs); }
    store(out + e * NL, r.e[0]); } }
}
"""

OPS = {"mul": 0, "square": 1, "power5": 2, "add_wrap_red": 3, "add_rr": 4,
       "mul_small": 5, "reduce_wide": 6, "red": 7, "mul_small_rr": 8}


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
    h.h_verify.argtypes = [p, p, p, p, p, i64, i32, i32, i32]
    h.h_perm.argtypes = [p, p, i64]
    h.h_fr_op.argtypes = [i32, p, p, u32, p, i64]
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
    k, h = pos.shape
    p = np.ascontiguousarray(pos.clamp(-1, 4).to(torch.int32).numpy())
    s, lv, r = limbs(sib), limbs(leaves), limbs(root)
    ok = np.zeros(k, np.uint8)
    host_kernels.h_verify(p.ctypes.data, s.ctypes.data, lv.ctypes.data,
                          r.ctypes.data, ok.ctypes.data, k, h, 4, lanes)
    assert ok.astype(bool).tolist() == want.tolist() == [True, False, False]


def test_raw_permutation_body(host_kernels):
    rng = np.random.default_rng(70)
    st = rnd(rng, (2, 3))
    st[1, 0, 0] = 0xFFFFFFFF  # read by value, above 2^16
    x = limbs(st)
    out = np.zeros_like(x)
    host_kernels.h_perm(x.ctypes.data, out.ctypes.data, 2)
    assert torch.equal(digits_of(out), poseidon.permutation(st))
