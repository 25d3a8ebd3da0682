// Poseidon kernels for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes): the wrappers in cuzk_tpu_torch/ops/poseidon_cuda.py
// check device, dtype, shape and contiguity, allocate the outputs, pass
// PyTorch's current stream, and raise when a launch returns an error.
//
// Tensors of field elements are 8 x u32 little-endian limbs per element,
// held in torch.int32 tensors and reinterpreted as uint32_t here.
//
// sponge_kernel replaces cuzk_tpu/ops/poseidon_pallas.py::_sponge_kernel_dyn
// (pallas_call at :488).  verify_kernel replaces ::_make_verify_kernel
// (pallas_call at :385).  permutation_kernel replaces ::_permutation_kernel
// (pallas_call at :795).  The TPU kernels stream [16, 8, 128] digit tiles
// through VMEM and run a grid in order on one core; here each thread owns
// one hash, one proof or one state with the whole state in registers, and
// blocks run in any order.  All three are bound by the rate of integer
// multiply-adds: a hash reads 32 bytes per input and writes 32 bytes, a raw
// permutation reads 96 bytes and writes 96 bytes, against tens of thousands
// of integer instructions per permutation.
#include <cuda_runtime.h>

#include <cstdint>

#include "fr254.cuh"

using namespace fr254;

namespace {

constexpr int SPONGE_THREADS = 128;
constexpr int VERIFY_THREADS = 64;
constexpr int PERMUTATION_THREADS = 128;
constexpr uint32_t DS_MULTIPLE = 3;

__device__ __forceinline__ void load(Fe r, const uint32_t* p) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = p[i];
}

__device__ __forceinline__ void store(uint32_t* p, const Fe a) {
#pragma unroll
  for (int i = 0; i < NL; i++) p[i] = a[i];
}

// K1: the width-dynamic sponge (poseidon.cpp:103-126).  in [B, n, 8],
// out [B, 8].  State [ds, 0, 0]; per block of two inputs, absorb with the
// full wrapping add (inputs may be >= p), then permute; squeeze state[1].
// An odd last block absorbs one input: the TPU kernel's padded zero is a
// no-op on the reduced state.
__global__ void __launch_bounds__(SPONGE_THREADS)
    sponge_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int64_t batch, int n, uint32_t ds) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint32_t* x = in + b * n * NL;
  uint32_t s[T][NL] = {};
  s[0][0] = ds;
  for (int i = 0; i < n; i += 2) {
    uint32_t v[NL];
    load(v, x + (int64_t)i * NL);
    add_wrap_red(s[1], s[1], v);
    if (i + 1 < n) {
      load(v, x + (int64_t)(i + 1) * NL);
      add_wrap_red(s[2], s[2], v);
    }
    permute(s);
  }
  store(out + b * NL, s[1]);
}

// K3: fused per-proof verify.  pos [k, h], sib [k, h, a-1, 8], leaf [k, 8],
// root [8] -> ok [k].  Per level, slot j of the arity group holds the
// current digest when j == pos, else sibling j - (j > pos) clamped to
// [0, a-2] (cuzk_tpu_torch/merkle.py::_insert_at_position, so an
// out-of-range pos drops the digest exactly as the JAX path does); then a
// ds=3 sponge over the group.  The running digest never leaves registers.
__global__ void __launch_bounds__(VERIFY_THREADS)
    verify_kernel(const int32_t* __restrict__ pos,
                  const uint32_t* __restrict__ sib,
                  const uint32_t* __restrict__ leaf,
                  const uint32_t* __restrict__ root,
                  uint8_t* __restrict__ ok, int64_t k, int h, int arity) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= k) return;
  uint32_t cur[NL];
  load(cur, leaf + t * NL);
  for (int lvl = 0; lvl < h; lvl++) {
    const int p = pos[t * h + lvl];
    const uint32_t* sb = sib + (t * h + lvl) * (int64_t)(arity - 1) * NL;
    uint32_t s[T][NL] = {};
    s[0][0] = DS_MULTIPLE;
    for (int j = 0; j < arity; j++) {
      uint32_t v[NL];
      if (j == p) {
        copy(v, cur);
      } else {
        int q = j - (j > p ? 1 : 0);
        q = q < 0 ? 0 : (q > arity - 2 ? arity - 2 : q);
        load(v, sb + q * NL);
      }
      // Constant state indices keep the state in registers.
      if (j & 1) {
        add_wrap_red(s[2], s[2], v);
      } else {
        add_wrap_red(s[1], s[1], v);
      }
      if ((j & 1) || j + 1 == arity) permute(s);
    }
    copy(cur, s[1]);
  }
  bool same = true;
#pragma unroll
  for (int i = 0; i < NL; i++) same &= cur[i] == root[i];
  ok[t] = same ? 1 : 0;
}

// K4: the raw batched permutation.  in, out [B, 3, 8]: states of any
// 256-bit values, so round 0 adds with the full wrap (permute_full).
__global__ void __launch_bounds__(PERMUTATION_THREADS)
    permutation_kernel(const uint32_t* __restrict__ in,
                       uint32_t* __restrict__ out, int64_t batch) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint32_t s[T][NL];
#pragma unroll
  for (int i = 0; i < T; i++) load(s[i], in + (b * T + i) * NL);
  permute_full(s);
#pragma unroll
  for (int i = 0; i < T; i++) store(out + (b * T + i) * NL, s[i]);
}

// Per-op check kernel: exposes the field library on limb tensors so that
// each operation can be held against its plain PyTorch version.
enum FrOp {
  OP_MUL = 0,
  OP_SQUARE = 1,
  OP_POWER5 = 2,
  OP_ADD_WRAP_RED = 3,
  OP_ADD_RR = 4,
  OP_MUL_SMALL = 5,
  OP_REDUCE_WIDE = 6,
  OP_RED = 7,
};

__global__ void fr_op_kernel(int op, const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b, uint32_t c,
                             uint32_t* __restrict__ out, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t r[NL], x[NL], y[NL];
  if (op == OP_REDUCE_WIDE) {
    uint32_t w[2 * NL];
#pragma unroll
    for (int i = 0; i < 2 * NL; i++) w[i] = a[e * 2 * NL + i];
    reduce_wide(r, w);
    store(out + e * NL, r);
    return;
  }
  load(x, a + e * NL);
  switch (op) {
    case OP_MUL:
      load(y, b + e * NL);
      mul(r, x, y);
      break;
    case OP_SQUARE:
      square(r, x);
      break;
    case OP_POWER5:
      power5(r, x);
      break;
    case OP_ADD_WRAP_RED:
      load(y, b + e * NL);
      add_wrap_red(r, x, y);
      break;
    case OP_ADD_RR:
      load(y, b + e * NL);
      add_rr(r, x, y);
      break;
    case OP_MUL_SMALL:
      mul_small(r, x, c);
      break;
    default:  // OP_RED
      copy(r, x);
      red(r);
      break;
  }
  store(out + e * NL, r);
}

unsigned int blocks_for(int64_t n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int cuzk_set_round_constants(const uint32_t* host_rc) {
  return (int)cudaMemcpyToSymbol(ROUND_CONSTANTS, host_rc,
                                 sizeof(uint32_t) * ROUNDS * T * NL);
}

const char* cuzk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int cuzk_sponge(const uint32_t* in, uint32_t* out, int64_t batch, int n,
                uint32_t ds, void* stream) {
  sponge_kernel<<<blocks_for(batch, SPONGE_THREADS), SPONGE_THREADS, 0,
                  (cudaStream_t)stream>>>(in, out, batch, n, ds);
  return (int)cudaGetLastError();
}

int cuzk_permutation(const uint32_t* in, uint32_t* out, int64_t batch,
                     void* stream) {
  permutation_kernel<<<blocks_for(batch, PERMUTATION_THREADS),
                       PERMUTATION_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, batch);
  return (int)cudaGetLastError();
}

// Threads of sponge_kernel resident on one SM of the current device, from
// the occupancy API: the engine's batch-size hint is this times the SMs.
int cuzk_sponge_resident_threads(int* threads) {
  int blocks = 0;
  const cudaError_t code = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, sponge_kernel, SPONGE_THREADS, 0);
  *threads = blocks * SPONGE_THREADS;
  return (int)code;
}

int cuzk_verify(const int32_t* pos, const uint32_t* sib, const uint32_t* leaf,
                const uint32_t* root, uint8_t* ok, int64_t k, int h,
                int arity, void* stream) {
  verify_kernel<<<blocks_for(k, VERIFY_THREADS), VERIFY_THREADS, 0,
                  (cudaStream_t)stream>>>(pos, sib, leaf, root, ok, k, h,
                                          arity);
  return (int)cudaGetLastError();
}

int cuzk_fr_op(int op, const uint32_t* a, const uint32_t* b, uint32_t c,
               uint32_t* out, int64_t n, void* stream) {
  fr_op_kernel<<<blocks_for(n, SPONGE_THREADS), SPONGE_THREADS, 0,
                 (cudaStream_t)stream>>>(op, a, b, c, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
