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
// through VMEM and run a grid in order on one core; here blocks run in any
// order and a thread, or a group of lanes (poseidon.cuh), owns one hash, one
// proof or one state with the state in registers.
//
// What bounds them: integer multiplies, about 88K 32-bit multiply results
// a permutation (44,096 limb products), against 32 bytes read per absorbed
// input.  A launch too small to fill the card's resident threads is bound
// instead by one state's latency through 64 dependent rounds, and most of
// the main path's launches are that small (a Merkle level of 64-4,096
// groups, 5,000 proofs).  So the sponge and the verify kernel take G lanes
// of a warp per state:
//   - G = 1, one thread per state, for launches from an eighth of a wave up,
//     where only the issue rate counts;
//   - G = 3, three lanes of a four-lane group each holding one state element
//     (poseidon.cuh): a full round's three S-boxes and the MDS's three rows
//     run in parallel, with no carry between lanes; 1.4-1.6x shorter per
//     state than G = 1 on an H100.
// The wrapper picks G from the batch and the resident threads
// (ops/poseidon_cuda.py::choose_lanes).  The raw permutation keeps G = 1.
#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon.cuh"

using namespace fr254;

namespace {

constexpr int SPONGE_THREADS = 128;
constexpr int VERIFY_THREADS = 64;
constexpr int PERMUTATION_THREADS = 128;
constexpr int FR_OP_THREADS = 128;
// Launch bounds' minimum blocks per SM: unset (0) for one thread per
// state, where ptxas keeps to 96-128 registers for the card's occupancy at
// large batches; 1 for the element split, the latency regime below a
// wave, where ptxas may take what registers it needs.
constexpr int min_blocks(int lanes) { return lanes > 1 ? 1 : 0; }

// Threads a state takes: one, or a four-lane group for the element split.
__host__ __device__ constexpr int group_width(int lanes) {
  return lanes == SPLIT_LANES ? SPLIT_WIDTH : 1;
}

__device__ __forceinline__ uint32_t warp_lane() { return threadIdx.x & 31u; }

// The item of this thread's group of W lanes, or -1 when its whole warp
// lies past the last item.  The lanes of a partial last warp past the end
// work on the last item (their results are not stored), so that each warp
// stays converged through its shuffles.
template <int W>
__device__ __forceinline__ int64_t group_item(int64_t count) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((t - warp_lane()) / W >= count) return -1;
  const int64_t item = t / W;
  return item < count ? item : count - 1;
}

template <int W>
__device__ __forceinline__ bool owns_item(int64_t count) {
  return ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / W < count;
}

// K1: the width-dynamic sponge.  in [B, n, 8], out [B, 8]; thread or
// group b hashes row b.
template <int G>
__global__ void __launch_bounds__(SPONGE_THREADS, min_blocks(G))
    sponge_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int64_t batch, int n, uint32_t ds) {
  constexpr int W = group_width(G);
  const int64_t b = group_item<W>(batch);
  if (b < 0) return;
  Fe r;
  if constexpr (G == SPLIT_LANES) {
    r = sponge_row_split(in + b * n * NL, n, ds, make_split_lane(warp_lane()));
  } else {
    r = sponge_row(in + b * n * NL, n, ds);
  }
  if (warp_lane() % W == 0 && owns_item<W>(batch)) store(out + b * NL, r);
}

// K3: fused per-proof verify.  pos [k, h], sib [k, h, a-1, 8], leaf [k, 8],
// root [8] -> ok [k]; thread or group t verifies proof t.
template <int G>
__global__ void __launch_bounds__(VERIFY_THREADS, min_blocks(G))
    verify_kernel(const int32_t* __restrict__ pos,
                  const uint32_t* __restrict__ sib,
                  const uint32_t* __restrict__ leaf,
                  const uint32_t* __restrict__ root,
                  uint8_t* __restrict__ ok, int64_t k, int h, int arity) {
  constexpr int W = group_width(G);
  const int64_t t = group_item<W>(k);
  if (t < 0) return;
  const int32_t* p = pos + t * h;
  const uint32_t* s = sib + t * h * (int64_t)(arity - 1) * NL;
  bool same;
  if constexpr (G == SPLIT_LANES) {
    same = verify_proof_split(p, s, leaf + t * NL, root, h, arity,
                              make_split_lane(warp_lane()));
  } else {
    same = verify_proof(p, s, leaf + t * NL, root, h, arity);
  }
  if (warp_lane() % W == 0 && owns_item<W>(k)) ok[t] = same ? 1 : 0;
}

// K4: the raw batched permutation.  in, out [B, 3, 8]: states of any
// 256-bit values, so round 0 adds with the full wrap (permute_full).
__global__ void __launch_bounds__(PERMUTATION_THREADS)
    permutation_kernel(const uint32_t* __restrict__ in,
                       uint32_t* __restrict__ out, int64_t batch) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  Vec<T> s;
#pragma unroll
  for (int i = 0; i < T; i++) s.e[i] = load(in + (b * T + i) * NL);
  permute_full(s);
#pragma unroll
  for (int i = 0; i < T; i++) store(out + (b * T + i) * NL, s.e[i]);
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
  OP_MUL_SMALL_RR = 8,
  OP_SUB = 9,
};

__global__ void __launch_bounds__(FR_OP_THREADS)
    fr_op_kernel(int op, const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t c,
                 uint32_t* __restrict__ out, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Vec<1> x, y, r;
  x.e[0] = load(a + e * NL);
  switch (op) {
    case OP_MUL:
      y.e[0] = load(b + e * NL);
      r = mul(x, y);
      break;
    case OP_SQUARE:
      r = square(x);
      break;
    case OP_POWER5:
      r = power5(x);
      break;
    case OP_ADD_WRAP_RED:
      y.e[0] = load(b + e * NL);
      r = add_wrap_red(x, y);
      break;
    case OP_ADD_RR:
      y.e[0] = load(b + e * NL);
      r = add_rr(x, y);
      break;
    case OP_MUL_SMALL:
      r = mul_small(x, c);
      break;
    case OP_REDUCE_WIDE: {
      Wide w[1];
#pragma unroll
      for (int i = 0; i < NL; i++) {
        w[0].lo[i] = a[e * 2 * NL + i];
        w[0].hi[i] = a[e * 2 * NL + NL + i];
      }
      r = reduce_wide(w);
      break;
    }
    case OP_RED:
      r = red(x);
      break;
    case OP_SUB:
      y.e[0] = load(b + e * NL);
      r = sub(x, y);
      break;
    default: {  // OP_MUL_SMALL_RR
      const uint32_t cs[1] = {c};
      r = mul_small_rr(x, cs);
      break;
    }
  }
  store(out + e * NL, r.e[0]);
}

unsigned int blocks_for(int64_t n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

template <int G>
int launch_sponge(const uint32_t* in, uint32_t* out, int64_t batch, int n,
                  uint32_t ds, cudaStream_t stream) {
  sponge_kernel<G><<<blocks_for(batch * group_width(G), SPONGE_THREADS),
                     SPONGE_THREADS, 0, stream>>>(in, out, batch, n, ds);
  return (int)cudaGetLastError();
}

template <int G>
int launch_verify(const int32_t* pos, const uint32_t* sib,
                  const uint32_t* leaf, const uint32_t* root, uint8_t* ok,
                  int64_t k, int h, int arity, cudaStream_t stream) {
  verify_kernel<G><<<blocks_for(k * group_width(G), VERIFY_THREADS),
                     VERIFY_THREADS, 0, stream>>>(pos, sib, leaf, root, ok, k,
                                                  h, arity);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int resident_threads(Kernel kernel, int threads_per_block, int width,
                     int* states) {
  int blocks = 0;
  const cudaError_t code = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, threads_per_block, 0);
  *states = blocks * threads_per_block / width;
  return (int)code;
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

// lanes: G, 1 (one thread per state) or 3 (the state's elements split
// across lanes); any other value is refused.
int cuzk_sponge(const uint32_t* in, uint32_t* out, int64_t batch, int n,
                uint32_t ds, int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_sponge<1>(in, out, batch, n, ds, s);
    case SPLIT_LANES: return launch_sponge<SPLIT_LANES>(in, out, batch, n, ds, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int cuzk_verify(const int32_t* pos, const uint32_t* sib, const uint32_t* leaf,
                const uint32_t* root, uint8_t* ok, int64_t k, int h,
                int arity, int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_verify<1>(pos, sib, leaf, root, ok, k, h, arity, s);
    case SPLIT_LANES:
      return launch_verify<SPLIT_LANES>(pos, sib, leaf, root, ok, k, h, arity, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int cuzk_permutation(const uint32_t* in, uint32_t* out, int64_t batch,
                     void* stream) {
  permutation_kernel<<<blocks_for(batch, PERMUTATION_THREADS),
                       PERMUTATION_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, batch);
  return (int)cudaGetLastError();
}

// States (rows or proofs) that one SM holds resident for the sponge
// (kernel 0) or the verify kernel (kernel 1) at G lanes, from the
// occupancy API.
int cuzk_resident_states(int kernel, int lanes, int* states) {
  constexpr int S = SPLIT_LANES;
  if (kernel == 0) {
    switch (lanes) {
      case 1: return resident_threads(sponge_kernel<1>, SPONGE_THREADS, 1, states);
      case S:
        return resident_threads(sponge_kernel<S>, SPONGE_THREADS, group_width(S), states);
    }
  } else if (kernel == 1) {
    switch (lanes) {
      case 1: return resident_threads(verify_kernel<1>, VERIFY_THREADS, 1, states);
      case S:
        return resident_threads(verify_kernel<S>, VERIFY_THREADS, group_width(S), states);
    }
  }
  return (int)cudaErrorInvalidValue;
}

int cuzk_fr_op(int op, const uint32_t* a, const uint32_t* b, uint32_t c,
               uint32_t* out, int64_t n, void* stream) {
  fr_op_kernel<<<blocks_for(n, FR_OP_THREADS), FR_OP_THREADS, 0,
                 (cudaStream_t)stream>>>(op, a, b, c, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
