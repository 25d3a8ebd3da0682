// Poseidon kernels for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes): the wrappers in cuzk_tpu_torch/ops/poseidon_cuda.py
// check device, dtype, shape and contiguity, allocate the outputs, pass
// PyTorch's current stream, and raise when a launch returns an error.
//
// Tensors of field elements are 8 x u32 little-endian limbs per element,
// held in torch.int32 tensors and reinterpreted as uint32_t here.
//
// sponge_kernel (on limbs) and sponge_digits_kernel (on the public digits)
// replace cuzk_tpu/ops/poseidon_pallas.py::_sponge_kernel_dyn
// (pallas_call at :488).  verify_kernel and verify_digits_kernel (the same
// two forms) replace ::_make_verify_kernel (pallas_call at :385).
// permutation_kernel replaces ::_permutation_kernel (pallas_call at :795).
// The TPU kernels stream [16, 8, 128] digit tiles through VMEM and run a
// grid in order on one core; here blocks run in any order and a thread, or
// a group of lanes (poseidon.cuh), owns one hash, one proof or one state
// with the state in registers.
//
// What bounds them: integer multiplies, about 88K 32-bit multiply results
// a permutation (44,096 limb products), against 32 bytes read per absorbed
// input.  A launch too small to fill the card's resident threads is bound
// instead by one state's latency through 64 dependent rounds, and most of
// the main path's launches are that small (a Merkle level of 64-4,096
// groups, 5,000 proofs).  So the sponge and the verify kernel take G lanes
// of a warp per state:
//   - G = 1, one thread per state, for launches from a twentieth of a wave
//     up, where only the issue rate counts: the body K4 runs, laid out for
//     it (poseidon.cuh);
//   - G = 3, three lanes of a four-lane group each holding one state element
//     (poseidon.cuh): a full round's three S-boxes and the MDS's three rows
//     run in parallel, with no carry between lanes; shorter per state than
//     G = 1 on an H100 (0.216 against 0.240 ms at 4,096 pairs).
// The wrapper picks G from the batch and the resident threads
// (ops/poseidon_cuda.py::choose_lanes).  The raw permutation runs one
// thread a state.
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
// state, where ptxas gives the one-thread core 80 (K1) and 88 (K3)
// registers with no spills, near K4's 78; a minimum of 640-1,024 resident
// threads an SM held them to 64-96 registers, spilled (K3 at every one)
// and gained at most 2% (PERF.md).  1 for the element split, the latency
// regime below a wave, where ptxas may take what registers it needs.
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

// K1: the width-dynamic sponge.  in [B, n, W] inputs of either form
// (poseidon.cuh::load_input), out [B, 8] limbs; thread or group b hashes
// row b.  Offsets are int64: a Merkle level of 2^24 groups of 8 digit
// inputs spans 2^31 int64 words.
template <int G, typename E>
__device__ __forceinline__ void sponge_item(const E* __restrict__ in,
                                            uint32_t* __restrict__ out,
                                            int64_t batch, int n, uint32_t ds) {
  constexpr int W = group_width(G);
  const int64_t b = group_item<W>(batch);
  if (b < 0) return;
  const E* row = in + b * n * INPUT_WORDS<E>;
  Fe r;
  if constexpr (G == SPLIT_LANES) {
    r = sponge_row_split(row, n, ds, make_split_lane(warp_lane()));
  } else {
    r = sponge_row(row, n, ds);
  }
  if (warp_lane() % W == 0 && owns_item<W>(batch)) store(out + b * NL, r);
}

// On limbs: in [B, n, 8] u32.
template <int G>
__global__ void __launch_bounds__(SPONGE_THREADS, min_blocks(G))
    sponge_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int64_t batch, int n, uint32_t ds) {
  sponge_item<G>(in, out, batch, n, ds);
}

// On the public digits: in [B, n, 16] int64, each input read by value, so
// a Merkle build's leaves go to the kernel as they are.  The digits are
// four times the limbs' bytes, still under 1% of the permutations' time;
// their loads make the kernel 1.4-1.8% slower than the limb form (PERF.md).
template <int G>
__global__ void __launch_bounds__(SPONGE_THREADS, min_blocks(G))
    sponge_digits_kernel(const int64_t* __restrict__ in,
                         uint32_t* __restrict__ out, int64_t batch, int n,
                         uint32_t ds) {
  sponge_item<G>(in, out, batch, n, ds);
}

// K3: fused per-proof verify.  pos [k, h] int32, sib [k, h, a-1, W],
// leaf [k, W], root [W] in either input form (poseidon.cuh::load_input) ->
// ok [k], one byte a verdict (a torch.bool tensor); thread or group t
// verifies proof t.  Offsets are int64.
template <int G, typename E>
__device__ __forceinline__ void verify_item(const int32_t* __restrict__ pos,
                                            const E* __restrict__ sib,
                                            const E* __restrict__ leaf,
                                            const E* __restrict__ root,
                                            uint8_t* __restrict__ ok, int64_t k,
                                            int h, int arity) {
  constexpr int W = group_width(G);
  constexpr int NW = INPUT_WORDS<E>;
  const int64_t t = group_item<W>(k);
  if (t < 0) return;
  const int32_t* p = pos + t * h;
  const E* s = sib + t * h * (int64_t)(arity - 1) * NW;
  bool same;
  if constexpr (G == SPLIT_LANES) {
    same = verify_proof_split(p, s, leaf + t * NW, root, h, arity,
                              make_split_lane(warp_lane()));
  } else {
    same = verify_proof(p, s, leaf + t * NW, root, h, arity);
  }
  if (warp_lane() % W == 0 && owns_item<W>(k)) ok[t] = same ? 1 : 0;
}

// On limbs: sib [k, h, a-1, 8], leaf [k, 8], root [8] u32.
template <int G>
__global__ void __launch_bounds__(VERIFY_THREADS, min_blocks(G))
    verify_kernel(const int32_t* __restrict__ pos,
                  const uint32_t* __restrict__ sib,
                  const uint32_t* __restrict__ leaf,
                  const uint32_t* __restrict__ root,
                  uint8_t* __restrict__ ok, int64_t k, int h, int arity) {
  verify_item<G>(pos, sib, leaf, root, ok, k, h, arity);
}

// On the public digits: sib [k, h, a-1, 16], leaf [k, 16], root [16]
// int64, the leaf and siblings read by value and the root compared digit by
// digit, so that a verify of proofs held as digits converts nothing.  Their
// loads make the kernel 1.7-1.9% slower than the limb form (PERF.md).
template <int G>
__global__ void __launch_bounds__(VERIFY_THREADS, min_blocks(G))
    verify_digits_kernel(const int32_t* __restrict__ pos,
                         const int64_t* __restrict__ sib,
                         const int64_t* __restrict__ leaf,
                         const int64_t* __restrict__ root,
                         uint8_t* __restrict__ ok, int64_t k, int h,
                         int arity) {
  verify_item<G>(pos, sib, leaf, root, ok, k, h, arity);
}

// K4: the raw batched permutation on states of any 256-bit values, so round
// 0 adds with the full wrap.  Two forms of one body (poseidon.cuh::
// permute_full_ilp, K4's own design): on limbs, in, out [B, 3, 8]; and on
// the public digits, in, out [B, 3, 16] int64, read by value and written
// below 2^16 (fr254.cuh::load_digits / store_digits), so that the wrapper
// converts nothing.  What bounds it: the multiply pipe at 88,192 multiply
// results a state (the rest of its instructions go to the ALU beside it);
// its bytes (32 or 64 per element each way) are below 1% of that.  One
// thread a state: at 65,536 states the launch is one wave.
__global__ void __launch_bounds__(PERMUTATION_THREADS)
    permutation_kernel(const uint32_t* __restrict__ in,
                       uint32_t* __restrict__ out, int64_t batch) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  Vec<T> s;
#pragma unroll
  for (int i = 0; i < T; i++) s.e[i] = load(in + (b * T + i) * NL);
  permute_full_ilp(s);
#pragma unroll
  for (int i = 0; i < T; i++) store(out + (b * T + i) * NL, s.e[i]);
}

__global__ void __launch_bounds__(PERMUTATION_THREADS)
    permutation_digits_kernel(const int64_t* __restrict__ in,
                              int64_t* __restrict__ out, int64_t batch) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  Vec<T> s;
#pragma unroll
  for (int i = 0; i < T; i++) s.e[i] = load_digits(in + (b * T + i) * 2 * NL);
  permute_full_ilp(s);
#pragma unroll
  for (int i = 0; i < T; i++) store_digits(out + (b * T + i) * 2 * NL, s.e[i]);
}

// Per-op check kernel (ops fr254.cuh::FrOp): exposes the field library, one
// operation per element, so that each can be held against its plain
// PyTorch version; it is also the device half of field/batch.py's
// BatchFieldArithmetic.
// On limbs: a [n, 8] ([n, 16], low half first, for reduce_wide), b [n, 8].
__global__ void __launch_bounds__(FR_OP_THREADS)
    fr_op_kernel(int op, const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t c,
                 uint32_t* __restrict__ out, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const bool wide = op == OP_REDUCE_WIDE;
  const uint32_t* x = a + e * (wide ? 2 : 1) * NL;
  const Fe r = fr_op_apply(op, load(x), wide ? load(x + NL) : zero(),
                           load(b + e * NL), c);
  store(out + e * NL, r);
}

// On the public digits: a [n, W] int64 (W = 32 for reduce_wide, two
// elements a row, else 16), b [n, 16], out [n, 16].  What bounds it: its
// bytes, 128 a digit row, against a few hundred integer operations an
// element.  So a warp moves its 32 rows as consecutive 16-byte chunks
// (coalesced) through shared memory, each thread then reads its own row by
// value there (rows padded by one digit, so the 32 lanes hit other banks)
// and computes one element, and the results leave the same way.
constexpr int WARP_ROWS = 32;

template <int W>
__device__ __forceinline__ void stage_rows(int64_t* sh, const int64_t* g,
                                           int rows, uint32_t lane) {
  const longlong2* src = reinterpret_cast<const longlong2*>(g);
  for (int c = lane; c < rows * W / 2; c += WARP_ROWS) {
    const longlong2 v = src[c];
    const int row = 2 * c / W, col = 2 * c % W;
    sh[row * (W + 1) + col] = v.x;
    sh[row * (W + 1) + col + 1] = v.y;
  }
}

template <int W>
__global__ void __launch_bounds__(FR_OP_THREADS)
    fr_op_digits_kernel(int op, const int64_t* __restrict__ a,
                        const int64_t* __restrict__ b, uint32_t c,
                        int64_t* __restrict__ out, int64_t n) {
  constexpr int ND = 2 * NL;
  constexpr int WARPS = FR_OP_THREADS / WARP_ROWS;
  __shared__ int64_t sh_a[WARPS][WARP_ROWS * (W + 1)];
  __shared__ int64_t sh_b[WARPS][W == ND ? WARP_ROWS * (ND + 1) : 1];
  const uint32_t lane = warp_lane(), warp = threadIdx.x / WARP_ROWS;
  const int64_t row0 = ((int64_t)blockIdx.x * blockDim.x) + warp * WARP_ROWS;
  if (row0 >= n) return;
  const int rows = n - row0 < WARP_ROWS ? (int)(n - row0) : WARP_ROWS;
  const bool binary = op == OP_MUL || op == OP_ADD_WRAP_RED ||
                      op == OP_ADD_RR || op == OP_SUB;
  int64_t* sa = sh_a[warp];
  int64_t* sb = sh_b[warp];
  stage_rows<W>(sa, a + row0 * W, rows, lane);
  if (W == ND && binary) stage_rows<ND>(sb, b + row0 * ND, rows, lane);
  __syncwarp();
  Fe r;
  if ((int)lane < rows) {
    const int64_t* x = sa + lane * (W + 1);
    r = fr_op_apply(op, load_digits(x), W == 2 * ND ? load_digits(x + ND) : zero(),
                    W == ND && binary ? load_digits(sb + lane * (ND + 1)) : zero(),
                    c);
  }
  __syncwarp();
  if ((int)lane < rows) store_digits(sa + lane * (ND + 1), r);
  __syncwarp();
  longlong2* dst = reinterpret_cast<longlong2*>(out + row0 * ND);
  for (int q = lane; q < rows * ND / 2; q += WARP_ROWS) {
    const int row = 2 * q / ND, col = 2 * q % ND;
    dst[q] = make_longlong2(sa[row * (ND + 1) + col], sa[row * (ND + 1) + col + 1]);
  }
}

unsigned int blocks_for(int64_t n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

template <int G, typename E>
int launch_sponge(const E* in, uint32_t* out, int64_t batch, int n,
                  uint32_t ds, cudaStream_t stream) {
  const unsigned int blocks = blocks_for(batch * group_width(G), SPONGE_THREADS);
  if constexpr (sizeof(E) == sizeof(uint32_t)) {
    sponge_kernel<G><<<blocks, SPONGE_THREADS, 0, stream>>>(in, out, batch, n, ds);
  } else {
    sponge_digits_kernel<G><<<blocks, SPONGE_THREADS, 0, stream>>>(in, out, batch,
                                                                  n, ds);
  }
  return (int)cudaGetLastError();
}

// lanes: G, 1 (one thread per state) or 3 (the state's elements split
// across lanes); any other value is refused.
template <typename E>
int launch_sponge_lanes(const E* in, uint32_t* out, int64_t batch, int n,
                        uint32_t ds, int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_sponge<1>(in, out, batch, n, ds, s);
    case SPLIT_LANES: return launch_sponge<SPLIT_LANES>(in, out, batch, n, ds, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int G, typename E>
int launch_verify(const int32_t* pos, const E* sib, const E* leaf,
                  const E* root, uint8_t* ok, int64_t k, int h, int arity,
                  cudaStream_t stream) {
  const unsigned int blocks = blocks_for(k * group_width(G), VERIFY_THREADS);
  if constexpr (sizeof(E) == sizeof(uint32_t)) {
    verify_kernel<G><<<blocks, VERIFY_THREADS, 0, stream>>>(pos, sib, leaf,
                                                            root, ok, k, h,
                                                            arity);
  } else {
    verify_digits_kernel<G><<<blocks, VERIFY_THREADS, 0, stream>>>(
        pos, sib, leaf, root, ok, k, h, arity);
  }
  return (int)cudaGetLastError();
}

// lanes: G, as for the sponge.
template <typename E>
int launch_verify_lanes(const int32_t* pos, const E* sib, const E* leaf,
                        const E* root, uint8_t* ok, int64_t k, int h, int arity,
                        int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_verify<1>(pos, sib, leaf, root, ok, k, h, arity, s);
    case SPLIT_LANES:
      return launch_verify<SPLIT_LANES>(pos, sib, leaf, root, ok, k, h, arity, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

int cuzk_sponge(const uint32_t* in, uint32_t* out, int64_t batch, int n,
                uint32_t ds, int lanes, void* stream) {
  return launch_sponge_lanes(in, out, batch, n, ds, lanes, stream);
}

int cuzk_sponge_digits(const int64_t* in, uint32_t* out, int64_t batch, int n,
                       uint32_t ds, int lanes, void* stream) {
  return launch_sponge_lanes(in, out, batch, n, ds, lanes, stream);
}

int cuzk_verify(const int32_t* pos, const uint32_t* sib, const uint32_t* leaf,
                const uint32_t* root, uint8_t* ok, int64_t k, int h,
                int arity, int lanes, void* stream) {
  return launch_verify_lanes(pos, sib, leaf, root, ok, k, h, arity, lanes,
                             stream);
}

int cuzk_verify_digits(const int32_t* pos, const int64_t* sib,
                       const int64_t* leaf, const int64_t* root, uint8_t* ok,
                       int64_t k, int h, int arity, int lanes, void* stream) {
  return launch_verify_lanes(pos, sib, leaf, root, ok, k, h, arity, lanes,
                             stream);
}

int cuzk_permutation(const uint32_t* in, uint32_t* out, int64_t batch,
                     void* stream) {
  permutation_kernel<<<blocks_for(batch, PERMUTATION_THREADS),
                       PERMUTATION_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, batch);
  return (int)cudaGetLastError();
}

int cuzk_permutation_digits(const int64_t* in, int64_t* out, int64_t batch,
                            void* stream) {
  permutation_digits_kernel<<<blocks_for(batch, PERMUTATION_THREADS),
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

// Digit rows must start on 16 bytes (the wrapper's check).
int cuzk_fr_op_digits(int op, const int64_t* a, const int64_t* b, uint32_t c,
                      int64_t* out, int64_t n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int ND = 2 * NL;
  if (op == OP_REDUCE_WIDE) {
    fr_op_digits_kernel<2 * ND><<<blocks_for(n, FR_OP_THREADS), FR_OP_THREADS, 0, s>>>(
        op, a, b, c, out, n);
  } else {
    fr_op_digits_kernel<ND><<<blocks_for(n, FR_OP_THREADS), FR_OP_THREADS, 0, s>>>(
        op, a, b, c, out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
