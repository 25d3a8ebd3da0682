// Poseidon kernels for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes): the wrappers in cuzk_tpu_torch/ops/poseidon_cuda.py
// check device, dtype, shape and contiguity, allocate the outputs, pass
// PyTorch's current stream, and raise when a launch returns an error.
//
// The form each kernel reads.  A field element is 16 int64 digits (the
// public form, read by value) or 8 u32 little-endian limbs (held in
// torch.int32 tensors and reinterpreted as uint32_t here):
//   - K1, the sponge, reads either: sponge_digits_kernel the leaf level's
//     digits, sponge_kernel the limbs the level below wrote (and pack16
//     words, which are limbs); both write limbs;
//   - K3, the verify kernel (verify_digits_kernel), reads the proofs'
//     digits and compares the root digit by digit;
//   - K4, the raw permutation (permutation_digits_kernel), and the per-op
//     check kernel (fr_op_digits_kernel) read and write digits.
//
// sponge_kernel and sponge_digits_kernel replace
// cuzk_tpu/ops/poseidon_pallas.py::_sponge_kernel_dyn (pallas_call at
// :488), verify_digits_kernel ::_make_verify_kernel (pallas_call at :385),
// permutation_digits_kernel ::_permutation_kernel (pallas_call at :795).
// The TPU kernels stream [16, 8, 128] digit tiles through VMEM and run a
// grid in order on one core; here blocks run in any order and a thread, or
// a group of lanes (poseidon.cuh), owns one hash, one proof or one state
// with the state in registers.
//
// What bounds them: integer multiplies, about 88K 32-bit multiply results
// a permutation (44,096 limb products), against 32 (limbs) or 128 (digits) bytes read per
// absorbed input.  A launch too small to fill the card's resident threads is bound
// instead by one state's latency through 64 dependent rounds, and most of
// the main path's launches are that small (a Merkle level of 64-4,096
// groups, 5,000 proofs).  So the sponge and the verify kernel take G lanes
// of a warp per state:
//   - G = 1, one thread per state, for launches above two split warps a
//     scheduler, where the issue rate counts: the body K4 runs, laid out
//     for it (poseidon.cuh);
//   - G = 3, three lanes each holding one state element, ten states a warp
//     (poseidon.cuh): a full round's three S-boxes and the MDS's three rows
//     run in parallel, with no carry between lanes, on the same field forms
//     as G = 1.  Its blocks are four warps, so a launch of up to SMs x 4 x
//     10 states (5,280 on an H100) puts at most one warp on each scheduler,
//     and one of up to twice that at most two.
// The wrapper picks G from the batch and the card's SM count
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
// The element split's blocks: four warps, one a scheduler of an SM, 40
// states.  A launch of up to 5,280 states is 132 blocks on an H100, one to
// an SM.
constexpr int SPLIT_WARPS = 4;
constexpr int SPLIT_THREADS = SPLIT_WARPS * WARP_LANES;
// Launch bounds' minimum blocks per SM: unset (0) for one thread per
// state, where ptxas gives the one-thread core 80 (K1) and 88 (K3)
// registers with no spills, near K4's 78; a minimum of 640-1,024 resident
// threads an SM held them to 64-96 registers, spilled (K3 at every one)
// and gained at most 2% (PERF.md).  1 for the element split, the latency
// regime below a wave, where ptxas may take what registers it needs.
constexpr int min_blocks(int lanes) { return lanes > 1 ? 1 : 0; }

// Threads a block at G lanes a state: the split's four warps, or the
// kernel's own count for one thread a state.
constexpr int block_threads(int lanes, int one_thread) {
  return lanes == SPLIT_LANES ? SPLIT_THREADS : one_thread;
}

__device__ __forceinline__ uint32_t warp_lane() { return threadIdx.x & 31u; }

// Where this thread works at G lanes a state: its item (row or proof), or
// -1 when it has none, and whether it stores that item's result.  One
// thread a state stores its own item; the split's groups are placed by
// poseidon.cuh::split_item and split_stores.
struct Place {
  int64_t item;
  bool stores;
};

template <int G>
__device__ __forceinline__ Place place(int64_t count) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (G == SPLIT_LANES) {
    return {split_item(t, count), split_stores(t, count)};
  } else {
    return {t < count ? t : -1, t < count};
  }
}

// K1: the width-dynamic sponge.  in [B, n, W] inputs of either form
// (poseidon.cuh::load_input), out [B, 8] limbs; thread or group b hashes
// row b.  Offsets are int64: a Merkle level of 2^24 groups of 8 digit
// inputs spans 2^31 int64 words.
template <int G, typename E>
__device__ __forceinline__ void sponge_item(const E* __restrict__ in,
                                            uint32_t* __restrict__ out,
                                            int64_t batch, int n, uint32_t ds) {
  const Place at = place<G>(batch);
  if (at.item < 0) return;
  const E* row = in + at.item * n * INPUT_WORDS<E>;
  Fe r;
  if constexpr (G == SPLIT_LANES) {
    r = sponge_row_split(row, n, ds, make_split_lane(warp_lane()));
  } else {
    r = sponge_row(row, n, ds);
  }
  if (at.stores) store(out + at.item * NL, r);
}

// On limbs: in [B, n, 8] u32.
template <int G>
__global__ void __launch_bounds__(block_threads(G, SPONGE_THREADS), min_blocks(G))
    sponge_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int64_t batch, int n, uint32_t ds) {
  sponge_item<G>(in, out, batch, n, ds);
}

// On the public digits: in [B, n, 16] int64, each input read by value, so
// a Merkle build's leaves go to the kernel as they are.  The digits are
// four times the limbs' bytes, still under 1% of the permutations' time;
// their loads make the kernel 1.4-1.8% slower than the limb form (PERF.md).
template <int G>
__global__ void __launch_bounds__(block_threads(G, SPONGE_THREADS), min_blocks(G))
    sponge_digits_kernel(const int64_t* __restrict__ in,
                         uint32_t* __restrict__ out, int64_t batch, int n,
                         uint32_t ds) {
  sponge_item<G>(in, out, batch, n, ds);
}

// K3: fused per-proof verify on the public digits.  pos [k, h] int32,
// sib [k, h, a-1, 16], leaf [k, 16] int64, root [16] or [k, 16] int64
// (root_stride 0 or 16 words, poseidon.cuh::proof_root) -> ok [k], one byte
// a verdict (a torch.bool tensor); thread or group t verifies proof t
// against its root.  The leaf and siblings are read by value and the root
// compared digit by digit (poseidon.cuh::verify_proof), so that a verify of
// proofs held as digits converts nothing.  Offsets are int64.
template <int G>
__device__ __forceinline__ void verify_item(const int32_t* __restrict__ pos,
                                            const int64_t* __restrict__ sib,
                                            const int64_t* __restrict__ leaf,
                                            const int64_t* __restrict__ root,
                                            int64_t root_stride,
                                            uint8_t* __restrict__ ok, int64_t k,
                                            int h, int arity) {
  constexpr int NW = 2 * NL;
  const Place at = place<G>(k);
  const int64_t t = at.item;
  if (t < 0) return;
  const int32_t* p = pos + t * h;
  const int64_t* s = sib + t * h * (int64_t)(arity - 1) * NW;
  const int64_t* r = proof_root(root, root_stride, t);
  bool same;
  if constexpr (G == SPLIT_LANES) {
    same = verify_proof_split(p, s, leaf + t * NW, r, h, arity,
                              make_split_lane(warp_lane()));
  } else {
    same = verify_proof(p, s, leaf + t * NW, r, h, arity);
  }
  if (at.stores) ok[t] = same ? 1 : 0;
}

template <int G>
__global__ void __launch_bounds__(block_threads(G, VERIFY_THREADS), min_blocks(G))
    verify_digits_kernel(const int32_t* __restrict__ pos,
                         const int64_t* __restrict__ sib,
                         const int64_t* __restrict__ leaf,
                         const int64_t* __restrict__ root,
                         int64_t root_stride, uint8_t* __restrict__ ok,
                         int64_t k, int h, int arity) {
  verify_item<G>(pos, sib, leaf, root, root_stride, ok, k, h, arity);
}

// K4: the raw batched permutation on states of any 256-bit values, so round
// 0 adds with the full wrap (poseidon.cuh::permute_full_ilp, K4's own
// design), on the public digits: in, out [B, 3, 16] int64, read by value
// and written below 2^16 (fr254.cuh::load_digits / store_digits), so that
// the wrapper converts nothing.  What bounds it: the multiply pipe at
// 88,192 multiply results a state (the rest of its instructions go to the
// ALU beside it); its bytes (128 per element each way) are below 1% of
// that.  One thread a state: at 65,536 states the launch is one wave.
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
// BatchFieldArithmetic.  On the public digits: a [n, W] int64 (W = 32 for
// reduce_wide, two elements a row, else 16), b [n, 16], out [n, 16].
// What bounds it: its bytes, 128 a digit row, against a few hundred
// integer operations an element.  So a warp moves its 32 rows as consecutive 16-byte chunks
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

// Blocks for count items at G lanes a state, in blocks of threads threads
// (poseidon.cuh::split_item: ten items a warp at G = 3).
unsigned int blocks_for_items(int64_t count, int lanes, int threads) {
  if (lanes != SPLIT_LANES) return blocks_for(count, threads);
  const int64_t warps = (count + SPLIT_GROUPS - 1) / SPLIT_GROUPS;
  return blocks_for(warps * WARP_LANES, threads);
}

template <int G, typename E>
int launch_sponge(const E* in, uint32_t* out, int64_t batch, int n,
                  uint32_t ds, cudaStream_t stream) {
  constexpr int threads = block_threads(G, SPONGE_THREADS);
  const unsigned int blocks = blocks_for_items(batch, G, threads);
  if constexpr (sizeof(E) == sizeof(uint32_t)) {
    sponge_kernel<G><<<blocks, threads, 0, stream>>>(in, out, batch, n, ds);
  } else {
    sponge_digits_kernel<G><<<blocks, threads, 0, stream>>>(in, out, batch, n, ds);
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

template <int G>
int launch_verify(const int32_t* pos, const int64_t* sib, const int64_t* leaf,
                  const int64_t* root, int64_t root_stride, uint8_t* ok,
                  int64_t k, int h, int arity, cudaStream_t stream) {
  constexpr int threads = block_threads(G, VERIFY_THREADS);
  verify_digits_kernel<G><<<blocks_for_items(k, G, threads), threads, 0, stream>>>(
      pos, sib, leaf, root, root_stride, ok, k, h, arity);
  return (int)cudaGetLastError();
}

// States of kernel at G lanes a state that one SM holds resident, from the
// occupancy API: a thread each at G = 1, ten a warp at G = 3.
template <int G, typename Kernel>
int resident(Kernel kernel, int one_thread, int* states) {
  const int threads = block_threads(G, one_thread);
  int blocks = 0;
  const cudaError_t code =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  *states = G == SPLIT_LANES ? blocks * threads / WARP_LANES * SPLIT_GROUPS
                             : blocks * threads;
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

// lanes: G, as for the sponge; root_stride: 0 for one root, 16 for one a
// proof.
int cuzk_verify_digits(const int32_t* pos, const int64_t* sib,
                       const int64_t* leaf, const int64_t* root,
                       int64_t root_stride, uint8_t* ok, int64_t k, int h,
                       int arity, int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1:
      return launch_verify<1>(pos, sib, leaf, root, root_stride, ok, k, h,
                              arity, s);
    case SPLIT_LANES:
      return launch_verify<SPLIT_LANES>(pos, sib, leaf, root, root_stride, ok,
                                        k, h, arity, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
      case 1: return resident<1>(sponge_kernel<1>, SPONGE_THREADS, states);
      case S: return resident<S>(sponge_kernel<S>, SPONGE_THREADS, states);
    }
  } else if (kernel == 1) {
    switch (lanes) {
      case 1: return resident<1>(verify_digits_kernel<1>, VERIFY_THREADS, states);
      case S: return resident<S>(verify_digits_kernel<S>, VERIFY_THREADS, states);
    }
  }
  return (int)cudaErrorInvalidValue;
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
