"""Measure the card's 32-bit integer multiply rate per SM per clock.

    python -m zkbench.calibrate_imad

A one-off microbenchmark, run by hand on the card and never in a cell's
run.  Four kernels each run eight independent dependent chains a thread of
one multiply instruction, 1,024 threads on every SM: ``mad.lo.u32``
(IMAD), ``mad.hi.u32`` (IMAD.HI.U32), ``mul.wide.u32`` (IMAD.WIDE.U32, its
multiplicand the xor of the last product's two words: one LOP3 a step on
the integer ALU) and ``mad.wide.u32`` with a 64-bit addend (which ptxas
splits into IMAD.WIDE.U32 and IMAD.X).  Each block reads its SM's cycle
counter around its loop, so the rate comes out per SM per clock whatever
clock the card runs at; CUDA events give the rate per second beside it.
``cuobjdump -sass`` counts each kernel's instructions by opcode, to show
that the loop is the instruction named.

IMAD.WIDE.U32 gives both words of a 32 x 32-bit product.  If it issued at
the IMAD rate, one multiply slot would give two 32-bit results and
``roofline.py``'s peak would double; ``results_per_slot`` in the output is
that ratio.  Prints one JSON line; writes its build to ``zkbench/out/``
(git ignores it).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out",
                   "calibrate")
CHAINS = 8
UNROLL = 8
THREADS = 256
BLOCKS_PER_SM = 4

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

#define CHAINS 8
#define UNROLL 8

__device__ __forceinline__ unsigned smid() {
  unsigned r; asm volatile("mov.u32 %0, %%smid;" : "=r"(r)); return r;
}

#define LOOP(...)                                                       \
  __syncthreads();                                                     \
  long long t0 = clock64();                                            \
  for (int it = 0; it < iters; ++it) {                                 \
    _Pragma("unroll") for (int u = 0; u < UNROLL; ++u) {               \
      _Pragma("unroll") for (int k = 0; k < CHAINS; ++k) { __VA_ARGS__; }     \
    }                                                                  \
  }                                                                    \
  __syncthreads();                                                     \
  long long t1 = clock64();                                            \
  if (threadIdx.x == 0) {                                              \
    cyc[3 * blockIdx.x] = t0; cyc[3 * blockIdx.x + 1] = t1;            \
    cyc[3 * blockIdx.x + 2] = smid();                                  \
  }

__global__ void imad_lo_kernel(unsigned* out, long long* cyc, int iters,
                               unsigned m, unsigned c) {
  unsigned a[CHAINS];
  for (int k = 0; k < CHAINS; ++k) a[k] = threadIdx.x * 7u + k;
  LOOP(asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a[k]) : "r"(m), "r"(c)))
  unsigned x = 0;
  for (int k = 0; k < CHAINS; ++k) x ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

__global__ void imad_wide_kernel(unsigned* out, long long* cyc, int iters,
                                 unsigned m, unsigned c) {
  unsigned long long a[CHAINS];
  for (int k = 0; k < CHAINS; ++k) a[k] = threadIdx.x * 7ull + k + c;
  // Both words of each product feed the next (their xor, one LOP3 on the
  // integer ALU), so no word is dead and no add is folded in.
  unsigned long long cc = c;
  LOOP(asm volatile("{ .reg .u32 lo, hi; mov.b64 {lo, hi}, %0;"
                    " xor.b32 lo, lo, hi; mad.wide.u32 %0, lo, %1, %2; }"
                    : "+l"(a[k]) : "r"(m), "l"(cc)))
  unsigned long long x = 0;
  for (int k = 0; k < CHAINS; ++k) x ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = (unsigned)(x ^ (x >> 32));
}

__global__ void imad_hi_kernel(unsigned* out, long long* cyc, int iters,
                               unsigned m, unsigned c) {
  unsigned a[CHAINS];
  for (int k = 0; k < CHAINS; ++k) a[k] = threadIdx.x * 7u + k + 0x80000000u;
  LOOP(asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(a[k]) : "r"(m), "r"(c)))
  unsigned x = 0;
  for (int k = 0; k < CHAINS; ++k) x ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

__global__ void imad_wide_mul_kernel(unsigned* out, long long* cyc, int iters,
                                     unsigned m, unsigned c) {
  unsigned long long a[CHAINS];
  for (int k = 0; k < CHAINS; ++k) a[k] = threadIdx.x * 7ull + k + c;
  LOOP(asm volatile("{ .reg .u32 lo, hi; mov.b64 {lo, hi}, %0;"
                    " xor.b32 lo, lo, hi; mul.wide.u32 %0, lo, %1; }"
                    : "+l"(a[k]) : "r"(m)))
  unsigned long long x = 0;
  for (int k = 0; k < CHAINS; ++k) x ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = (unsigned)(x ^ (x >> 32));
}

extern "C" int run_kernel(int which, int blocks, int threads, int iters,
                          unsigned* out, long long* cyc, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  if (which == 0) imad_lo_kernel<<<blocks, threads>>>(out, cyc, iters, 0x9E3779B1u, 12345u);
  else if (which == 1) imad_wide_kernel<<<blocks, threads>>>(out, cyc, iters, 0x9E3779B1u, 12345u);
  else if (which == 2) imad_hi_kernel<<<blocks, threads>>>(out, cyc, iters, 0x9E3779B1u, 12345u);
  else imad_wide_mul_kernel<<<blocks, threads>>>(out, cyc, iters, 0x9E3779B1u, 12345u);
  cudaEventRecord(e1);
  cudaError_t err = cudaEventSynchronize(e1);
  if (err == cudaSuccess) err = cudaGetLastError();
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0); cudaEventDestroy(e1);
  return (int)err;
}
"""

KERNELS = (("imad_lo", "IMAD", 1), ("imad_wide", "IMAD.WIDE.U32", 2),
           ("imad_hi", "IMAD.HI.U32", 1), ("imad_wide_mul", "IMAD.WIDE.U32", 2))


def build() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "calibrate_imad.cu")
    lib = os.path.join(OUT, "libcalibrate_imad.so")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    subprocess.run([nvcc, "-O3", "-std=c++17",
                    "-gencode=arch=compute_90a,code=sm_90a", "-shared",
                    "-Xcompiler=-fPIC", "-o", lib, src], check=True)
    return lib


def sass_counts(lib: str) -> dict:
    """Opcode counts of each kernel's SASS (``cuobjdump -sass``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((k for k, _, _ in KERNELS if f"{k}_kernel" in m.group(1)),
                        m.group(1))
            counts[name] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            op = m.group(1)
            counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("calibrate_imad: no CUDA card", file=sys.stderr)
        return 2
    lib_path = build()
    lib = ctypes.CDLL(lib_path)
    lib.run_kernel.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.run_kernel.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device="cuda")
    cyc = torch.empty(blocks * 3, dtype=torch.int64, device="cuda")
    ms = ctypes.c_float()
    result = {"device": torch.cuda.get_device_name(0), "sms": sms,
              "threads_per_sm": THREADS * BLOCKS_PER_SM, "chains": CHAINS}
    try:
        result["name_power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        result["name_power_limit"] = None
    for which, (name, opcode, results) in enumerate(KERNELS):
        rows = []
        for iters in (256, 2048, 8192):
            for _ in range(2):
                code = lib.run_kernel(which, blocks, THREADS, iters,
                                      out.data_ptr(), cyc.data_ptr(),
                                      ctypes.byref(ms))
                if code != 0:
                    raise RuntimeError(f"{name}: CUDA error {code}")
            c = cyc.cpu().numpy().reshape(blocks, 3)
            per_sm = []
            for sm in np.unique(c[:, 2]):
                on = c[c[:, 2] == sm]
                cycles = on[:, 1].max() - on[:, 0].min()
                ops = len(on) * THREADS * iters * UNROLL * CHAINS
                per_sm.append(ops / cycles)
            ops_total = blocks * THREADS * iters * UNROLL * CHAINS
            rows.append({
                "iters": iters,
                "instr_per_clock_per_sm_median": float(np.median(per_sm)),
                "instr_per_clock_per_sm_min": float(np.min(per_sm)),
                "instr_per_s": ops_total / (ms.value * 1e-3),
                "ms": ms.value,
            })
        result[name] = {"opcode": opcode, "results_per_instr": results,
                        "runs": rows}
    result["sass"] = sass_counts(lib_path)
    lo = result["imad_lo"]["runs"][-1]["instr_per_clock_per_sm_median"]
    wide = result["imad_wide_mul"]["runs"][-1]["instr_per_clock_per_sm_median"]
    result["wide_over_lo"] = wide / lo
    # 32-bit results one IMAD slot gives when products are IMAD.WIDE.U32.
    result["results_per_slot"] = 2 * wide / lo
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
