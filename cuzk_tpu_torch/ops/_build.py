"""Build and load the CUDA kernels at first use.

The counterpart of ``cuzk_tpu.native.ensure_built``: the sources under
``cuzk_tpu_torch/csrc/`` are compiled by nvcc (sm_90a only, ``-O3``) into a
shared library in ``cuzk_tpu_torch/_build/``, a directory git ignores, and
bound through their plain C interface with ctypes.  The sources include no
PyTorch header.  ptxas reports each kernel's registers, stack frame and
spills (``-Xptxas -v``); :attr:`Kernels.ptxas` holds that record, parsed,
beside the library.  Importing this module builds nothing; a failed build
raises :class:`KernelBuildError` with the compiler's output, and nothing
falls back to the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import numpy as np

from cuzk_tpu_torch.utils.device import require_cuda
from cuzk_tpu_torch.utils.errors import KernelBuildError

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
SOURCES = ("poseidon_kernels.cu",)
HEADERS = ("fr254.cuh", "poseidon.cuh")
LIBRARY_NAME = "libcuzk_tpu_torch_kernels"
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
)

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
)
_REGS = re.compile(r"Used (\d+) registers")
# The kernel's own name in a mangled symbol: the last "<len>name_kernel",
# with its lane count when it is a template.
_KERNEL = re.compile(r"(?<=\d)([a-z_]+_kernel)(?:ILi(\d+)EE)?")


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """``{kernel<G>: {registers, stack_frame, spill_stores, spill_loads}}``
    from nvcc's ``-Xptxas -v`` output."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            found = _KERNEL.findall(m.group(1))
            name = m.group(1) if not found else (
                found[-1][0] + (f"<{found[-1][1]}>" if found[-1][1] else ""))
            out[name] = {}
            continue
        if name is None:
            continue
        m = _FRAME.search(line)
        if m:
            out[name].update(stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise KernelBuildError("nvcc was not found (no CUDA toolkit)")
    return path


class Kernels:
    """The loaded kernel library: ctypes handles plus the build's record."""

    def __init__(self, lib: ctypes.CDLL, path: str, build_seconds: float,
                 ptxas: Dict[str, Dict[str, int]]):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas = ptxas
        self._devices_with_constants = set()
        self._lock = threading.Lock()
        p, i32, i64, u32 = (
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
        )
        signatures = {
            "cuzk_set_round_constants": [p],
            "cuzk_sponge": [p, p, i64, i32, u32, i32, p],
            "cuzk_sponge_digits": [p, p, i64, i32, u32, i32, p],
            "cuzk_resident_states": [i32, i32, ctypes.POINTER(ctypes.c_int)],
            "cuzk_verify_digits": [p, p, p, p, i64, p, i64, i32, i32, i32, p],
            "cuzk_permutation_digits": [p, p, i64, p],
            "cuzk_fr_op_digits": [i32, p, p, u32, p, i64, p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cuzk_error_string.argtypes = [ctypes.c_int]
        lib.cuzk_error_string.restype = ctypes.c_char_p

    def error_string(self, code: int) -> str:
        return self.lib.cuzk_error_string(code).decode()

    def ensure_round_constants(self, device_index: int) -> None:
        """Upload the round constants to ``device_index``'s constant memory
        once (the analog of the reference's cudaMemcpyToSymbol upload)."""
        with self._lock:
            if device_index in self._devices_with_constants:
                return
            import torch

            from cuzk_tpu_torch.poseidon import RC_LIMBS

            rc = np.ascontiguousarray(RC_LIMBS, dtype=np.uint32)
            with torch.cuda.device(device_index):
                code = self.lib.cuzk_set_round_constants(rc.ctypes.data)
            if code != 0:
                raise KernelBuildError(
                    "uploading the round constants failed: "
                    + self.error_string(code)
                )
            self._devices_with_constants.add(device_index)


_kernels: Optional[Kernels] = None
_kernels_lock = threading.Lock()


def build() -> str:
    """Compile the kernels into :data:`BUILD_DIR`; returns the library
    path.  The ptxas record is written beside it (``.ptxas.txt``)."""
    require_cuda()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # The name carries a digest of every source, header and flag, so a
    # stale library never loads.
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    path = os.path.join(BUILD_DIR, f"{LIBRARY_NAME}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(path) and os.path.exists(path + ".ptxas.txt"):
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise KernelBuildError(f"running nvcc failed: {e}") from e
    if res.returncode != 0 or not os.path.exists(tmp):
        raise KernelBuildError(
            f"building the CUDA kernels failed (nvcc exit {res.returncode}):\n"
            f"{res.stdout}{res.stderr}"
        )
    with open(path + ".ptxas.txt", "w") as fh:
        fh.write(res.stdout + res.stderr)
    os.replace(tmp, path)
    return path


def kernels() -> Kernels:
    """The kernel library, built and loaded at the first call."""
    global _kernels
    with _kernels_lock:
        if _kernels is None:
            start = time.perf_counter()
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"loading {path} failed: {e}") from e
            with open(path + ".ptxas.txt") as fh:
                ptxas = parse_ptxas(fh.read())
            _kernels = Kernels(lib, path, time.perf_counter() - start, ptxas)
        return _kernels
