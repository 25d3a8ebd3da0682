"""Build and load the CUDA kernels at first use.

The counterpart of ``cuzk_tpu.native.ensure_built``: the sources under
``cuzk_tpu_torch/csrc/`` are compiled with ``torch.utils.cpp_extension.load``
(nvcc, for sm_90a only, ``-O3``) into ``cuzk_tpu_torch/_build/``, a directory
git ignores, and bound through their plain C interface with ctypes.  The
sources include no PyTorch header, so nvcc takes seconds, not minutes.
Importing this module builds nothing; a failed build raises
:class:`KernelBuildError` with the compiler's output, and nothing falls
back to the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
import time
from typing import Optional

import numpy as np

from cuzk_tpu_torch.utils.device import require_cuda
from cuzk_tpu_torch.utils.errors import KernelBuildError

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
SOURCES = ("poseidon_kernels.cu",)
HEADERS = ("fr254.cuh",)
EXTENSION_NAME = "cuzk_tpu_torch_kernels"
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
)


class Kernels:
    """The loaded kernel library: ctypes handles plus the build's record."""

    def __init__(self, lib: ctypes.CDLL, path: str, build_seconds: float):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self._devices_with_constants = set()
        self._lock = threading.Lock()
        p, i32, i64, u32 = (
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
        )
        signatures = {
            "cuzk_set_round_constants": [p],
            "cuzk_sponge": [p, p, i64, i32, u32, p],
            "cuzk_verify": [p, p, p, p, p, i64, i32, i32, p],
            "cuzk_fr_op": [i32, p, p, u32, p, i64, p],
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
    """Compile the kernels into :data:`BUILD_DIR`; returns the library path."""
    require_cuda()
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    # The name carries a digest of every source and header: torch's loader
    # tracks the sources alone, and a stale library must never load.
    digest = hashlib.sha256()
    for f in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    try:
        path = load(
            name=f"{EXTENSION_NAME}_{digest.hexdigest()[:12]}",
            sources=[os.path.join(CSRC_DIR, s) for s in SOURCES],
            extra_cuda_cflags=list(NVCC_FLAGS),
            extra_include_paths=[CSRC_DIR],
            build_directory=BUILD_DIR,
            is_python_module=False,
        )
    except (RuntimeError, OSError) as e:
        raise KernelBuildError(f"building the CUDA kernels failed:\n{e}") from e
    if not isinstance(path, str) or not os.path.exists(path):
        raise KernelBuildError(f"the build produced no library ({path!r})")
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
            _kernels = Kernels(lib, path, time.perf_counter() - start)
        return _kernels
