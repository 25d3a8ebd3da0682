"""Exact grouping for the deduplicated verify's host schedule, in C++.

The counterpart of the scheduler half of ``cuzk_tpu.native``:
``scheduler.cpp`` partitions rows (and int32 triples) by exact equality
with an open-addressing hash table that byte-compares on every probe.
Group ids are first-occurrence ranks, so :func:`group_rows` and
:func:`group_triples` return what ``cuzk_tpu.native``'s functions of the
same names return.

The library is compiled with ``g++ -O3`` at the first call into
``cuzk_tpu_torch/_build/`` (a directory git ignores) and bound with ctypes;
importing this module builds nothing.  A failed build raises
:class:`~cuzk_tpu_torch.utils.errors.KernelBuildError` with the compiler's
output: there is no other grouping route to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from cuzk_tpu_torch.utils.errors import KernelBuildError, ValidationError

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "scheduler.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> str:
    """Compile the library into :data:`BUILD_DIR` unless a library built
    from the current source is there; returns its path.  The name carries
    a digest of the source, so a stale library never loads, and the
    compiler writes a private file that is renamed into place, so
    concurrent builds in several processes cannot load a partial one."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"libcuzkscheduler_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        out = subprocess.run(
            ["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise KernelBuildError(f"running g++ failed: {e}") from e
    if out.returncode != 0:
        raise KernelBuildError(
            f"building {SOURCE} failed:\n{out.stdout}{out.stderr}"
        )
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The scheduler library, built and loaded at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"loading {path} failed: {e}") from e
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            lib.cuzk_group_rows.argtypes = [u8p, i64, i64, i64, i32p, i32p]
            lib.cuzk_group_rows.restype = i64
            lib.cuzk_group_triples.argtypes = [i32p, i32p, i32p, i64, i32p,
                                               i32p]
            lib.cuzk_group_triples.restype = i64
            _lib = lib
        return _lib


def _check_count(k: int) -> None:
    if k >= 1 << 31:
        raise ValidationError(f"at most 2^31 - 1 rows can be grouped, got {k}")


def group_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact byte-equality partition of ``rows`` (``[k, w]`` numpy array;
    last axis contiguous, row width a multiple of 8 bytes).  Returns
    ``(first, inv)`` int32 arrays: the first-occurrence row index of each
    group, and the group id of each row."""
    k = int(rows.shape[0])
    _check_count(k)
    wbytes = int(rows.shape[1]) * rows.itemsize
    if rows.strides[1] != rows.itemsize or wbytes % 8 or rows.strides[0] <= 0:
        raise ValidationError("rows must have a contiguous 8-byte-multiple row")
    first = np.empty(k, np.int32)
    inv = np.empty(k, np.int32)
    lib = load()
    i32p = ctypes.POINTER(ctypes.c_int32)
    u = lib.cuzk_group_rows(
        ctypes.cast(rows.ctypes.data, ctypes.POINTER(ctypes.c_uint8)), k,
        int(rows.strides[0]), wbytes,
        first.ctypes.data_as(i32p), inv.ctypes.data_as(i32p),
    )
    return first[:u].copy(), inv


def group_triples(a, b, c) -> Tuple[np.ndarray, np.ndarray]:
    """Exact partition of the ``(a[i], b[i], c[i])`` int32 triples (the
    suffix key: parent-suffix group, sibling-row group, position).  Same
    outputs as :func:`group_rows`."""
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    c = np.ascontiguousarray(c, np.int32)
    k = int(a.shape[0])
    _check_count(k)
    if b.shape != (k,) or c.shape != (k,):
        raise ValidationError("group_triples takes three [k] arrays")
    first = np.empty(k, np.int32)
    inv = np.empty(k, np.int32)
    lib = load()
    i32p = ctypes.POINTER(ctypes.c_int32)
    u = lib.cuzk_group_triples(
        a.ctypes.data_as(i32p), b.ctypes.data_as(i32p),
        c.ctypes.data_as(i32p), k,
        first.ctypes.data_as(i32p), inv.ctypes.data_as(i32p),
    )
    return first[:u].copy(), inv
