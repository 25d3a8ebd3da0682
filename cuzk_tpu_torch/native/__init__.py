"""The port's native (C++) host code: the exact grouper of the deduplicated
verify's schedule, and the native oracle.

The counterpart of ``cuzk_tpu.native``, in two libraries:

- ``scheduler.cpp`` partitions rows (and int32 triples) by exact equality
  with an open-addressing hash table that byte-compares on every probe.
  Group ids are first-occurrence ranks, so :func:`group_rows` and
  :func:`group_triples` return what ``cuzk_tpu.native``'s functions of the
  same names return.
- ``oracle.cpp`` is an independent 4 x 64-limb implementation of the
  reference semantics (wrap-at-2^256 adds, the truncated k-fold reduction
  with the CPU k, the t=3 sponge, n-ary Merkle roots): the third
  implementation of the differential checks, beside the Python-int
  :mod:`cuzk_tpu_torch.oracle` and the plain PyTorch and CUDA paths.  Its
  int-level wrappers (:func:`add` ... :func:`merkle_root`) have the names
  and signatures of ``cuzk_tpu.native``'s.

Each library is compiled by ``g++`` at its first call into
``cuzk_tpu_torch/_build/`` (a directory git ignores), under a name that
carries a digest of its source, and bound with ctypes; importing this
module builds nothing.  A failed build raises
:class:`~cuzk_tpu_torch.utils.errors.KernelBuildError` with the compiler's
output: there is no other route to fall back to.  :func:`available` says
whether a C++ compiler is there at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cuzk_tpu_torch.utils.errors import KernelBuildError, ValidationError

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "scheduler.cpp")
ORACLE_SOURCE = os.path.join(_DIR, "oracle.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_oracle_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _build(source: str, stem: str) -> str:
    """Compile ``source`` into :data:`BUILD_DIR` as ``lib<stem>_<digest>.so``
    unless a library built from the current source is there; returns its
    path.  The name carries a digest of the source, so a stale library
    never loads, and the compiler writes a private file that is renamed
    into place, so concurrent builds in several processes cannot load a
    partial one."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        out = subprocess.run(
            [CXX, *CXX_FLAGS, source, "-o", tmp],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise KernelBuildError(f"running {CXX} failed: {e}") from e
    if out.returncode != 0:
        raise KernelBuildError(
            f"building {source} failed:\n{out.stdout}{out.stderr}"
        )
    os.replace(tmp, path)
    return path


def build() -> str:
    """Build the scheduler library (:data:`SOURCE`); returns its path."""
    return _build(SOURCE, "cuzkscheduler")


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


# ---------------------------------------------------------------------------
# The native oracle (oracle.cpp)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def build_oracle() -> str:
    """Build the native oracle library (:data:`ORACLE_SOURCE`); returns its
    path."""
    return _build(ORACLE_SOURCE, "cuzkoracle")


def load_oracle() -> ctypes.CDLL:
    """The native oracle library, built and loaded at the first call."""
    global _oracle_lib
    with _lock:
        if _oracle_lib is None:
            path = build_oracle()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"loading {path} failed: {e}") from e
            u64p = ctypes.POINTER(ctypes.c_uint64)
            size = ctypes.c_size_t
            for name, argtypes in {
                "cuzk_add": [u64p, u64p, u64p],
                "cuzk_sub": [u64p, u64p, u64p],
                "cuzk_mul": [u64p, u64p, u64p],
                "cuzk_red": [u64p, u64p],
                "cuzk_power5": [u64p, u64p],
                "cuzk_permutation": [u64p],
                "cuzk_hash_single": [u64p, u64p],
                "cuzk_hash_pair": [u64p, u64p, u64p],
                "cuzk_hash_multiple": [u64p, size, u64p],
                "cuzk_batch_hash_pairs": [u64p, u64p, u64p, size],
                "cuzk_merkle_root": [u64p, size, size, u64p],
            }.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _oracle_lib = lib
        return _oracle_lib


def available() -> bool:
    """Whether the native oracle can be built here: False when the C++
    compiler is missing.  With a compiler present it builds and loads the
    library, and a failure raises :class:`KernelBuildError`, as every
    other call of the oracle does: nothing here hides a broken build."""
    if shutil.which(CXX) is None:
        return False
    load_oracle()
    return True


def _buf(ints: Sequence[int]) -> "ctypes.Array":
    """Elements as little-endian u64 limb quadruples; each must lie in
    [0, 2^256)."""
    flat: List[int] = []
    for x in ints:
        x = int(x)
        if not 0 <= x < 1 << 256:
            raise ValidationError(f"{x} is not a 256-bit value")
        flat.extend((x >> (64 * i)) & _MASK64 for i in range(4))
    return (ctypes.c_uint64 * len(flat))(*flat)


def _out(n_elems: int) -> "ctypes.Array":
    return (ctypes.c_uint64 * (4 * n_elems))()


def _read(buf, n_elems: int) -> List[int]:
    return [sum(int(v) << (64 * i) for i, v in enumerate(buf[4 * e:4 * e + 4]))
            for e in range(n_elems)]


def _call(name: str, *args) -> None:
    getattr(load_oracle(), name)(*args)


def add(a: int, b: int) -> int:
    o = _out(1)
    _call("cuzk_add", _buf([a]), _buf([b]), o)
    return _read(o, 1)[0]


def sub(a: int, b: int) -> int:
    o = _out(1)
    _call("cuzk_sub", _buf([a]), _buf([b]), o)
    return _read(o, 1)[0]


def mul(a: int, b: int) -> int:
    o = _out(1)
    _call("cuzk_mul", _buf([a]), _buf([b]), o)
    return _read(o, 1)[0]


def red(a: int) -> int:
    o = _out(1)
    _call("cuzk_red", _buf([a]), o)
    return _read(o, 1)[0]


def power5(a: int) -> int:
    o = _out(1)
    _call("cuzk_power5", _buf([a]), o)
    return _read(o, 1)[0]


def permutation(state: Sequence[int]) -> List[int]:
    state = list(state)
    if len(state) != 3:
        raise ValidationError(f"a state has 3 elements, got {len(state)}")
    buf = _buf(state)
    _call("cuzk_permutation", buf)
    return _read(buf, 3)


def hash_single(x: int) -> int:
    o = _out(1)
    _call("cuzk_hash_single", _buf([x]), o)
    return _read(o, 1)[0]


def hash_pair(l: int, r: int) -> int:
    o = _out(1)
    _call("cuzk_hash_pair", _buf([l]), _buf([r]), o)
    return _read(o, 1)[0]


def hash_multiple(inputs: Sequence[int]) -> int:
    inputs = list(inputs)
    o = _out(1)
    _call("cuzk_hash_multiple", _buf(inputs), len(inputs), o)
    return _read(o, 1)[0]


def batch_hash_pairs(ls: Sequence[int], rs: Sequence[int]) -> List[int]:
    ls, rs = list(ls), list(rs)
    if len(ls) != len(rs):
        raise ValidationError(f"{len(ls)} lefts and {len(rs)} rights")
    o = _out(len(ls))
    _call("cuzk_batch_hash_pairs", _buf(ls), _buf(rs), o, len(ls))
    return _read(o, len(ls))


def merkle_root(leaves: Sequence[int], arity: int) -> int:
    """The root; an empty input, or an arity outside [2, 8], gives the
    empty hash of ``arity`` (oracle.cpp's ``cuzk_merkle_root``)."""
    leaves = list(leaves)
    o = _out(1)
    _call("cuzk_merkle_root", _buf(leaves), len(leaves), arity, o)
    return _read(o, 1)[0]
