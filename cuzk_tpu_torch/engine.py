"""Poseidon engine interface — the counterpart of :mod:`cuzk_tpu.engine`,
itself the analog of ``IPoseidonCudaHash``
(cuda/poseidon_interface_cuda.hpp:27-47) with its two implementations: the
plain PyTorch path (:class:`TorchPoseidonEngine`) and the CUDA kernels
(:class:`CudaPoseidonEngine`), plus the coalescing front end over either.

Engines take and return ``[..., 16]`` digit tensors (numpy arrays are
accepted and moved to the engine's device).  Swapping engines and
cross-verifying them is what the interface is for, as in the reference:
:func:`verify_engines_match` holds the kernels against the plain path on
the card over all four ops.
"""

from __future__ import annotations

import abc
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cuzk_tpu_torch import poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda
from cuzk_tpu_torch.utils.device import require_cuda, resolve_device
from cuzk_tpu_torch.utils.errors import ComputationError, ValidationError
from cuzk_tpu_torch.utils.stats import HashingStats, timed

_log = logging.getLogger(__name__)


@dataclass
class PoseidonStats(HashingStats):
    """CudaPoseidonStats analog (poseidon_interface_cuda.hpp:15-21); the
    counterpart of ``cuzk_tpu.engine.PoseidonStats``."""

    batch_count: int = 0


class PoseidonEngine(abc.ABC):
    """Batched Poseidon accelerator interface (poseidon_interface_cuda.hpp);
    the counterpart of ``cuzk_tpu.engine.PoseidonEngine``."""

    def __init__(self):
        self.stats = PoseidonStats()

    @abc.abstractmethod
    def batch_hash_single(self, x) -> torch.Tensor:
        """[B,16] -> [B,16], ds=1."""

    @abc.abstractmethod
    def batch_hash_pairs(self, l, r) -> torch.Tensor:
        """[B,16] x2 -> [B,16], ds=2."""

    @abc.abstractmethod
    def batch_hash_multiple(self, inputs) -> torch.Tensor:
        """[B,n,16] -> [B,16], ds=3."""

    @abc.abstractmethod
    def batch_permutation(self, states) -> torch.Tensor:
        """[B,3,16] -> [B,3,16]."""

    def is_initialized(self) -> bool:
        return True

    def get_optimal_batch_size(self) -> int:
        """The reference derives this from a device probe
        (maxThreadsPerBlock, poseidon_cuda.cu:235-236); the CUDA engine
        derives it from its kernel's launch geometry."""
        return 16384

    def get_max_batch_size(self) -> int:
        return 1 << 24

    def timed_hash_pairs(self, l, r):
        """Hash + record stats (the reference records per-call timings)."""
        out, sec = timed(self.batch_hash_pairs, l, r)
        self.stats.total_hashes += int(l.shape[0])
        self.stats.total_time_s += sec
        self.stats.batch_count += 1
        return out


class TorchPoseidonEngine(PoseidonEngine):
    """Reference path: the plain PyTorch functions of
    :mod:`cuzk_tpu_torch.poseidon` on ``device`` (the card by default; it
    raises :class:`CudaUnavailableError` without one, and runs on the CPU
    for ``device="cpu"``); the counterpart of
    ``cuzk_tpu.engine.JnpPoseidonEngine``."""

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)

    def _on(self, x) -> torch.Tensor:
        return fr.as_digits(x, device=self.device)

    def batch_hash_single(self, x):
        return poseidon.hash_single(self._on(x))

    def batch_hash_pairs(self, l, r):
        return poseidon.hash_pair(self._on(l), self._on(r))

    def batch_hash_multiple(self, inputs):
        return poseidon.hash_multiple(self._on(inputs))

    def batch_permutation(self, states):
        return poseidon.permutation(self._on(states))


class CudaPoseidonEngine(PoseidonEngine):
    """Accelerated path: the CUDA kernels (K1 for hashing, K4 for the raw
    permutation) on one card; the counterpart of
    ``cuzk_tpu.engine.PallasPoseidonEngine``.  It needs a Hopper card and
    raises :class:`CudaUnavailableError` without one."""

    def __init__(self, device=None):
        super().__init__()
        default = require_cuda()
        self.device = default if device is None else torch.device(device)
        if self.device.type != "cuda":
            raise ValidationError(
                f"CudaPoseidonEngine runs on a CUDA device, got {self.device}"
            )

    def _on(self, x) -> torch.Tensor:
        return fr.as_digits(x, device=self.device)

    def batch_hash_single(self, x):
        return poseidon_cuda.hash_single_cuda(self._on(x))

    def batch_hash_pairs(self, l, r):
        return poseidon_cuda.hash_pair_cuda(self._on(l), self._on(r))

    def batch_hash_multiple(self, inputs):
        return poseidon_cuda.hash_multiple_cuda(self._on(inputs))

    def batch_permutation(self, states):
        return poseidon_cuda.permutation_cuda(self._on(states))

    # Packed-wire surface (fr.pack16 [B, 8] words, 32 B/element): the
    # coalescing engine uploads half the digit bytes through it.  Digits
    # must be range-checked < 2^16 by the caller before packing.
    def _words_on(self, p) -> torch.Tensor:
        return fr.words_to_limbs(p).to(self.device)

    def batch_hash_single_packed(self, xp):
        return poseidon_cuda.hash_single_cuda_packed(self._words_on(xp))

    def batch_hash_pairs_packed(self, lp, rp):
        return poseidon_cuda.hash_pair_cuda_packed(
            self._words_on(lp), self._words_on(rp)
        )

    def batch_hash_multiple_packed(self, xp):
        return poseidon_cuda.hash_multiple_cuda_packed(self._words_on(xp))

    def get_optimal_batch_size(self) -> int:
        """Smallest batch that gives every SM its full complement of
        resident K1 threads: the SM count times the threads of
        ``sponge_kernel`` the occupancy API says fit on one SM.  One hash is
        one thread, so a smaller batch leaves SMs idle, and a larger one
        runs in further waves."""
        sms = torch.cuda.get_device_properties(self.device).multi_processor_count
        return sms * poseidon_cuda.sponge_resident_threads(self.device)


class DeferredHashes:
    """Handle for queued hashes; ``get()`` forces the owning engine's flush
    and returns this call's ``[B, 16]`` results.  The counterpart of
    ``cuzk_tpu.engine.DeferredHashes``.

    The flush stores (fused output, offset, count); the per-call slice is
    taken lazily at the first ``get()``, so a flush is one kernel launch and
    no per-call device op.  Each handle not yet ``get()`` keeps the whole
    fused output alive."""

    __slots__ = ("_engine", "_value", "_src")

    def __init__(self, engine: "CoalescingPoseidonEngine"):
        self._engine = engine
        self._value = None
        self._src = None

    @property
    def ready(self) -> bool:
        """True once a flush has produced this call's results."""
        return self._value is not None or self._src is not None

    def get(self) -> torch.Tensor:
        if not self.ready:
            self._engine.flush()
        if self._value is None:
            if self._src is None:  # flush restored the queue on a failure
                raise ComputationError(
                    "deferred hashes were not materialized by flush()"
                )
            out, off, n = self._src
            self._value = out[off : off + n]
            self._src = None
        return self._value


def _host_digits(a) -> np.ndarray:
    """Stage one call's operand as host uint32 digits (a CUDA tensor pays
    one readback here)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.uint32)


class CoalescingPoseidonEngine(PoseidonEngine):
    """Deferred, coalescing front end over another engine: ``async_*`` calls
    enqueue on the host and return :class:`DeferredHashes`; one kernel
    launch per flush serves every queued call of a (kind, width).  The
    counterpart of ``cuzk_tpu.engine.CoalescingPoseidonEngine``.

    It serves the reference's Small and Medium configs (512 x 10K,
    1024 x 100K; benchmark.cpp:213-235), where a 512-hash call alone would
    fill under a tenth of the card's resident threads.  Queues are keyed
    per op kind and width, so every element hashes with its own domain
    separator.

    Inputs are staged as host numpy and uploaded to the inner engine's
    device once per operand per flush: this engine is the front door for
    request-at-a-time callers (verifiers, RPC servers), not a wrapper for
    tensors already on the card (call the inner engine for those).  A flush
    whose digits are all < 2^16 goes over the packed wire (``fr.pack16``,
    half the bytes) when the inner engine has one; a digit >= 2^16 would
    alias under packing, so such a flush takes the full-width path.
    """

    def __init__(self, inner: Optional[PoseidonEngine] = None,
                 flush_elems: int = 65536):
        super().__init__()
        self.inner = inner if inner is not None else CudaPoseidonEngine()
        self.flush_elems = flush_elems
        # queue key -> list of (host arrays..., DeferredHashes)
        self._queues: dict = {}
        self._pending = 0
        #: Last exception of a threshold flush (None after a flush that
        #: succeeded), so a persistent failure is observable before the
        #: caller's explicit flush()/get().
        self.last_flush_error: Optional[BaseException] = None

    # -- async surface ----------------------------------------------------
    def _enqueue(self, key, arrays) -> DeferredHashes:
        d = DeferredHashes(self)
        self._queues.setdefault(key, []).append(
            tuple(_host_digits(a) for a in arrays) + (d,)
        )
        self._pending += int(arrays[0].shape[0])
        if self._pending >= self.flush_elems:
            # The threshold flush is an optimization, so its failure is
            # deferred: raising here would lose the caller's handle before
            # they receive it.  flush() restored the queue, so the failure
            # surfaces at the explicit flush()/get(); it is logged once and
            # kept on last_flush_error meanwhile.
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 — deferred, see above
                if self.last_flush_error is None:
                    _log.warning(
                        "deferred threshold-flush failure (queue kept; "
                        "will surface at the next explicit flush/get): %r",
                        e,
                    )
                self.last_flush_error = e
        return d

    def async_hash_single(self, x) -> DeferredHashes:
        return self._enqueue("single", (x,))

    def async_hash_pairs(self, l, r) -> DeferredHashes:
        return self._enqueue("pairs", (l, r))

    def async_hash_multiple(self, inputs) -> DeferredHashes:
        return self._enqueue(("multiple", int(inputs.shape[1])), (inputs,))

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(host).to(getattr(self.inner, "device", "cpu"))

    def flush(self) -> None:
        """One inner-engine call per (kind, width) with queued work.

        A failed call restores its queue before the exception propagates,
        so queued :class:`DeferredHashes` are never orphaned: a later
        ``get()`` retries the call."""
        for key in list(self._queues):
            calls = self._queues.pop(key)
            try:
                kind = key if isinstance(key, str) else key[0]
                cols = list(zip(*calls))
                stacked = [np.concatenate(c, axis=0) for c in cols[:-1]]
                packed = hasattr(self.inner, "batch_hash_single_packed") and all(
                    int(s.max(initial=0)) >> fr.DIGIT_BITS == 0 for s in stacked
                )
                if packed:
                    # int32 bit patterns of the pack16 words: the kernels'
                    # limbs, uploaded as they are.
                    operands = [
                        self._upload(fr.pack16_host(s).view(np.int32))
                        for s in stacked
                    ]
                else:
                    operands = [self._upload(s.astype(np.int64)) for s in stacked]
                fn = getattr(
                    self.inner, f"batch_hash_{kind}{'_packed' if packed else ''}"
                )
                out = fn(*operands)
            except BaseException:
                self._queues[key] = calls  # keep the work; get() can retry
                raise
            self.last_flush_error = None
            off = 0
            for arrs0, d in zip(cols[0], cols[-1]):
                n = arrs0.shape[0]
                d._src = (out, off, n)  # sliced lazily at first get()
                off += n
            self._pending -= off
            self.stats.total_hashes += off
            self.stats.batch_count += 1

    # -- synchronous PoseidonEngine surface (enqueue + immediate force) ----
    def batch_hash_single(self, x):
        return self.async_hash_single(x).get()

    def batch_hash_pairs(self, l, r):
        return self.async_hash_pairs(l, r).get()

    def batch_hash_multiple(self, inputs):
        return self.async_hash_multiple(inputs).get()

    def batch_permutation(self, states):
        return self.inner.batch_permutation(states)


def verify_engines_match(batch: int = 64, seed: int = 7, device=None) -> bool:
    """Cross-implementation gate (verify_cuda_implementations_match,
    poseidon_cuda_benchmarks.cpp:137-259): the plain engine and the CUDA
    engine on the same card, on the same seeded inputs, elementwise equal
    over every op — single and pair hashing, ``hash_multiple`` and the raw
    permutation.  Needs a Hopper card."""
    b = CudaPoseidonEngine(device)
    a = TorchPoseidonEngine(b.device)
    rng = np.random.default_rng(seed)
    l = rng.integers(0, 1 << 16, (batch, 16), np.uint32)
    r = rng.integers(0, 1 << 16, (batch, 16), np.uint32)
    groups = rng.integers(0, 1 << 16, (batch, 5, 16), np.uint32)
    states = rng.integers(0, 1 << 16, (batch, 3, 16), np.uint32)
    return (
        torch.equal(a.batch_hash_pairs(l, r), b.batch_hash_pairs(l, r))
        and torch.equal(a.batch_hash_single(l), b.batch_hash_single(l))
        and torch.equal(
            a.batch_hash_multiple(groups), b.batch_hash_multiple(groups)
        )
        and torch.equal(
            a.batch_permutation(states), b.batch_permutation(states)
        )
    )
