"""The port's engines against the JAX package's, on the CPU.

The counterpart of ``tests/test_engine.py`` (all but
``test_batch_field_arithmetic``: ``field/batch.py`` is not ported), with
``TorchPoseidonEngine`` as the inner engine where the JAX tests use
``JnpPoseidonEngine``, and a small subclass of it with the packed surface
where they use ``PallasPoseidonEngine``'s.  Inputs are made from a seed
with numpy and fed to both packages; JAX batches stay at 8 or fewer (one
``cuzk_tpu.poseidon._bucket``).  Tolerance: none (integer-exact).
"""

import numpy as np
import pytest
import torch

from cuzk_tpu import engine as jengine
from cuzk_tpu import oracle
from cuzk_tpu.field import fr as jfr
from cuzk_tpu_torch import engine
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda
from cuzk_tpu_torch.utils.errors import ComputationError

CPU = "cpu"  # the CPU tests ask for the plain path by name


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_rng = np.random.default_rng(1234)


def _digits(n, w=None):
    shape = (n, 16) if w is None else (n, w, 16)
    return _rng.integers(0, 1 << 16, shape, np.uint32)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_torch_engine_matches_jnp_engine():
    """The counterpart of test_engines_cross_verify off the card: the plain
    engine equals ``cuzk_tpu``'s jnp engine over all four ops."""
    ours, theirs = engine.TorchPoseidonEngine(device=CPU), jengine.JnpPoseidonEngine()
    l, r = _digits(8), _digits(8)
    groups = _digits(8, 5)
    states = _rng.integers(0, 1 << 16, (8, 3, 16), np.uint32)
    _equal(ours.batch_hash_pairs(l, r), theirs.batch_hash_pairs(l, r))
    _equal(ours.batch_hash_single(l), theirs.batch_hash_single(l))
    _equal(ours.batch_hash_multiple(groups), theirs.batch_hash_multiple(groups))
    _equal(ours.batch_permutation(states), theirs.batch_permutation(states))


def test_torch_engine_permutation_golden():
    e = engine.TorchPoseidonEngine(device=CPU)
    st = jfr.ints_to_array([1, 2, 3]).reshape(1, 3, 16)
    got = fr.array_to_ints(e.batch_permutation(st))
    assert got == oracle.permutation([1, 2, 3])


def test_engine_stats_accumulate():
    e = engine.TorchPoseidonEngine(device=CPU)
    l = fr.ints_to_array([1, 2, 3, 4])
    r = fr.ints_to_array([5, 6, 7, 8])
    e.timed_hash_pairs(l, r)
    assert e.stats.total_hashes == 4
    assert e.stats.batch_count == 1
    assert e.stats.hashes_per_second > 0 and e.stats.ns_per_hash > 0
    assert e.is_initialized()
    assert e.get_optimal_batch_size() <= e.get_max_batch_size()


# ---------------------------------------------------------------------------
# CoalescingPoseidonEngine: per-call slicing, mixed (kind, width) queues,
# the flush threshold, get() semantics and the failed-flush recovery.
# ---------------------------------------------------------------------------

def test_coalescing_interleaved_mixed_calls_bit_exact():
    inner = engine.TorchPoseidonEngine(device=CPU)
    ce = engine.CoalescingPoseidonEngine(inner=engine.TorchPoseidonEngine(device=CPU))
    calls = {}  # queue key -> [(deferred, inputs)]
    for n in (1, 3, 7):
        x = _digits(n)
        calls.setdefault("single", []).append((ce.async_hash_single(x), (x,)))
        l, r = _digits(n), _digits(n)
        calls.setdefault("pairs", []).append((ce.async_hash_pairs(l, r), (l, r)))
        for w in (2, 5, 9):
            g = _digits(n, w)
            calls.setdefault(w, []).append((ce.async_hash_multiple(g), (g,)))
    assert len(ce._queues) == 5  # single, pairs, multiple x {2,5,9}
    for key, queued in calls.items():
        # Hashing is elementwise, so one direct call over the queue's
        # concatenated inputs gives every call's direct result.
        cat = [np.concatenate(c) for c in zip(*(args for _, args in queued))]
        if key == "single":
            want = inner.batch_hash_single(*cat)
        elif key == "pairs":
            want = inner.batch_hash_pairs(*cat)
        else:
            want = inner.batch_hash_multiple(*cat)
        off = 0
        for d, args in queued:
            n = args[0].shape[0]
            assert torch.equal(d.get(), want[off : off + n])
            off += n
    assert ce._pending == 0 and not ce._queues


def test_coalescing_sync_surface_matches_inner():
    inner = engine.TorchPoseidonEngine(device=CPU)
    ce = engine.CoalescingPoseidonEngine(inner=engine.TorchPoseidonEngine(device=CPU))
    x = _digits(6)
    assert torch.equal(ce.batch_hash_single(x), inner.batch_hash_single(x))
    l, r = _digits(4), _digits(4)
    assert torch.equal(ce.batch_hash_pairs(l, r), inner.batch_hash_pairs(l, r))
    g = _digits(5, 3)
    assert torch.equal(ce.batch_hash_multiple(g), inner.batch_hash_multiple(g))
    st = _rng.integers(0, 1 << 16, (4, 3, 16), np.uint32)
    assert torch.equal(ce.batch_permutation(st), inner.batch_permutation(st))


class _PackedTorchEngine(engine.TorchPoseidonEngine):
    """The plain engine with the CUDA engine's packed surface, through the
    packed entry points on CPU tensors; counts its packed calls."""

    def __init__(self):
        super().__init__(device=CPU)
        self.packed_calls = 0

    def batch_hash_single_packed(self, xp):
        self.packed_calls += 1
        return poseidon_cuda.hash_single_cuda_packed(xp)

    def batch_hash_pairs_packed(self, lp, rp):
        self.packed_calls += 1
        return poseidon_cuda.hash_pair_cuda_packed(lp, rp)

    def batch_hash_multiple_packed(self, xp):
        self.packed_calls += 1
        return poseidon_cuda.hash_multiple_cuda_packed(xp)


def test_coalescing_packed_gate_non_canonical_digits():
    # A flush with a digit >= 2^16 must take the full-width path (packing
    # would alias d and d + 2^16) and still produce bit-exact results.
    inner = _PackedTorchEngine()
    ce = engine.CoalescingPoseidonEngine(inner=inner)
    x = _digits(4)
    x[2, 3] = (1 << 16) + 7  # non-canonical digit
    d = ce.async_hash_single(x)
    assert torch.equal(d.get(), engine.TorchPoseidonEngine(device=CPU).batch_hash_single(x))
    assert inner.packed_calls == 0
    # A canonical flush takes the packed path and agrees too.
    l, r = _digits(6), _digits(6)
    d2 = ce.async_hash_pairs(l, r)
    assert torch.equal(d2.get(), engine.TorchPoseidonEngine(device=CPU).batch_hash_pairs(l, r))
    assert inner.packed_calls == 1


def test_coalescing_get_before_and_after_flush():
    ce = engine.CoalescingPoseidonEngine(inner=engine.TorchPoseidonEngine(device=CPU))
    x = _digits(4)
    d1 = ce.async_hash_single(x)
    v1 = d1.get()  # get() forces the flush
    d2 = ce.async_hash_single(x)
    ce.flush()  # explicit flush first
    v2 = d2.get()
    assert torch.equal(v1, v2)
    # repeated get() returns the already-materialized value
    assert d1.get() is v1


def test_coalescing_flush_threshold_triggers():
    ce = engine.CoalescingPoseidonEngine(
        inner=engine.TorchPoseidonEngine(device=CPU), flush_elems=8
    )
    d1 = ce.async_hash_single(_digits(5))
    assert not d1.ready and ce._pending == 5
    d2 = ce.async_hash_single(_digits(5))  # 10 >= 8: auto-flush
    assert d1.ready and d2.ready
    assert ce._pending == 0 and not ce._queues


class _FlakyEngine(engine.TorchPoseidonEngine):
    """Raises on the first batch_hash_single call, then recovers."""

    def __init__(self):
        super().__init__(device=CPU)
        self.fail_next = True

    def batch_hash_single(self, x):
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("injected dispatch failure")
        return super().batch_hash_single(x)


def test_coalescing_flush_failure_restores_queue():
    """A failed flush restores its queue, so get() retries the call
    instead of orphaning the queued handles."""
    flaky = _FlakyEngine()
    ce = engine.CoalescingPoseidonEngine(inner=flaky)
    x = _digits(3)
    d = ce.async_hash_single(x)
    with pytest.raises(RuntimeError, match="injected"):
        ce.flush()
    assert ce._queues  # the work is still queued
    got = d.get()  # retry succeeds
    assert torch.equal(got, engine.TorchPoseidonEngine(device=CPU).batch_hash_single(x))
    assert not ce._queues


def test_coalescing_threshold_flush_failure_is_deferred(caplog):
    """A failure of the threshold flush does not escape async_hash_*; it
    is logged once, kept on last_flush_error and surfaces at the explicit
    flush()/get(), and a successful flush clears it."""
    flaky = _FlakyEngine()
    ce = engine.CoalescingPoseidonEngine(inner=flaky, flush_elems=2)
    x = _digits(3)  # crosses the threshold -> inline flush fails deferred
    with caplog.at_level("WARNING", logger=engine.__name__):
        d = ce.async_hash_single(x)
    assert ce._queues  # work retained
    assert isinstance(ce.last_flush_error, RuntimeError)
    assert sum("deferred threshold-flush" in m for m in caplog.messages) == 1
    got = d.get()  # retry on get() succeeds
    assert torch.equal(got, engine.TorchPoseidonEngine(device=CPU).batch_hash_single(x))
    assert ce.last_flush_error is None  # cleared by the successful flush


def test_coalescing_stats_and_empty_flush():
    ce = engine.CoalescingPoseidonEngine(inner=engine.TorchPoseidonEngine(device=CPU))
    ce.flush()  # empty: no-op
    assert ce.stats.batch_count == 0
    ce.batch_hash_single(_digits(2))
    ce.batch_hash_pairs(_digits(2), _digits(2))
    assert ce.stats.total_hashes == 4
    assert ce.stats.batch_count == 2


def test_deferred_get_raises_computation_error_if_unmaterialized():
    ce = engine.CoalescingPoseidonEngine(inner=engine.TorchPoseidonEngine(device=CPU))
    d = engine.DeferredHashes(ce)  # never enqueued: flush cannot fill it
    with pytest.raises(ComputationError):
        d.get()
