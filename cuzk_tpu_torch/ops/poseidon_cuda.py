"""Wrappers of the CUDA Poseidon kernels, each beside its plain version.

The counterpart of the wrapper half of ``cuzk_tpu/ops/poseidon_pallas.py``.
Every public function takes ``[..., 16]`` digits, as the JAX package
does, and runs where its tensors lie:

- host data (numpy arrays, lists) goes to the card
  (:func:`~cuzk_tpu_torch.utils.device.resolve_device`; without a card it
  raises :class:`CudaUnavailableError`);
- torch tensors on the CPU take the plain PyTorch version
  (``cuzk_tpu_torch.poseidon``): the CPU runs only when asked for;
- on any other device it builds the kernels (at the first call), checks
  device, dtype, shape and contiguity, launches on PyTorch's current
  stream and raises on a launch error.  K1 reads digits itself
  (:func:`sponge_digits`) and returns limbs; K3 reads digits itself
  (:func:`verify_digits`) and returns the verdicts; K4 and the per-op
  check kernel read and write the digits themselves.  There is no
  fallback: without a Hopper card, or when the build fails, it raises.

K1 and K3 run G lanes of a warp per state: one thread per state (G = 1),
on the permutation body K4 runs, or three lanes holding one state element
each (G = 3, ``csrc/poseidon.cuh``).  :func:`choose_lanes` picks 3 for
small launches and 1 for large ones, from the crossover ``chip_smoke.py``'s
sweep measures; ``lanes=`` forces G, for the tests and the sweep.

The TPU path's batch and width bucketing (``_bucket_tiles``,
``_bucket_batch``, ``PAD_WIDTH``, ``_SCALAR_CACHE``) existed to bound
Mosaic compile counts; a CUDA kernel takes the batch and width at run time,
so none of it is here.

K3, K4 and the check kernel read only the public digits.  K1 alone also
reads limbs: :func:`sponge_limbs` takes 8 x u32 limb tensors on the card
and runs on no other device; :mod:`cuzk_tpu_torch.merkle` calls it for the
tree build's upper levels, whose inputs are the limbs the level below
wrote, after its own device dispatch.  :func:`sponge_digits` is K1 on
``[B, n, 16]`` int64 digits, read by value in the kernel: the first level
of a build and every digit entry point (``hash_*_cuda``) go through it, so
no leaf is converted.  :func:`verify_digits` is K3 on the proofs' int64
digits: every proof verification on the card (``merkle.verify_proofs``)
goes through it.

The ``*_packed`` entry points take ``fr.pack16`` words, two digits per u32
word: on the card those words are K1's limbs as they stand, so they go to
the kernel with no digit round trip.

``launch_counts`` counts each kernel's launches, so that a run can show
which kernels its main path went through.  K1 and K3's launchers are the
spans ``cuzk.k1`` and ``cuzk.k3`` (:mod:`cuzk_tpu_torch.utils.trace`), and
count each launch under the G it took, ``k1.lanes.<G>`` and
``k3.lanes.<G>``, while a profiler session records; a launch of K1's
digit form also counts ``k1.input.digits``.
"""

from __future__ import annotations

import ctypes

import torch

from cuzk_tpu_torch import constants, poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import _build
from cuzk_tpu_torch.utils import trace
from cuzk_tpu_torch.utils.device import resolve_device
from cuzk_tpu_torch.utils.errors import KernelLaunchError, ValidationError

ND = fr.NDIGITS
NL = fr.NLIMBS
# The G each of K1 and K3 is built for: one thread per state, or 3 lanes
# holding one element each (a group of four threads per state,
# csrc/poseidon.cuh).
LANES = (1, 3)

launch_counts = {"sponge": 0, "verify": 0, "permutation": 0, "fr_op": 0}

# Op codes of the per-op check kernel (csrc/poseidon_kernels.cu::FrOp),
# each with its plain version; _BINARY_FR_OPS read a second operand.
FR_OPS = {
    "mul": (0, fr.mul),
    "square": (1, fr.square),
    "power5": (2, fr.power5),
    "add_wrap_red": (3, fr.add),
    "add_rr": (4, fr.add_rr),
    "mul_small": (5, fr.mul_small),
    "reduce_wide": (6, fr.reduce_wide),
    "red": (7, fr.red),
    "mul_small_rr": (8, fr.mul_small),  # reduced operand, c <= 26
    "sub": (9, fr.sub),
}
_BINARY_FR_OPS = ("mul", "add_wrap_red", "add_rr", "sub")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_limbs(t: torch.Tensor, name: str, ndim: int,
                 dtype: torch.dtype = torch.int32) -> None:
    if not t.is_cuda:
        raise ValidationError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        form = "int32 limbs" if dtype == torch.int32 else "int64 digits"
        raise ValidationError(f"{name} must be {form}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValidationError(f"{name} must have {ndim} dims, got {t.shape}")
    if not t.is_contiguous():
        raise ValidationError(f"{name} must be contiguous")


def _launch(kernels: _build.Kernels, fn, device: torch.device, *args) -> None:
    """Call one C launcher on ``device`` and PyTorch's current stream;
    raise if the launch returned an error."""
    kernels.ensure_round_constants(device.index)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        raise KernelLaunchError(
            f"{fn.__name__} failed: {kernels.error_string(code)}"
        )


def _on_device(x, device=None) -> torch.Tensor:
    """``x`` as int64 digits on the device it should run on (see the
    module docstring)."""
    return fr.as_digits(x, device=resolve_device(device, x))


# ---------------------------------------------------------------------------
# Lanes per state
# ---------------------------------------------------------------------------

# The crossover of the lanes sweep (chip_smoke.py phase 14, NVIDIA H100
# 80GB HBM3 at 700 W), one thread per state on K4's permutation body: the
# element split (3 lanes) is faster up to 4,096 sponge rows (of 2, 4 or 8
# inputs) and 4,000 proofs, and slower from 4,608 rows and 4,250 proofs
# on, where its four threads per state make the launch issue-bound.  A wave
# is 101,376 sponge states and 84,480 proofs, so the split stops at a
# twentieth of one: 5,068 rows, 4,224 proofs.
SPLIT_LANES = 3
SPLIT_FRACTION = 20


def choose_lanes(batch: int, resident: int) -> int:
    """G for a launch of ``batch`` states on a card that holds ``resident``
    states at one thread each: the element split (3 lanes) up to a
    twentieth of a wave, where one state's latency bounds the launch; one
    thread per state above it, where the issue rate does.  A pure function,
    so the choice can be tested."""
    return SPLIT_LANES if batch * SPLIT_FRACTION <= resident else 1


_KERNEL_IDS = {"sponge": 0, "verify": 1}
_resident_cache = {}


def resident_states(device: torch.device, kernel: str = "sponge",
                    lanes: int = 1) -> int:
    """States of ``kernel`` (``"sponge"`` or ``"verify"``) at ``lanes``
    lanes each that the whole card ``device`` holds resident: the SM count
    times the occupancy API's count for one SM.  Cached per device."""
    key = (device.index, kernel, lanes)
    if key not in _resident_cache:
        kernels = _build.kernels()
        states = ctypes.c_int(0)
        with torch.cuda.device(device):
            code = kernels.lib.cuzk_resident_states(
                _KERNEL_IDS[kernel], lanes, ctypes.byref(states))
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        if code != 0:
            raise KernelLaunchError(
                f"occupancy query failed: {kernels.error_string(code)}"
            )
        _resident_cache[key] = states.value * sms
    return _resident_cache[key]


def _lanes(lanes, batch: int, device: torch.device, kernel: str) -> int:
    if lanes is None:
        return choose_lanes(batch, resident_states(device, kernel))
    if lanes not in LANES:
        raise ValidationError(f"lanes must be one of {LANES}, got {lanes}")
    return lanes


# ---------------------------------------------------------------------------
# K1: the sponge
# ---------------------------------------------------------------------------

def _k1(x: torch.Tensor, ds: int, lanes, digits: bool) -> torch.Tensor:
    """K1 on ``x [B, n, 8]`` int32 limbs or ``[B, n, 16]`` int64 digits ->
    ``[B, 8]`` int32 limbs."""
    with trace.span("k1"):
        kernels = _build.kernels()
        dtype, width = (torch.int64, ND) if digits else (torch.int32, NL)
        _check_limbs(x, "inputs", 3, dtype)
        b, n, w = x.shape
        if w != width:
            raise ValidationError(
                f"inputs must be [B, n, {width}] words, got {x.shape}")
        out = torch.empty((b, NL), dtype=torch.int32, device=x.device)
        if b == 0 or n == 0:
            # The empty input returns 0 with no permutation (SURVEY.md B.4).
            return out.zero_()
        g = _lanes(lanes, b, x.device, "sponge")
        entry = kernels.lib.cuzk_sponge_digits if digits else kernels.lib.cuzk_sponge
        _launch(kernels, entry, x.device, x.data_ptr(), out.data_ptr(), b, n,
                ds, g)
        launch_counts["sponge"] += 1
        trace.count(f"k1.lanes.{g}")
        if digits:
            trace.count("k1.input.digits")
        return out


def sponge_limbs(x: torch.Tensor, ds: int, lanes=None) -> torch.Tensor:
    """K1 on limbs: ``x [B, n, 8]`` int32 on the card -> ``[B, 8]`` int32,
    the sponge with domain separator ``ds`` over each row's n inputs.
    ``lanes`` forces G (one of :data:`LANES`); by default
    :func:`choose_lanes` picks it."""
    return _k1(x, ds, lanes, digits=False)


def sponge_digits(x: torch.Tensor, ds: int, lanes=None) -> torch.Tensor:
    """K1 on digits: ``x [B, n, 16]`` int64 on the card -> ``[B, 8]`` int32
    limbs, equal to ``sponge_limbs(fr.digits_to_limbs(x), ds)``: the kernel
    reads each input by value, as :func:`fr.digits_to_limbs` does, so a
    digit d + 2^16 keeps its meaning and nothing is converted before the
    launch.  ``lanes`` as in :func:`sponge_limbs`."""
    return _k1(x, ds, lanes, digits=True)


def _sponge(inputs, ds: int) -> torch.Tensor:
    """``[..., n, 16]`` digits -> ``[..., 16]``: the plain sponge on the CPU,
    K1 on the digits elsewhere."""
    if inputs.device.type == "cpu":
        return poseidon.sponge(inputs, ds)
    _build.kernels()
    batch, n = inputs.shape[:-2], inputs.shape[-2]
    if n == 0:
        # The empty input returns 0 with no permutation (SURVEY.md B.4).
        return fr.zeros(batch, device=inputs.device)
    out = sponge_digits(inputs.reshape((-1, n, ND)).contiguous(), ds)
    return fr.limbs_to_digits(out).reshape(batch + (ND,))


def hash_single_cuda(x) -> torch.Tensor:
    """Batched single-input hash, ds=1: ``[..., 16] -> [..., 16]``."""
    return _sponge(_on_device(x)[..., None, :], poseidon.DS_SINGLE)


def hash_pair_cuda(left, right) -> torch.Tensor:
    """Batched pair hash, ds=2: two ``[..., 16]`` -> ``[..., 16]``."""
    device = resolve_device(None, left, right)
    left, right = torch.broadcast_tensors(_on_device(left, device),
                                          _on_device(right, device))
    return _sponge(torch.stack([left, right], dim=-2), poseidon.DS_PAIR)


def hash_multiple_cuda(inputs) -> torch.Tensor:
    """Batched n-input hash, ds=3: ``[..., n, 16] -> [..., 16]``, any n
    (n = 0 gives zeros)."""
    return _sponge(_on_device(inputs), poseidon.DS_MULTIPLE)


def sponge_resident_threads(device: torch.device) -> int:
    """Threads of K1 at one thread per state resident on one SM of
    ``device``, from the CUDA occupancy API."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return resident_states(device, "sponge") // sms


# ---------------------------------------------------------------------------
# K1 on packed words
# ---------------------------------------------------------------------------

def _sponge_packed(words: torch.Tensor, ds: int) -> torch.Tensor:
    """``[..., n, 8]`` int32 pack16 words -> ``[..., 16]`` digits: the plain
    sponge over the unpacked digits on the CPU, K1 on the words elsewhere."""
    if words.device.type == "cpu":
        return poseidon.sponge(fr.unpack16(words), ds)
    _build.kernels()
    batch, n = words.shape[:-2], words.shape[-2]
    if n == 0:
        return fr.zeros(batch, device=words.device)
    out = sponge_limbs(words.reshape((-1, n, NL)).contiguous(), ds)
    return fr.limbs_to_digits(out).reshape(batch + (ND,))


def _words_on_device(words, device=None) -> torch.Tensor:
    """``fr.pack16`` words as int32 limbs on the device they should run on
    (see the module docstring)."""
    return fr.words_to_limbs(words).to(resolve_device(device, words))


def hash_single_cuda_packed(xp) -> torch.Tensor:
    """ds=1 hash of packed ``[B, 8]`` words (``fr.pack16``; int64 values or
    int32 bit patterns) -> ``[B, 16]`` digits; equal to
    ``hash_single_cuda(fr.unpack16(xp))``."""
    return _sponge_packed(_words_on_device(xp)[..., None, :], poseidon.DS_SINGLE)


def hash_pair_cuda_packed(lp, rp) -> torch.Tensor:
    """ds=2 hash of packed ``[B, 8]`` left and right words."""
    device = resolve_device(None, lp, rp)
    return _sponge_packed(
        torch.stack([_words_on_device(lp, device), _words_on_device(rp, device)],
                    dim=-2),
        poseidon.DS_PAIR,
    )


def hash_multiple_cuda_packed(xp) -> torch.Tensor:
    """ds=3 hash of packed ``[B, n, 8]`` groups (n = 0 gives zeros)."""
    return _sponge_packed(_words_on_device(xp), poseidon.DS_MULTIPLE)


# ---------------------------------------------------------------------------
# K1 in a device loop
# ---------------------------------------------------------------------------

def hash_pair_cuda_loop(left, right, iters: int) -> torch.Tensor:
    """``iters`` chained pair hashes, ``state_{i+1} = hash_pair(state_i,
    right)``; returns the last state, equal to ``iters`` calls of
    :func:`hash_pair_cuda`.  On the card the operands become limbs once
    and each step is one K1 launch whose output feeds the next."""
    device = resolve_device(None, left, right)
    left, right = torch.broadcast_tensors(_on_device(left, device),
                                          _on_device(right, device))
    if left.device.type == "cpu":
        for _ in range(iters):
            left = poseidon.hash_pair(left, right)
        return left
    _build.kernels()
    batch = left.shape[:-1]
    pair = fr.digits_to_limbs(
        torch.stack([left, right], dim=-2).reshape(-1, 2, ND)
    ).contiguous()
    for _ in range(iters):
        pair[:, 0] = sponge_limbs(pair, poseidon.DS_PAIR)
    return fr.limbs_to_digits(pair[:, 0]).reshape(batch + (ND,))


def hash_single_cuda_loop(x, iters: int) -> torch.Tensor:
    """``iters`` chained single hashes on the card (see
    :func:`hash_pair_cuda_loop`)."""
    x = _on_device(x)
    if x.device.type == "cpu":
        for _ in range(iters):
            x = poseidon.hash_single(x)
        return x
    _build.kernels()
    batch = x.shape[:-1]
    cur = fr.digits_to_limbs(x.reshape(-1, ND)).contiguous()
    for _ in range(iters):
        cur = sponge_limbs(cur[:, None, :], poseidon.DS_SINGLE)
    return fr.limbs_to_digits(cur).reshape(batch + (ND,))


# ---------------------------------------------------------------------------
# K4: the raw permutation
# ---------------------------------------------------------------------------

def _digit_rows(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` (int64 digits on the card) contiguous in ``shape``, copied when
    its rows would not start on 16 bytes: the digit-form kernels move rows
    in 16-byte chunks."""
    x = x.reshape(shape).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def permutation_cuda(states) -> torch.Tensor:
    """Raw batched permutation on ``[..., 3, 16]`` digit states of any
    256-bit values (digits read by value): the plain permutation on the
    CPU, elsewhere K4 on the digits themselves (the kernel reads each row by
    value and writes digits below 2^16; no conversion around it)."""
    states = _on_device(states)
    if states.device.type == "cpu":
        return poseidon.permutation(states)
    kernels = _build.kernels()
    shape = states.shape
    if shape[-2:] != (poseidon.T, ND):
        raise ValidationError(f"states must be [..., 3, 16] digits, got {shape}")
    x = _digit_rows(states, (-1, poseidon.T, ND))
    out = torch.empty_like(x)
    if x.shape[0]:
        _launch(kernels, kernels.lib.cuzk_permutation_digits, x.device,
                x.data_ptr(), out.data_ptr(), x.shape[0])
        launch_counts["permutation"] += 1
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# K3: per-proof verification
# ---------------------------------------------------------------------------

def verify_digits(positions: torch.Tensor, siblings: torch.Tensor,
                  leaves: torch.Tensor, root: torch.Tensor,
                  arity: int, lanes=None) -> torch.Tensor:
    """K3 on digits: ``positions [k, h]``, ``siblings [k, h, a-1, 16]``,
    ``leaves [k, 16]`` and ``root [16]`` int64 on the card, h >= 1 ->
    ``[k] bool``, the plain verify's verdicts.  The kernel reads the leaf
    and siblings by value, as :func:`fr.digits_to_limbs` does, and compares
    the root digit by digit with the recomputed digest's canonical digits,
    so a root digit outside [0, 2^16) never verifies; nothing is converted
    before the launch.  Int32 positions go to the kernel as they are (it
    clamps each to [-1, arity]); any other dtype is clamped first, so that
    2^32 + p does not alias p in the cast.  ``lanes`` forces G (one of
    :data:`LANES`); by default :func:`choose_lanes` picks it."""
    if positions.dtype != torch.int32:
        positions = positions.clamp(-1, arity).to(torch.int32)
    with trace.span("k3"):
        kernels = _build.kernels()
        _check_limbs(positions, "positions", 2)
        _check_limbs(siblings, "siblings", 4, torch.int64)
        _check_limbs(leaves, "leaves", 2, torch.int64)
        _check_limbs(root, "root", 1, torch.int64)
        k, h = positions.shape
        if len({t.device for t in (positions, siblings, leaves, root)}) != 1:
            raise ValidationError("proof tensors must lie on one device")
        if not constants.MIN_ARITY <= arity <= constants.MAX_ARITY:
            raise ValidationError(f"arity must be in [2, 8], got {arity}")
        if h < 1 or (
            tuple(siblings.shape) != (k, h, arity - 1, ND)
            or tuple(leaves.shape) != (k, ND)
            or tuple(root.shape) != (ND,)
        ):
            raise ValidationError(
                f"proof tensors disagree: positions {tuple(positions.shape)}, "
                f"siblings {tuple(siblings.shape)}, leaves {tuple(leaves.shape)}, "
                f"root {tuple(root.shape)}, arity {arity}"
            )
        ok = torch.empty(k, dtype=torch.bool, device=leaves.device)
        if k:
            g = _lanes(lanes, k, leaves.device, "verify")
            _launch(kernels, kernels.lib.cuzk_verify_digits, leaves.device,
                    positions.data_ptr(), siblings.data_ptr(), leaves.data_ptr(),
                    root.data_ptr(), ok.data_ptr(), k, h, arity, g)
            launch_counts["verify"] += 1
            trace.count(f"k3.lanes.{g}")
        return ok


# ---------------------------------------------------------------------------
# The per-op check kernel
# ---------------------------------------------------------------------------

def fr_op_cuda(op: str, a, b=None, c: int = 0) -> torch.Tensor:
    """One field operation of the device library on ``[n, 16]`` digits
    (``reduce_wide`` takes ``[n, 32]``, two elements a row): ``b`` for the
    binary ops, the constant ``c`` for ``mul_small`` and ``mul_small_rr``
    (whose operand must be reduced, c <= 26).  The plain ``fr`` op on the
    CPU; elsewhere the check kernel on the digits themselves (each element
    read by value, as ``fr.digits_to_limbs`` reads it, and written below
    2^16; no conversion around it)."""
    plain = FR_OPS[op][1]
    a = _on_device(a)
    if a.device.type == "cpu":
        if op in ("mul_small", "mul_small_rr"):
            return plain(a, c)
        return plain(a) if b is None else plain(a, b)
    kernels = _build.kernels()
    width = 2 * ND if op == "reduce_wide" else ND
    if a.dim() != 2 or a.shape[1] != width:
        raise ValidationError(f"{op} takes [n, {width}] digits, got {a.shape}")
    if (b is None) == (op in _BINARY_FR_OPS):
        raise ValidationError(
            f"{op} takes {'two operands' if op in _BINARY_FR_OPS else 'one'}")
    n = a.shape[0]
    a = _digit_rows(a, (n, width))
    if b is not None:
        b = fr.as_digits(b, device=a.device)
        if tuple(b.shape) != (n, ND):
            raise ValidationError(f"{op}: b must be [{n}, {ND}] digits beside a")
        b = _digit_rows(b, (n, ND))
    out = torch.empty((n, ND), dtype=torch.int64, device=a.device)
    if n:
        _launch(kernels, kernels.lib.cuzk_fr_op_digits, a.device,
                FR_OPS[op][0], a.data_ptr(), (a if b is None else b).data_ptr(),
                c, out.data_ptr(), n)
        launch_counts["fr_op"] += 1
    return out
