"""Batched Poseidon hash (t=3, R_F=8, R_P=56, x^5 S-box) in plain PyTorch.

The counterpart of :mod:`cuzk_tpu.poseidon`, and the plain version of the
CUDA sponge kernel (``csrc/poseidon_kernels.cu::sponge_kernel``): eager
tensor code over ``[..., 16]`` int64 digits, batched across the leading
axes, bit-exact against the reference (SURVEY.md Appendix A).  The
three state lanes are stacked as ``[..., 3, 16]`` so each round's S-box and
MDS run as one batched field operation.  The empty input returns 0 with no
permutation (poseidon.cpp:103-126, SURVEY.md Appendix B.4).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from cuzk_tpu_torch import constants
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.utils.device import resolve_device

T = constants.T
RATE = constants.RATE
FULL_ROUNDS = constants.FULL_ROUNDS
PARTIAL_ROUNDS = constants.PARTIAL_ROUNDS
HALF_FULL = FULL_ROUNDS // 2
TOTAL_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS

DS_SINGLE = constants.DS_SINGLE
DS_PAIR = constants.DS_PAIR
DS_MULTIPLE = constants.DS_MULTIPLE


@dataclass(frozen=True)
class PoseidonParams:
    """The reference's compile-time parameter block (poseidon.hpp:8-16).
    Only the reference set is implemented, as in ``cuzk_tpu.poseidon``."""

    state_size: int = constants.T
    capacity: int = 1
    rate: int = constants.RATE
    full_rounds: int = constants.FULL_ROUNDS
    partial_rounds: int = constants.PARTIAL_ROUNDS
    sbox_power: int = 5

    def __post_init__(self):
        if (
            self.state_size != constants.T
            or self.rate != constants.RATE
            or self.full_rounds != constants.FULL_ROUNDS
            or self.partial_rounds != constants.PARTIAL_ROUNDS
            or self.sbox_power != 5
        ):
            raise ValueError(
                "only the reference parameter set (t=3, r=2, R_F=8, R_P=56, "
                "alpha=5) is supported"
            )


# The reference parameter block (poseidon.hpp:8-16).
DEFAULT_PARAMS = PoseidonParams()

# Round constants as [64, 3, 16] uint32 digits (poseidon.cpp:33-44), the
# same array as cuzk_tpu.poseidon.RC_DIGITS.
RC_DIGITS = np.stack([fr.int_to_digits(x) for x in constants.RC]).reshape(
    TOTAL_ROUNDS, T, fr.NDIGITS
)
# Round constants as [64, 3, 8] u32 limbs, the table the CUDA kernels keep
# in constant memory.
RC_LIMBS = (
    RC_DIGITS[..., 0::2].astype(np.uint64)
    | (RC_DIGITS[..., 1::2].astype(np.uint64) << np.uint64(16))
).astype(np.uint32)

# 3x3 MDS matrix, row-major (poseidon.cpp:46-58).
MDS = constants.MDS
# Product q = 3 i + j multiplies state row j by MDS[3 i + j].
_MDS_SRC_ROW = [j for _ in range(T) for j in range(T)]


def _is_full(r: int) -> bool:
    return r < HALF_FULL or r >= HALF_FULL + PARTIAL_ROUNDS


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(round constants [64, 3, 16], MDS coefficients [9]) on ``device``."""
    return (
        torch.as_tensor(RC_DIGITS.astype(np.int64), device=device),
        torch.as_tensor(np.array(MDS, np.int64), device=device),
    )


def _mds_rc(s: torch.Tensor, coeff: torch.Tensor, rc_next) -> torch.Tensor:
    """One MDS layer plus the next round's constant on a stacked reduced
    ``[..., 3, 16]`` state (the plain form of fieldslab.mds_rc_fused).

    Each product MDS[i][j] * s[j] is the reference's mul by a coefficient
    <= 26 of a reduced operand: the product's high part is <= 7, so
    m = high * k < 2^255 and the truncated fold's mh branch never runs;
    the product reduces as add(low, high * k).  The row sum plus the
    constant (< 4p) then needs one carry and one reduce: the reference's
    chained wrapping adds are exact modular adds on reduced operands."""
    prods = s[..., _MDS_SRC_ROW, :] * coeff[:, None]  # [..., 9, 16], < 2^21
    low, high = fr._carry_keep(prods, passes=2)
    hc = fr._carry_keep(high[..., None] * fr._const(constants.K, s.device),
                        passes=2)[0]
    m = fr._add_canonical(low, hc)
    m = m.reshape(m.shape[:-2] + (T, T, fr.NDIGITS))
    total = m.sum(dim=-2)  # digit sums < 3 * 2^16
    if rc_next is not None:
        total = total + rc_next
    return fr.red(fr._carry_keep(total, passes=2)[0])


def permute(state: torch.Tensor, full_round0_add: bool = False) -> torch.Tensor:
    """64-round permutation on a stacked ``[..., 3, 16]`` digit state, in
    the order "add RC[0]; per round: S-box, MDS, add RC[r+1]".

    The sponge feeds reduced state, where the single-subtract ``add_rr``
    equals the reference's add; the raw permutation may see any canonical
    256-bit state and passes ``full_round0_add`` for the full wrapping add
    in round 0.  Every later operand is reduced."""
    rc, coeff = _tables(state.device)
    add0 = fr.add if full_round0_add else fr.add_rr
    # Inference mode skips autograd bookkeeping on each of the ~40K small
    # ops (1.7x faster on the CPU); the clone hands back a normal tensor.
    with torch.inference_mode():
        s = add0(state, rc[0])
        for r in range(TOTAL_ROUNDS):
            if _is_full(r):
                s = fr.power5(s)
            else:
                s = torch.cat([fr.power5(s[..., :1, :]), s[..., 1:, :]], dim=-2)
            s = _mds_rc(s, coeff, rc[r + 1] if r + 1 < TOTAL_ROUNDS else None)
    return s.clone()


def permutation(state) -> torch.Tensor:
    """Poseidon permutation on ``[..., 3, 16]`` states of any canonical
    256-bit values (poseidon.cpp:60-87; round 0 adds with the full
    reference semantics, like its batch_permutation)."""
    return permute(fr.as_digits(state), full_round0_add=True)


def sponge(inputs, domain_separator: int) -> torch.Tensor:
    """Sponge over ``[..., n, 16]`` inputs (poseidon.cpp:103-126): ds in
    state[0], absorb pairs into state[1..2] with the full wrapping add
    (inputs may be >= p, or carry non-canonical digits, which count by
    value), one permutation per block, squeeze state[1]."""
    inputs = fr.as_digits(inputs)
    n = inputs.shape[-2]
    batch = inputs.shape[:-2]
    if n == 0:
        return fr.zeros(batch, device=inputs.device)
    state = fr.zeros(batch + (T,), device=inputs.device)
    state[..., 0, 0] = domain_separator
    for i in range(0, n, RATE):
        block = inputs[..., i : i + RATE, :]
        w = block.shape[-2]
        absorbed = fr.add(state[..., 1 : 1 + w, :], block)
        state = torch.cat(
            [state[..., :1, :], absorbed, state[..., 1 + w :, :]], dim=-2
        )
        state = permute(state)
    return state[..., 1, :]


def hash_single(x) -> torch.Tensor:
    """Batched single-input hash, ds=1 (poseidon.cpp:89-91):
    ``[..., 16] -> [..., 16]``."""
    return sponge(fr.as_digits(x)[..., None, :], DS_SINGLE)


def hash_pair(left, right) -> torch.Tensor:
    """Batched pair hash, ds=2 (poseidon.cpp:93-96)."""
    left, right = torch.broadcast_tensors(fr.as_digits(left), fr.as_digits(right))
    return sponge(torch.stack([left, right], dim=-2), DS_PAIR)


def hash_multiple(inputs) -> torch.Tensor:
    """Batched n-input hash, ds=3 (poseidon.cpp:98-101):
    ``[..., n, 16] -> [..., 16]``."""
    return sponge(inputs, DS_MULTIPLE)


# ---------------------------------------------------------------------------
# Host helpers, ints in and ints out (as cuzk_tpu.poseidon's), through the
# kernels on the card by default (ops.hash_*_cuda) or the plain sponge for
# device="cpu".  ops imports this module, so it is imported here lazily.
# ---------------------------------------------------------------------------

def _ops():
    from cuzk_tpu_torch.ops import poseidon_cuda

    return poseidon_cuda


def _digits(ints, device) -> torch.Tensor:
    return fr.ints_to_array(ints, device=resolve_device(device))


def hash_single_int(x: int, device=None) -> int:
    """``hash_single`` of one int (ds=1)."""
    return fr.array_to_ints(_ops().hash_single_cuda(_digits([x], device)))[0]


def hash_pair_int(left: int, right: int, device=None) -> int:
    """``hash_pair`` of two ints (ds=2)."""
    return fr.array_to_ints(_ops().hash_pair_cuda(
        _digits([left], device), _digits([right], device)))[0]


def hash_multiple_int(inputs, device=None) -> int:
    """``hash_multiple`` of a sequence of ints (ds=3); the empty sequence
    hashes to 0 with no permutation (the device rule still applies)."""
    inputs = list(inputs)
    if not inputs:
        resolve_device(device)
        return 0
    return fr.array_to_ints(
        _ops().hash_multiple_cuda(_digits(inputs, device)[None]))[0]
