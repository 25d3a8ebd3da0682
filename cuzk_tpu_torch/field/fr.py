"""BN254-Fr arithmetic in plain PyTorch on ``[..., 16]`` 16-bit digit tensors.

The counterpart of :mod:`cuzk_tpu.field.fr`: the same public format (16
little-endian 16-bit digits per element), the same functions, and the
reference's CPU semantics bit for bit (wrap-at-2^256 adds, the truncated
k-fold reduction, SURVEY.md Appendix A).  Digits are held in ``int64``
tensors: torch's CPU build has no add, shift or compare for ``uint32``, and
every intermediate here (column sums of digit products < 2^36) fits.

These are the plain versions of the CUDA field library
(``cuzk_tpu_torch/csrc/fr254.cuh``).  They run on any device, so the CPU
tests use them and ``chip_smoke.py`` holds the kernels against them on the
card.  The kernels work on 8 x u32 limbs; :func:`digits_to_limbs` and
:func:`limbs_to_digits` convert between the two.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from cuzk_tpu_torch import constants
from cuzk_tpu_torch.utils import trace

NDIGITS = 16  # 16 x 16-bit = 256 bits
DIGIT_BITS = 16
DIGIT_MASK = 0xFFFF
NDIGITS_WIDE = 32
NLIMBS = 8  # 8 x 32-bit limbs, the kernels' format
DTYPE = torch.int64
# The counters (utils.trace) of the rows that digits_to_limbs and
# limbs_to_digits convert, while a profiler session records.
ROW_COUNTERS = ("convert.rows.to_limbs", "convert.rows.to_digits")


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def int_to_digits(x: int, ndigits: int = NDIGITS) -> np.ndarray:
    """Python int -> little-endian 16-bit digit vector (uint32)."""
    if x < 0 or x >= 1 << (DIGIT_BITS * ndigits):
        raise ValueError(f"value out of range for {ndigits} digits")
    return np.array(
        [(x >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(ndigits)],
        dtype=np.uint32,
    )


def digits_to_int(d) -> int:
    """One element's digit vector (any length; torch, numpy or a list) ->
    Python int, each digit counted by its value."""
    d = as_digits(d)
    if d.dim() != 1:
        raise ValueError("digits_to_int takes a single element; use array_to_ints")
    return sum(int(v) << (DIGIT_BITS * i) for i, v in enumerate(d.cpu().tolist()))


def ints_to_array(xs: Sequence[int], ndigits: int = NDIGITS,
                  device=None) -> torch.Tensor:
    """Sequence of ints -> ``[n, ndigits]`` int64 digit tensor."""
    arr = np.stack([int_to_digits(int(x), ndigits) for x in xs])
    return torch.as_tensor(arr.astype(np.int64), device=device)


def array_to_ints(a) -> list:
    """``[..., ndigits]`` -> list of Python ints (flattened batch)."""
    a = as_digits(a)
    flat = a.reshape(-1, a.shape[-1]).cpu().tolist()
    return [
        sum(int(v) << (DIGIT_BITS * i) for i, v in enumerate(row))
        for row in flat
    ]


def as_digits(x, device=None) -> torch.Tensor:
    """Any integer array (torch, numpy, nested lists) -> int64 tensor.  A
    numpy uint32 array bound for a card crosses as its 4-byte words and
    widens there."""
    if isinstance(x, torch.Tensor):
        t = x if x.dtype == DTYPE else x.to(DTYPE)
        return t if device is None else t.to(device)
    a = np.asarray(x)
    if a.dtype == np.uint32 and device is not None and \
            torch.device(device).type != "cpu":
        words = torch.from_numpy((a if a.flags.c_contiguous else a.copy())
                                 .view(np.int32))
        return words.to(device).to(DTYPE) & 0xFFFFFFFF
    return torch.as_tensor(a.astype(np.int64), device=device)


def pack16(a) -> torch.Tensor:
    """``[.., 16]`` digits -> ``[.., 8]`` words, two digits per word with the
    low digit in the low half: the word layout of ``cuzk_tpu.field.fr.pack16``
    (values 0..2^32-1 in int64).  Like that function it drops the bits of a
    digit >= 2^16 that do not fit: range-check first."""
    a = as_digits(a)
    return (a[..., 0::2] | (a[..., 1::2] << DIGIT_BITS)) & 0xFFFFFFFF


def pack16_host(a: np.ndarray) -> np.ndarray:
    """:func:`pack16` on the host: ``[.., 16]`` numpy uint32 digits, each
    below 2^16 (range-check first), -> ``[.., 8]`` uint32 words, the bytes
    ``cuzk_tpu.field.fr.pack16`` gives."""
    a = np.asarray(a, np.uint32)
    return a[..., 0::2] | (a[..., 1::2] << np.uint32(DIGIT_BITS))


def unpack16(p) -> torch.Tensor:
    """Inverse of :func:`pack16`: ``[.., 8]`` words (int64 values or int32
    bit patterns) -> ``[.., 16]`` digits."""
    p = as_digits(p) & 0xFFFFFFFF
    lo = p & DIGIT_MASK
    hi = p >> DIGIT_BITS
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (NDIGITS,))


def digits_to_limbs(d) -> torch.Tensor:
    """``[.., 16]`` digits -> ``[.., 8]`` u32 limbs as int32 bit patterns.

    By value, not a bit-pack: the limbs hold sum(d_i * 2^(16 i)) mod 2^256,
    so a digit d + 2^16 means what it means to the JAX path's carrying add
    (a bit-pack would alias it to d)."""
    with trace.span("convert.to_limbs"):
        d = as_digits(d)
        trace.count(ROW_COUNTERS[0], d.numel() // NDIGITS)
        return words_to_limbs(pack16(carry(d)))


def words_to_limbs(words) -> torch.Tensor:
    """:func:`pack16` words (int64 values 0..2^32-1, or int32 bit
    patterns, which pass through) -> the same words as int32 limbs, by
    two's complement."""
    if isinstance(words, torch.Tensor) and words.dtype == torch.int32:
        return words
    words = as_digits(words) & 0xFFFFFFFF
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32
    )


def limbs_to_digits(limbs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`digits_to_limbs`: int32 limbs -> int64 digits."""
    with trace.span("convert.to_digits"):
        trace.count(ROW_COUNTERS[1], limbs.numel() // NLIMBS)
        return unpack16(limbs)


# ---------------------------------------------------------------------------
# Carry and reduction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bit_positions(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=DTYPE, device=device)


def _carry_keep(cols: torch.Tensor, passes: int = 3):
    """Canonicalize non-negative columns into 16-bit digits.

    Returns ``(digits, carry_out)``; callers that model the reference's
    2^256 / 2^512 wrap drop ``carry_out``.  Each pass moves the bits above
    16 one digit up; ``passes`` must bring every digit to <= 2^16 (3 for
    columns < 2^40, 1 for sums of two canonical digits).  The remaining
    chain of +1 carries is settled exactly as one binary addition: with
    generate bits G (digit == 2^16) and propagate bits P (digit == 2^16 - 1)
    packed into integers, the carries into each digit are the carry bits
    of (G | P) + G."""
    x = cols
    top = torch.zeros_like(cols[..., -1])
    for _ in range(passes):
        hi = x >> DIGIT_BITS
        top = top + hi[..., -1]
        x = x & DIGIT_MASK
        x[..., 1:] += hi[..., :-1]
    n = x.shape[-1]
    bits = _bit_positions(n, x.device)
    g = ((x >> DIGIT_BITS) << bits).sum(dim=-1)
    a = g | ((x == DIGIT_MASK).to(DTYPE) << bits).sum(dim=-1)
    s = a + g
    carries_in = ((s ^ a ^ g)[..., None] >> bits) & 1
    return (x + carries_in) & DIGIT_MASK, top + ((s >> n) & 1)


def carry(cols: torch.Tensor) -> torch.Tensor:
    """Canonical digits of the columns' value (columns < 2^40), wrapped at
    2^(16 n)."""
    return _carry_keep(cols)[0]


_P = constants.P

# The digits of the constants (numpy uint32 ``[16]``), as
# ``cuzk_tpu.field.fr`` names them.
P_DIGITS = int_to_digits(_P)
P2_DIGITS = int_to_digits(2 * _P)
P4_DIGITS = int_to_digits(4 * _P)
K_DIGITS = int_to_digits(constants.K)
ZERO_DIGITS = int_to_digits(0)
ONE_DIGITS = int_to_digits(1)
TWO_DIGITS = int_to_digits(2)


@functools.lru_cache(maxsize=None)
def _const(x: int, device: torch.device) -> torch.Tensor:
    """A constant's 16 digits on ``device`` (built once per device)."""
    return torch.as_tensor(int_to_digits(x).astype(np.int64), device=device)


@functools.lru_cache(maxsize=None)
def _multiples_complement(device: torch.device) -> torch.Tensor:
    """``[5, 16]`` digits of 2^256 - k p for k = 1..5."""
    return torch.as_tensor(
        np.stack(
            [int_to_digits((1 << 256) - k * _P) for k in range(1, 6)]
        ).astype(np.int64),
        device=device,
    )


def red(a) -> torch.Tensor:
    """a mod p for canonical a < 2^256: a - k p for the largest k in 0..5
    with a >= k p, which is the residue of the reference's
    ``while (a >= p) a -= p`` (2^256 < 6p).  All five candidates come from
    one carrying add of 2^256 - k p; its carry out is ``a >= k p``."""
    a = as_digits(a)
    d, c = _carry_keep(
        a[..., None, :] + _multiples_complement(a.device), passes=1
    )
    k = c.sum(dim=-1)  # how many multiples of p fit: 0..5
    pick = torch.gather(
        d, -2, (k - 1).clamp(min=0)[..., None, None].expand(a.shape[:-1] + (1, NDIGITS))
    )[..., 0, :]
    return torch.where((k > 0)[..., None], pick, a)


def _cond_sub_p(a: torch.Tensor) -> torch.Tensor:
    """a - p if a >= p else a, for a < 2^256."""
    d, c = _carry_keep(a + _const((1 << 256) - _P, a.device), passes=1)
    return torch.where((c == 1)[..., None], d, a)


def wrap_add(a, b) -> torch.Tensor:
    """(a + b) mod 2^256 — the reference's carry-dropping limb add."""
    return carry(as_digits(a) + as_digits(b))


def add(a, b) -> torch.Tensor:
    """Field add with the 2^256 wrap, for any canonical inputs
    (field_arithmetic.cpp:172-182)."""
    return red(wrap_add(a, b))


def _add_canonical(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`add` for canonical digits, where one carry pass suffices."""
    return red(_carry_keep(a + b, passes=1)[0])


def add_rr(a, b) -> torch.Tensor:
    """Field add for reduced operands (a, b < p): one conditional subtract,
    bit-identical to :func:`add` there."""
    return _cond_sub_p(
        _carry_keep(as_digits(a) + as_digits(b), passes=1)[0]
    )


def _sub_borrow(a, b):
    """``((a - b) mod 2^256, a < b)`` of the operands' values mod 2^256
    (digits are read by value, as :func:`carry` reads them): one carrying
    add of a and the complement of b, plus 1; its carry out is a >= b."""
    a, b = torch.broadcast_tensors(carry(as_digits(a)), carry(as_digits(b)))
    cols = a + (DIGIT_MASK - b)
    cols[..., 0] += 1
    diff, c = _carry_keep(cols, passes=1)
    return diff, c == 0


def geq(a, b) -> torch.Tensor:
    """a >= b over the batch, on the values mod 2^256."""
    return ~_sub_borrow(a, b)[1]


def sub(a, b) -> torch.Tensor:
    """The reference's subtract (field_arithmetic.cpp:184-219): if a < b, p
    is pre-added with its 2^256 carry dropped; then the difference with
    the final borrow dropped.  No reduce, so operands >= p can give a
    result >= p.  Equal to ``cuzk_tpu_torch.oracle.sub`` on the values
    mod 2^256 (a digit >= 2^16 counts by value); ``cuzk_tpu.field.fr.sub``
    reads digits one by one and agrees on canonical digits."""
    diff, borrow = _sub_borrow(a, b)
    plus_p = _carry_keep(diff + _const(_P, diff.device), passes=1)[0]
    return torch.where(borrow[..., None], plus_p, diff)


def eq(a, b) -> torch.Tensor:
    """Digit-by-digit equality over the batch (as ``cuzk_tpu.field.fr.eq``:
    no carry, so a digit >= 2^16 is compared as it stands)."""
    a, b = torch.broadcast_tensors(as_digits(a), as_digits(b))
    return (a == b).all(dim=-1)


def is_zero(a) -> torch.Tensor:
    """All digits zero, over the batch."""
    return (as_digits(a) == 0).all(dim=-1)


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------

def _product_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., 32]`` column sums of the schoolbook product (< 2^36 each).

    The ``[16, 16]`` digit products are skewed so that product (i, j) lands
    in column i + j: padding each row to 33 and re-reading the flat buffer
    with rows of 32 shifts row i right by i."""
    a, b = torch.broadcast_tensors(a, b)
    prod = a[..., :, None] * b[..., None, :]  # [..., 16, 16], < 2^32
    lead = prod.shape[:-2]
    skew = torch.nn.functional.pad(prod, (0, NDIGITS + 1))  # [..., 16, 33]
    skew = skew.reshape(lead + (NDIGITS * (NDIGITS_WIDE + 1),))
    skew = skew[..., : NDIGITS * NDIGITS_WIDE].reshape(
        lead + (NDIGITS, NDIGITS_WIDE)
    )
    return skew.sum(dim=-2)


def mul_wide(a, b) -> torch.Tensor:
    """Exact 512-bit product as 32 canonical digits
    (field_arithmetic.cpp:221-238)."""
    return carry(_product_columns(as_digits(a), as_digits(b)))


def mul_low(a, b) -> torch.Tensor:
    """Low 256 bits of the product (the truncation in
    field_arithmetic.cpp:318-322)."""
    return carry(_product_columns(as_digits(a), as_digits(b))[..., :NDIGITS])


def reduce_wide(prod) -> torch.Tensor:
    """The truncated k-fold 512 -> 256 reduction (field_arithmetic.cpp:
    250-330).  ``(mh * k) >> 256`` is dropped and the ``mh == 0`` select is
    kept; the ``high == 0`` early-out needs none (it gives hc == 0 and
    add(low, 0) == red(low))."""
    prod = as_digits(prod)
    low, high = prod[..., :NDIGITS], prod[..., NDIGITS:]
    k = _const(constants.K, prod.device)
    m = mul_wide(high, k)
    hc, mh = m[..., :NDIGITS], m[..., NDIGITS:]
    mh_nz = (mh != 0).any(dim=-1, keepdim=True)
    hc = torch.where(mh_nz, _add_canonical(hc, mul_low(mh, k)), hc)
    return _add_canonical(low, hc)


def mul(a, b) -> torch.Tensor:
    """Field multiply: exact product + truncated reduction."""
    return reduce_wide(mul_wide(a, b))


def square(a) -> torch.Tensor:
    return mul(a, a)


def power5(a) -> torch.Tensor:
    """a^5 = ((a^2)^2) * a (field_arithmetic.cpp:332-338)."""
    a = as_digits(a)
    a2 = square(a)
    return mul(square(a2), a)


def mul_small(a, c) -> torch.Tensor:
    """``mul(a, c)`` for constants 0 <= c < 2^16, bit-identical to
    :func:`mul`: the product ``a * c`` is 17 digits, carried once and then
    reduced.  ``c`` is a Python int (checked) or an integer tensor
    broadcastable to ``a[..., 0]`` (the caller keeps it below 2^16: a check
    would wait on the device)."""
    a = as_digits(a)
    if isinstance(c, int):
        if not 0 <= c <= DIGIT_MASK:
            raise ValueError(f"mul_small constant must be < 2^16, got {c}")
        scaled = a * c
    else:
        scaled = a * as_digits(c, device=a.device)[..., None]
    low, high = _carry_keep(scaled)  # high < 2^16
    wide = torch.cat(
        [low, high[..., None], torch.zeros_like(low[..., 1:])], dim=-1
    )
    return reduce_wide(wide)


def zeros(shape, device: Optional[torch.device] = None) -> torch.Tensor:
    """``[*shape, 16]`` zero elements."""
    return torch.zeros(tuple(shape) + (NDIGITS,), dtype=DTYPE, device=device)
