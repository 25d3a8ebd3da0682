"""Field-element I/O: hex and decimal strings, and deterministic randoms.

The counterpart of ``cuzk_tpu.utils.io``: the reference's FieldElement
string interface (field_arithmetic.cpp:103-159) and its mt19937_64-based
``FieldArithmetic::random`` (field_arithmetic.cpp:340-351), on the port's
own generator (``merkle._mt19937_64``) and its plain ``fr.red``.  Elements
are ``[16]`` (or ``[n, 16]``) int64 digit tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from cuzk_tpu_torch import merkle
from cuzk_tpu_torch.field import fr


def _as_int(x) -> int:
    return x if isinstance(x, int) else fr.array_to_ints(x)[0]


def to_hex(x, width: int = 64) -> str:
    """Digits or an int -> 0x-prefixed, zero-padded hex (all 256 bits, as
    field_arithmetic.cpp:103-117 prints them)."""
    return f"0x{_as_int(x):0{width}x}"


def from_hex(s: str) -> torch.Tensor:
    """Hex string (with or without 0x) -> ``[16]`` digits
    (field_arithmetic.cpp:133-159)."""
    v = int(s, 16)
    if v >= 1 << 256:
        raise ValueError("hex value exceeds 256 bits")
    return fr.ints_to_array([v])[0]


def to_decimal(x) -> str:
    """Exact decimal (the reference's to_decimal_string goes through a
    double above 2^64, field_arithmetic.cpp:119-131; this does not)."""
    return str(_as_int(x))


def from_decimal(s: str) -> torch.Tensor:
    """Decimal string -> ``[16]`` digits."""
    return fr.ints_to_array([int(s, 10)])[0]


def random_element(seed: Optional[int] = None) -> torch.Tensor:
    """One reduced element from the reference's generator scheme."""
    return random_elements(1, seed)[0]


def random_elements(count: int, seed: Optional[int] = None) -> torch.Tensor:
    """``[count, 16]`` reduced elements: four mt19937_64 draws per element,
    little-endian, then ``red`` (field_arithmetic.cpp:340-351); the seed
    defaults to 42."""
    draws = merkle._mt19937_64(42 if seed is None else seed, 4 * count)
    vals = [
        sum(d << (64 * i) for i, d in enumerate(draws[4 * e:4 * e + 4]))
        for e in range(count)
    ]
    if not vals:
        return fr.zeros((0,))
    return fr.red(fr.ints_to_array(vals))
