"""BN254-Fr on ``[..., 16]`` int64 tensors of 16-bit little-endian digits,
with the cuZK reference's CPU semantics bit for bit: adds wrap at 2^256,
the 512 -> 256 reduction is the truncated k-fold (field_arithmetic.cpp:
172-338).

The schoolbook product's column sums (< 2^36: 16 digit products < 2^32)
are float64 matrix products, which are exact for integers below 2^53: the
digit outer product times a fixed 0/1 matrix, or, for the constant k, the
digits times k's shifted digits.
"""

from __future__ import annotations

import torch

from zkbench.reference import constants

NDIGITS = 16
DIGIT_BITS = 16
DIGIT_MASK = 0xFFFF
DTYPE = torch.int64


def int_to_digits(x: int, ndigits: int = NDIGITS) -> list:
    """A non-negative int below 2^(16 ndigits) as little-endian digits."""
    if x < 0 or x >= 1 << (DIGIT_BITS * ndigits):
        raise ValueError(f"value out of range for {ndigits} digits")
    return [(x >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(ndigits)]


def digits_to_int(d) -> int:
    """One element's digits (each counted by its value) as an int."""
    return sum(int(v) << (DIGIT_BITS * i) for i, v in enumerate(list(d)))


def carry_keep(cols: torch.Tensor, passes: int = 3):
    """Non-negative columns -> ``(canonical 16-bit digits, carry out)``.

    Each pass moves the bits above 16 one digit up; ``passes`` brings every
    digit to <= 2^16 (3 for columns < 2^40, 1 for sums of two canonical
    digits).  The remaining +1 carries settle as one binary addition: with
    generate bits G (digit == 2^16) and propagate bits P (digit == 2^16 - 1)
    packed into integers, the carries into the digits are those of
    (G | P) + G."""
    x = cols
    top = torch.zeros_like(cols[..., -1])
    for _ in range(passes):
        hi = x >> DIGIT_BITS
        top = top + hi[..., -1]
        x = x & DIGIT_MASK
        x[..., 1:] += hi[..., :-1]
    n = x.shape[-1]
    bits = torch.arange(n, dtype=DTYPE, device=x.device)
    g = ((x >> DIGIT_BITS) << bits).sum(dim=-1)
    a = g | ((x == DIGIT_MASK).to(DTYPE) << bits).sum(dim=-1)
    s = a + g
    carries_in = ((s ^ a ^ g)[..., None] >> bits) & 1
    return (x + carries_in) & DIGIT_MASK, top + ((s >> n) & 1)


def carry(cols: torch.Tensor) -> torch.Tensor:
    """Canonical digits of the columns' value, wrapped at 2^(16 n)."""
    return carry_keep(cols)[0]


def _skew(device) -> torch.Tensor:
    """``[256, 32]`` float64: digit product (i, j), flattened as 16 i + j,
    sums into column i + j."""
    s = torch.zeros((NDIGITS * NDIGITS, 2 * NDIGITS), dtype=torch.float64)
    for i in range(NDIGITS):
        for j in range(NDIGITS):
            s[NDIGITS * i + j, i + j] = 1.0
    return s.to(device)


def _toeplitz(x: int, device) -> torch.Tensor:
    """``[16, 32]`` float64 with row i holding the digits of ``x`` shifted
    right by i: ``d @ T`` gives the product columns of ``d`` and ``x``."""
    digits = int_to_digits(x)
    t = torch.zeros((NDIGITS, 2 * NDIGITS), dtype=torch.float64)
    for i in range(NDIGITS):
        t[i, i:i + NDIGITS] = torch.tensor(digits, dtype=torch.float64)
    return t.to(device)


class Field:
    """The field's operations on one device, with the reduction constant
    ``k`` (2^256 mod p for the reference; the control passes the CUDA
    sources' k + 4)."""

    def __init__(self, device, k: int = constants.K):
        self.device = torch.device(device)
        self.k = k
        self.k_digits = self.const(k)
        # 2^256 - j p for j = 1..5: one carrying add finds how many
        # multiples of p fit below a 256-bit value.
        self.multiples_complement = torch.tensor(
            [int_to_digits((1 << 256) - j * constants.P) for j in range(1, 6)],
            dtype=DTYPE, device=self.device)
        self.p_complement = self.const((1 << 256) - constants.P)
        self.skew = _skew(self.device)
        self.k_toeplitz = _toeplitz(k, self.device)

    def const(self, x: int) -> torch.Tensor:
        return torch.tensor(int_to_digits(x), dtype=DTYPE, device=self.device)

    def red(self, a: torch.Tensor) -> torch.Tensor:
        """``while a >= p: a -= p`` for canonical a < 2^256 (< 6p)."""
        d, c = carry_keep(a[..., None, :] + self.multiples_complement,
                          passes=1)
        j = c.sum(dim=-1)
        pick = torch.gather(
            d, -2,
            (j - 1).clamp(min=0)[..., None, None].expand(
                a.shape[:-1] + (1, NDIGITS)))[..., 0, :]
        return torch.where((j > 0)[..., None], pick, a)

    def cond_sub_p(self, a: torch.Tensor) -> torch.Tensor:
        d, c = carry_keep(a + self.p_complement, passes=1)
        return torch.where((c == 1)[..., None], d, a)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The reference's add: (a + b) mod 2^256, then reduced; digits
        count by value."""
        return self.red(carry(a + b))

    def add_canonical(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.red(carry_keep(a + b, passes=1)[0])

    def add_rr(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """:meth:`add` for reduced operands: one conditional subtract."""
        return self.cond_sub_p(carry_keep(a + b, passes=1)[0])

    def mul_wide(self, a, b) -> torch.Tensor:
        """The exact 512-bit product as 32 canonical digits."""
        a, b = torch.broadcast_tensors(a, b)
        outer = a.to(torch.float64)[..., :, None] * b.to(torch.float64)[..., None, :]
        cols = outer.reshape(a.shape[:-1] + (NDIGITS * NDIGITS,)) @ self.skew
        return carry(cols.to(DTYPE))

    def mul_k(self, a: torch.Tensor, low_only: bool = False) -> torch.Tensor:
        """a * k exactly (32 digits), or its low 256 bits."""
        t = self.k_toeplitz[:, :NDIGITS] if low_only else self.k_toeplitz
        return carry((a.to(torch.float64) @ t).to(DTYPE))

    def reduce_wide(self, prod: torch.Tensor) -> torch.Tensor:
        """The truncated k-fold (field_arithmetic.cpp:250-330): ``(mh * k)
        >> 256`` is dropped, the ``mh == 0`` select kept."""
        low, high = prod[..., :NDIGITS], prod[..., NDIGITS:]
        m = self.mul_k(high)
        hc, mh = m[..., :NDIGITS], m[..., NDIGITS:]
        mh_nz = (mh != 0).any(dim=-1, keepdim=True)
        hc = torch.where(mh_nz,
                         self.add_canonical(hc, self.mul_k(mh, low_only=True)),
                         hc)
        return self.add_canonical(low, hc)

    def mul(self, a, b) -> torch.Tensor:
        return self.reduce_wide(self.mul_wide(a, b))

    def power5(self, a: torch.Tensor) -> torch.Tensor:
        """a^5 = ((a^2)^2) * a (field_arithmetic.cpp:332-338)."""
        a2 = self.mul(a, a)
        return self.mul(self.mul(a2, a2), a)
