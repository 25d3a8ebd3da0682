"""Helpers the traffic kinds share: inputs made from the seed on the
device, the seeded sample of outputs kept for the check, and the row
comparison with the reference."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# BN254-Fr's modulus p has the top 16-bit digit 0x3064: a top digit below
# it keeps a value canonical (< p) whatever the other digits are.
P_TOP_DIGIT = 0x3064
NDIGITS = 16
SEED_MASK = (1 << 63) - 1


def generator(seed: int, device: torch.device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for the seed's ``stream``-th input."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & SEED_MASK) * 1_000_003 + stream) & SEED_MASK)
    return g


def host_rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed & SEED_MASK, stream])


def random_elements(gen: torch.Generator, shape: Sequence[int],
                    device: torch.device) -> torch.Tensor:
    """``[*shape, 16]`` int64 digits of canonical field elements (< p), in
    two calls on the device."""
    shape = tuple(shape)
    x = torch.randint(0, 1 << 16, shape + (NDIGITS,), generator=gen,
                      device=device, dtype=torch.int64)
    x[..., -1] = torch.randint(0, P_TOP_DIGIT, shape, generator=gen,
                               device=device, dtype=torch.int64)
    return x


class Reservoir:
    """One output kept for each key, drawn uniformly from the seed among
    every output of that key offered (reservoir sampling of size one)."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.count: Dict[object, int] = {}
        self.kept: Dict[object, object] = {}

    def offer(self, key, make) -> None:
        """Count one output of ``key``; keep ``make()`` if it is drawn."""
        c = self.count.get(key, 0) + 1
        self.count[key] = c
        if c == 1 or self.rng.random() < 1.0 / c:
            self.kept[key] = make()


def rows_wrong(got: Optional[List[torch.Tensor]], want: List[torch.Tensor]) -> int:
    """Rows of the levels ``want`` that ``got`` does not hold bit for bit
    (a missing or misshapen level counts all its rows)."""
    wrong = 0
    got = list(got or [])
    for i, w in enumerate(want):
        g = got[i] if i < len(got) else None
        if g is None or tuple(g.shape) != tuple(w.shape):
            wrong += int(w.shape[0])
            continue
        wrong += int((g.to(w.device) != w).any(dim=-1).sum())
    for g in got[len(want):]:
        wrong += int(g.shape[0])
    return wrong


def levels_rows(levels: List[torch.Tensor]) -> int:
    return sum(int(lv.shape[0]) for lv in levels)
