"""n-ary Merkle trees on the reference Poseidon (merkle_tree.cpp:44-254):
leaves padded to the next power of arity with ``empty_hash(arity) =
hash_multiple([0] * arity)``, each level the ds = 3 hashes of its arity
groups, proofs of (position, arity - 1 siblings) a level from leaf to root,
and verification that recomputes the root and compares it digit by digit.
"""

from __future__ import annotations

from typing import List

import torch

from zkbench.reference.field import DTYPE, NDIGITS
from zkbench.reference.poseidon import Poseidon


def padded_count(n: int, arity: int) -> int:
    """The next power of arity >= n, at least 1 (merkle_tree.cpp:49-53)."""
    padded = 1
    while padded < n:
        padded *= arity
    return padded


def empty_hash(h: Poseidon, arity: int) -> torch.Tensor:
    """``[16]``: the hash of arity zeros (merkle_tree.cpp:347-357)."""
    zeros = torch.zeros((1, arity, NDIGITS), dtype=DTYPE, device=h.field.device)
    return h.hash_multiple(zeros)[0]


def build_levels(h: Poseidon, leaves: torch.Tensor, arity: int) -> List[torch.Tensor]:
    """The levels ``[S, m, 16]`` of S trees at once, leaves ``[S, n, 16]``:
    level 0 the padded leaves, the last the roots (m = 1).  The trees'
    groups of a level hash in one batch."""
    s, n = leaves.shape[0], leaves.shape[1]
    padded = padded_count(n, arity)
    level = leaves.to(DTYPE)
    if padded > n:
        pad = empty_hash(h, arity).expand(s, padded - n, NDIGITS)
        level = torch.cat([level, pad], dim=1)
    levels = [level]
    while level.shape[1] > 1:
        g = level.shape[1] // arity
        level = h.hash_multiple(level.reshape(s * g, arity, NDIGITS)).reshape(
            s, g, NDIGITS)
        levels.append(level)
    return levels


def gather_proofs(levels: List[torch.Tensor], arity: int, idx: torch.Tensor):
    """Proofs of the leaves ``idx`` in one tree's levels ``[m, 16]``:
    positions ``[k, h] int32`` and siblings ``[k, h, arity - 1, 16]``;
    sibling j of a level is child j + (j >= position) of the group."""
    j = torch.arange(arity - 1, device=idx.device)
    positions, siblings = [], []
    idx = idx.to(torch.int64)
    for level in levels[:-1]:
        pos = idx % arity
        child = (idx - pos)[:, None] + j[None, :] + (j[None, :] >= pos[:, None])
        positions.append(pos)
        siblings.append(level[child])
        idx = idx // arity
    return (torch.stack(positions, dim=1).to(torch.int32),
            torch.stack(siblings, dim=1))


def _insert_at_position(current, pos, sibs, arity: int) -> torch.Tensor:
    """``[k, 16]`` current, ``[k]`` positions, ``[k, a - 1, 16]`` siblings
    -> ``[k, a, 16]`` groups: slot j holds the current node where j == pos,
    else sibling j - (j > pos), clamped to [0, a - 2]."""
    j = torch.arange(arity, device=current.device)
    p = pos.to(torch.int64)[:, None]
    idx = (j[None, :] - (j[None, :] > p).to(torch.int64)).clamp(0, arity - 2)
    gathered = torch.gather(sibs, 1, idx[..., None].expand(-1, -1, NDIGITS))
    return torch.where((j[None, :] == p)[..., None], current[:, None, :],
                       gathered)


def verify(h: Poseidon, positions, siblings, leaves, root, arity: int) -> torch.Tensor:
    """``[k] bool``: each proof's recomputed root equals ``root`` digit by
    digit (merkle_tree.cpp:214-254)."""
    current = leaves.to(DTYPE)
    for lvl in range(positions.shape[1]):
        group = _insert_at_position(current, positions[:, lvl],
                                    siblings[:, lvl].to(DTYPE), arity)
        current = h.hash_multiple(group)
    return (current == root.to(DTYPE)[None, :]).all(dim=-1)
