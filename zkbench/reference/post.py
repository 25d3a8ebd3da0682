"""Filecoin WindowPoSt's partition check (rust-fil-proofs, storage-proofs-post
fallback ``verify_all_partitions``) on the reference Poseidon: the sparse
trees a partition's challenges open, and the verify of proofs each against
its own sector's root.

A sector's ``tree_r_last`` is an arity-a tree of ``levels`` levels above its
a^levels leaves.  Only the nodes on the paths of the sector's challenged
leaves are computed: a challenged leaf, and every child of an on-path group
that is itself on no path, is an element drawn from the seed by its place
(sector, level, index) alone; every on-path node above the leaves is the
ds = 3 hash of its a children.  So a sector's proofs share the nodes where
their paths meet and one root, the sector's ``comm_r_last``, and any subset
of sectors can be rebuilt alone, by any hasher, to the same elements.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from zkbench.reference import constants
from zkbench.reference import merkle as ref_merkle
from zkbench.reference.field import DTYPE, NDIGITS
from zkbench.reference.poseidon import GRAPH_STATES, Poseidon

_M32 = (1 << 32) - 1
_M16 = (1 << 16) - 1
# A top digit below p's keeps an element canonical (< p).
P_TOP_DIGIT = constants.P >> 240


def _mul32(x, c: int):
    """``x * c mod 2^32`` for x < 2^32, in products below 2^48, so that no
    int64 product overflows."""
    return ((x & _M16) * c + ((((x >> 16) * c) & _M16) << 16)) & _M32


def _hash32(x):
    """A 32-bit integer hash (lowbias32: xor-shift, multiply, twice) of
    x < 2^32; tensors and ints alike."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seeded_elements(seed: int, keys: torch.Tensor) -> torch.Tensor:
    """``[*keys.shape, 16]`` canonical elements, each a function of
    ``(seed, key)`` alone (``0 <= key < 2^63``), on the keys' device."""
    seed &= (1 << 63) - 1
    keys = keys.to(DTYPE)
    h = _hash32((keys & _M32) ^ _hash32(seed & _M32))
    h = _hash32(h ^ (keys >> 32) ^ _hash32(seed >> 32))
    words = torch.stack([_hash32(h ^ _hash32(w + 1))
                         for w in range(NDIGITS // 2)], dim=-1)
    digits = torch.stack([words & _M16, words >> 16], dim=-1).flatten(-2)
    digits[..., -1] %= P_TOP_DIGIT
    return digits


def node_keys(flat: torch.Tensor, level: int, arity: int,
              levels: int) -> torch.Tensor:
    """The seed keys of level-``level`` nodes given as flat ids
    ``sector * arity^(levels - level) + index``: unique over every sector,
    level and index."""
    span = arity ** (levels - level)
    sector, index = flat // span, flat % span
    return (sector * (levels + 1) + level) * arity ** levels + index


def sparse_proofs(hash_groups: Callable[[torch.Tensor], torch.Tensor],
                  seed: int, sectors: torch.Tensor, idx: torch.Tensor,
                  arity: int, levels: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The proofs of the challenged leaves ``idx [n, c]`` (each in
    [0, arity^levels)) of the sectors ``sectors [n]``, in sparse trees
    built level by level, every on-path group hashed by ``hash_groups``
    (``[g, arity, 16] -> [g, 16]``, ds = 3).  Returns ``positions [n * c,
    levels] int32``, ``siblings [n * c, levels, arity - 1, 16]``, ``leaves
    [n * c, 16]`` (proof ``i * c + j`` opens ``idx[i, j]``) and ``roots
    [n, 16]``.  Sibling j of a level is child j + (j >= position) of the
    group, as ``merkle.gather_proofs`` takes them."""
    dev = idx.device
    sectors = sectors.to(device=dev, dtype=DTYPE)
    path = (sectors[:, None] * arity ** levels + idx.to(DTYPE)).reshape(-1)
    ids = torch.unique(path)
    vals = seeded_elements(seed, node_keys(ids, 0, arity, levels))
    leaves = vals[torch.searchsorted(ids, path)]
    positions = torch.empty((path.shape[0], levels), dtype=torch.int32,
                            device=dev)
    siblings = torch.empty((path.shape[0], levels, arity - 1, NDIGITS),
                           dtype=DTYPE, device=dev)
    j = torch.arange(arity - 1, device=dev)
    for lvl in range(levels):
        parents = torch.unique(ids // arity)
        children = parents[:, None] * arity + torch.arange(arity, device=dev)
        group = seeded_elements(seed, node_keys(children, lvl, arity, levels))
        at = torch.searchsorted(ids, children).clamp(max=ids.shape[0] - 1)
        on = ids[at] == children
        group[on] = vals[at[on]]
        pos = path % arity
        row = torch.searchsorted(parents, path // arity)
        positions[:, lvl] = pos.to(torch.int32)
        slot = j[None, :] + (j[None, :] >= pos[:, None])
        siblings[:, lvl] = group[row[:, None], slot]
        vals = hash_groups(group)
        ids, path = parents, path // arity
    roots = vals[torch.searchsorted(ids, sectors)]
    return positions, siblings, leaves, roots


def verify(h: Poseidon, positions, siblings, leaves, roots,
           arity: int, block: int = GRAPH_STATES) -> torch.Tensor:
    """``[k] bool``: each proof's recomputed root equals its own root
    ``roots [k, 16]`` digit by digit (merkle_tree.cpp:214-254), in blocks
    of ``block`` proofs (a card replays the captured permutation for each
    block)."""
    out = []
    for i in range(0, positions.shape[0], block):
        current = leaves[i:i + block].to(DTYPE)
        for lvl in range(positions.shape[1]):
            group = ref_merkle._insert_at_position(
                current, positions[i:i + block, lvl],
                siblings[i:i + block, lvl].to(DTYPE), arity)
            current = h.hash_multiple(group)
        out.append((current == roots[i:i + block].to(DTYPE)).all(dim=-1))
    return torch.cat(out)
