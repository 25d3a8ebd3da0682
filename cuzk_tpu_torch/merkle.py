"""N-ary (2-8) Merkle trees on Poseidon, on PyTorch tensors.

The counterpart of the build, proof and verify part of :mod:`cuzk_tpu.merkle`,
with the same semantics (merkle_tree.cpp:44-254):

- leaves are padded to the next power of arity with
  ``empty_hash(arity) = hash_multiple([0] * arity)``;
- each level hashes its arity groups with ``hash_multiple`` (ds=3);
- proofs are per level (position, arity-1 siblings), leaf to root;
- verification recomputes the root and compares it digit by digit.

Levels are ``[m, 16]`` int64 digit tensors on the leaves' device.  On a
CUDA device each level is one launch of the sponge kernel on limbs, driven
from the host, and verification is one launch of the fused verify kernel;
on the CPU the plain versions run.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from cuzk_tpu_torch import constants, poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda
from cuzk_tpu_torch.utils import errors

MIN_ARITY = constants.MIN_ARITY
MAX_ARITY = constants.MAX_ARITY
# merkle_tree.hpp:20 — the default config height (advisory, as in cuzk_tpu).
DEFAULT_TREE_HEIGHT = 20


@dataclass(frozen=True)
class MerkleConfig:
    """Runtime-validated tree config (merkle_tree.hpp:17-32)."""

    arity: int = 2
    tree_height: int = DEFAULT_TREE_HEIGHT

    def __post_init__(self):
        errors.validate_range(self.arity, MIN_ARITY, MAX_ARITY, "arity")


@functools.lru_cache(maxsize=None)
def _empty_hash_digits(arity: int, device: torch.device) -> torch.Tensor:
    """hash_multiple(arity zeros) as ``[16]`` digits on ``device``, hashed
    there once per arity (merkle_tree.cpp:347-357).  Callers copy it."""
    zeros = fr.zeros((1, arity), device=device)
    return poseidon_cuda.hash_multiple_cuda(zeros)[0]


def _device(device) -> torch.device:
    return torch.device("cpu") if device is None else torch.device(device)


def empty_hash_int(arity: int) -> int:
    """hash_multiple(arity zeros) as an int (merkle_tree.cpp:347-357)."""
    return fr.array_to_ints(_empty_hash_digits(arity, _device(None)))[0]


def padded_leaf_count(n: int, arity: int) -> int:
    """Next power of arity >= n, minimum 1 (merkle_tree.cpp:49-53)."""
    padded = 1
    while padded < n:
        padded *= arity
    return padded


def tree_height(leaf_count: int, arity: int) -> int:
    """Levels including the leaves, ceil(log_a(n)) + 1 in exact integer
    arithmetic (merkle_tree.cpp:359-367)."""
    padded, height = 1, 1
    while padded < leaf_count:
        padded *= arity
        height += 1
    return height


def calculate_max_leaves(height: int, arity: int) -> int:
    """``arity ** (height - 1)`` (merkle_tree.cpp:369-372)."""
    errors.validate_range(arity, MIN_ARITY, MAX_ARITY, "arity")
    if height < 1:
        raise errors.ValidationError(f"height must be >= 1, got {height}")
    return arity ** (height - 1)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _build_levels_cuda(padded: torch.Tensor, arity: int) -> List[torch.Tensor]:
    """Level loop on the card: the leaves convert to limbs once, and each
    level is one sponge launch over ``[g, arity, 8]`` limb groups."""
    level = fr.digits_to_limbs(padded).contiguous()
    levels = [padded]
    while level.shape[0] > 1:
        g = level.shape[0] // arity
        level = poseidon_cuda.sponge_limbs(
            level.view(g, arity, fr.NLIMBS), poseidon.DS_MULTIPLE
        )
        levels.append(fr.limbs_to_digits(level))
    return levels


def _build_levels_plain(padded: torch.Tensor, arity: int) -> List[torch.Tensor]:
    levels = [padded]
    level = padded
    while level.shape[0] > 1:
        level = poseidon.hash_multiple(level.reshape(-1, arity, fr.NDIGITS))
        levels.append(level)
    return levels


def build_tree_levels(leaves, arity: int = 2, device=None) -> List[torch.Tensor]:
    """All levels bottom-up from ``[n, 16]`` leaves: ``[level0 .. root]``,
    level0 the padded leaves.  ``device`` moves the leaves first; by default
    they stay where they are.  Empty input returns [] (merkle_tree.cpp:29-42)."""
    MerkleConfig(arity)
    leaves = fr.as_digits(leaves, device=device)
    n = leaves.shape[0]
    if n == 0:
        return []
    padded = padded_leaf_count(n, arity)
    if padded > n:
        pad = _empty_hash_digits(arity, leaves.device).expand(
            padded - n, fr.NDIGITS
        )
        leaves = torch.cat([leaves, pad], dim=0)
    if leaves.device.type == "cpu":
        return _build_levels_plain(leaves, arity)
    return _build_levels_cuda(leaves, arity)


def merkle_root(leaves, arity: int = 2, device=None) -> torch.Tensor:
    """Root digits ``[16]``; empty input gives empty_hash(arity)
    (merkle_tree.cpp:338-343)."""
    levels = build_tree_levels(leaves, arity, device)
    if not levels:
        return _empty_hash_digits(arity, _device(device)).clone()
    return levels[-1][0]


# ---------------------------------------------------------------------------
# Proofs
# ---------------------------------------------------------------------------

def _gather_proofs(arity: int, idx: torch.Tensor, levels):
    """Per level: each queried node's position in its group and its arity-1
    siblings (sibling j is child j + (j >= pos)).  Returns (positions
    ``[k, h] int32``, siblings ``[k, h, arity-1, 16]``)."""
    j = torch.arange(arity - 1, device=idx.device)
    positions, siblings = [], []
    for level in levels[:-1]:
        pos = idx % arity
        child = (idx - pos)[:, None] + j[None, :] + (j[None, :] >= pos[:, None])
        positions.append(pos)
        siblings.append(level[child])
        idx = idx // arity
    return (
        torch.stack(positions, dim=1).to(torch.int32),
        torch.stack(siblings, dim=1),
    )


def generate_proofs(levels: Sequence[torch.Tensor], arity: int, leaf_indices):
    """Batch Merkle proofs, leaf to root (merkle_tree.cpp:113-211): positions
    ``[k, h-1] int32`` and siblings ``[k, h-1, a-1, 16]``."""
    if not levels:
        raise IndexError("empty tree")
    device = levels[0].device
    idx = torch.as_tensor(leaf_indices, device=device).reshape(-1).to(torch.int64)
    n = int(levels[0].shape[0])
    if idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n:
            bad = idx[(idx < 0) | (idx >= n)]
            errors.validate_index(int(bad[0]), n, "leaf index")
    k = idx.shape[0]
    if len(levels) == 1:
        return (
            torch.zeros((k, 0), dtype=torch.int32, device=device),
            torch.zeros((k, 0, arity - 1, fr.NDIGITS), dtype=fr.DTYPE,
                        device=device),
        )
    return _gather_proofs(arity, idx, levels)


def generate_proof(levels, arity: int, leaf_index: int):
    """Single proof: (positions ``[h-1]``, siblings ``[h-1, a-1, 16]``)."""
    pos, sib = generate_proofs(levels, arity, [leaf_index])
    return pos[0], sib[0]


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------

def _insert_at_position(current, pos, sibs, arity: int) -> torch.Tensor:
    """``[k, 16]`` current + ``[k]`` positions + ``[k, a-1, 16]`` siblings ->
    ``[k, a, 16]`` groups: slot j holds the current node where j == pos,
    else sibling j - (j > pos) clamped to [0, a-2] (an out-of-range
    position drops the current node, as ``cuzk_tpu.merkle`` does)."""
    j = torch.arange(arity, device=current.device)
    p = pos.to(torch.int64)[:, None]
    idx = (j[None, :] - (j[None, :] > p).to(torch.int64)).clamp(0, arity - 2)
    gathered = torch.gather(sibs, 1, idx[..., None].expand(-1, -1, fr.NDIGITS))
    return torch.where((j[None, :] == p)[..., None], current[:, None, :],
                       gathered)


def _verify_plain(positions, siblings, leaves, root, arity: int) -> torch.Tensor:
    """Plain version of the verify kernel: all proofs level by level, one
    batched sponge per level, then a digit-wise compare with the root."""
    current = leaves
    for lvl in range(positions.shape[1]):
        group = _insert_at_position(
            current, positions[:, lvl], siblings[:, lvl], arity
        )
        current = poseidon.hash_multiple(group)
    return (current == root[None, :]).all(dim=-1)


def _verify_cuda(positions, siblings, leaves, root, arity: int) -> torch.Tensor:
    """The verify kernel on limbs, with the plain path's digit semantics:
    recomputed roots have canonical digits, so a root with a digit >= 2^16
    never verifies (the limbs would read it by value), and with h = 0 the
    leaf is compared with the root digit by digit, with no launch."""
    if positions.shape[1] == 0:
        return (leaves == root[None, :]).all(dim=-1)
    ok = poseidon_cuda.verify_limbs(
        positions.to(torch.int32).contiguous(),
        fr.digits_to_limbs(siblings).contiguous(),
        fr.digits_to_limbs(leaves).contiguous(),
        fr.digits_to_limbs(root).contiguous(),
        arity,
    )
    return ok & ((root >= 0) & (root <= fr.DIGIT_MASK)).all()


def verify_proofs(positions, siblings, leaves, root, arity: int) -> torch.Tensor:
    """Per-proof validity ``[k] bool`` (merkle_tree.cpp:214-254).
    ``positions [k, h]``, ``siblings [k, h, a-1, 16]``, ``leaves [k, 16]``,
    ``root [16]``, all on the leaves' device: the fused verify kernel on
    the card, the plain level-by-level path on the CPU."""
    errors.validate_range(arity, MIN_ARITY, MAX_ARITY, "arity")
    leaves = fr.as_digits(leaves)
    device = leaves.device
    positions = torch.as_tensor(positions, device=device)
    siblings = fr.as_digits(siblings, device=device)
    root = fr.as_digits(root, device=device)
    k, h = positions.shape
    if (
        tuple(siblings.shape) != (k, h, arity - 1, fr.NDIGITS)
        or tuple(leaves.shape) != (k, fr.NDIGITS)
        or tuple(root.shape) != (fr.NDIGITS,)
    ):
        raise errors.ValidationError(
            f"proof shapes disagree: positions {tuple(positions.shape)}, "
            f"siblings {tuple(siblings.shape)}, leaves {tuple(leaves.shape)}, "
            f"root {tuple(root.shape)}, arity {arity}"
        )
    if device.type == "cpu":
        return _verify_plain(positions, siblings, leaves, root, arity)
    return _verify_cuda(positions, siblings, leaves, root, arity)


def verify_proof(positions, siblings, leaf, root, arity: int) -> bool:
    """Single-proof verification."""
    leaf = fr.as_digits(leaf)
    ok = verify_proofs(
        torch.as_tensor(positions, device=leaf.device)[None],
        fr.as_digits(siblings, device=leaf.device)[None],
        leaf[None], root, arity,
    )
    return bool(ok[0])


# ---------------------------------------------------------------------------
# Object wrapper (merkle_tree.hpp:54-110)
# ---------------------------------------------------------------------------

class NaryMerkleTree:
    """Holds the level tensors and the config."""

    def __init__(self, leaves=None, config: MerkleConfig = MerkleConfig(),
                 device=None):
        self.config = config
        self.device = device
        self._levels: List[torch.Tensor] = []
        self._num_leaves = 0
        if leaves is not None:
            self.build_tree(leaves)

    @classmethod
    def from_levels(cls, levels, arity: int, num_leaves: int,
                    device=None) -> "NaryMerkleTree":
        """A tree from already built levels (e.g. a ``cuzk_tpu`` tree's
        levels as numpy ``uint32 [m, 16]``), without rehashing."""
        levels = [fr.as_digits(lv, device=device) for lv in levels]
        tree = cls(config=MerkleConfig(arity), device=device)
        if levels:
            sizes = [int(lv.shape[0]) for lv in levels]
            if sizes[-1] != 1 or any(
                a != b * arity for a, b in zip(sizes, sizes[1:])
            ):
                raise errors.ValidationError(
                    f"level sizes {sizes} are not a tree of arity {arity}"
                )
            errors.validate_range(num_leaves, 1, sizes[0], "num_leaves")
        tree._levels = levels
        tree._num_leaves = num_leaves if levels else 0
        return tree

    def build_tree(self, leaves) -> bool:
        leaves = fr.as_digits(leaves, device=self.device)
        self._num_leaves = int(leaves.shape[0])
        self._levels = build_tree_levels(leaves, self.config.arity)
        return bool(self._levels)

    @property
    def levels(self) -> List[torch.Tensor]:
        return self._levels

    def get_root_hash(self) -> torch.Tensor:
        if not self._levels:
            raise ValueError("tree is empty")
        return self._levels[-1][0]

    def root_int(self) -> int:
        return fr.array_to_ints(self.get_root_hash()[None, :])[0]

    def get_tree_height(self) -> int:
        return len(self._levels)

    def get_leaf_count(self) -> int:
        return self._num_leaves

    def generate_proof(self, leaf_index: int):
        return generate_proof(self._levels, self.config.arity, leaf_index)

    def generate_batch_proofs(self, leaf_indices):
        return generate_proofs(self._levels, self.config.arity, leaf_indices)

    def verify_proof(self, positions, siblings, leaf) -> bool:
        return verify_proof(
            positions, siblings, leaf, self.get_root_hash(), self.config.arity
        )

    def verify_batch_proofs(self, positions, siblings, leaves) -> bool:
        """All-or-nothing batch verification (merkle_tree_cuda.cu:464)."""
        return bool(
            verify_proofs(
                positions, siblings, leaves, self.get_root_hash(),
                self.config.arity,
            ).all()
        )


def optimal_arity(leaf_count: int) -> int:
    """CudaMerkleUtils::get_optimal_config_for_gpu (merkle_tree_cuda.cu:
    589-601): 2 below 1K leaves, 4 up to 100K, 8 above."""
    if leaf_count < 1_000:
        return 2
    if leaf_count <= 100_000:
        return 4
    return 8


def generate_test_leaves(count: int, seed: int = 42,
                         device=None) -> torch.Tensor:
    """Deterministic mt19937_64 leaves as ``[count, 16]`` digits
    (merkle_tree.cpp:443-457): one u64 draw per leaf."""
    draws = np.array(_mt19937_64(seed, count), dtype=np.uint64)
    digits = np.zeros((count, fr.NDIGITS), np.int64)
    for i in range(4):
        digits[:, i] = (draws >> np.uint64(16 * i)) & np.uint64(fr.DIGIT_MASK)
    return torch.as_tensor(digits, device=device)


def _mt19937_64(seed: int, count: int) -> List[int]:
    """The first ``count`` outputs of ``std::mt19937_64(seed)``."""
    n, m, mask = 312, 156, (1 << 64) - 1
    mt = [seed & mask]
    for i in range(1, n):
        mt.append((6364136223846793005 * (mt[-1] ^ (mt[-1] >> 62)) + i) & mask)
    out = []
    while len(out) < count:
        for i in range(n):  # the twist
            y = (mt[i] & 0xFFFFFFFF80000000) | (mt[(i + 1) % n] & 0x7FFFFFFF)
            mt[i] = mt[(i + m) % n] ^ (y >> 1) ^ (0xB5026F5AA96619E9 * (y & 1))
        for x in mt[: count - len(out)]:  # tempering
            x ^= (x >> 29) & 0x5555555555555555
            x ^= (x << 17) & 0x71D67FFFEDA60000
            x ^= (x << 37) & 0xFFF7EEE000000000
            out.append((x ^ (x >> 43)) & mask)
    return out
