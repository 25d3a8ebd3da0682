"""N-ary (2-8) Merkle trees on Poseidon, on PyTorch tensors.

The counterpart of :mod:`cuzk_tpu.merkle`, with the same semantics
(merkle_tree.cpp:44-254):

- leaves are padded to the next power of arity with
  ``empty_hash(arity) = hash_multiple([0] * arity)``;
- each level hashes its arity groups with ``hash_multiple`` (ds=3);
- proofs are per level (position, arity-1 siblings), leaf to root;
- verification recomputes the root and compares it digit by digit.

Levels are ``[m, 16]`` int64 digit tensors on the leaves' device.  On a
CUDA device each level is one launch of the sponge kernel on limbs, driven
from the host, and per-proof verification is one launch of the fused
verify kernel on the proofs' digits; on the CPU the plain versions run.
Host data (numpy, lists) with no ``device`` goes to the card, and raises
without one: the CPU runs only for ``device="cpu"`` or tensors on the CPU
(:func:`~cuzk_tpu_torch.utils.device.resolve_device`).
:func:`engine_path` forces the plain versions on the card (``"plain"``),
or the kernels (``"kernel"``, which raises on CPU tensors), for the level
loops of builds, updates and verification.

Beyond build, proofs and per-proof verify: the deduplicated batch verify
with per-proof failure isolation (:func:`verify_each`, :func:`verify_all`:
a host numpy schedule, one packed upload, a device program of sponge
launches), incremental leaf updates, batch builds, save/load and the
MerkleUtils helpers.

Under a ``torch.profiler`` session, :func:`build_tree_levels` and
:func:`verify_each` are root spans of :mod:`cuzk_tpu_torch.utils.trace`
(one a request), with ``cuzk.build.pad``, ``cuzk.verify_proofs`` and
``cuzk.verify.readback`` (the host waiting on the device) inside them, and
each :func:`verify_each` counts its route (``verify.route.*``).
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cuzk_tpu_torch import constants, native, oracle, poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda
from cuzk_tpu_torch.utils import errors, trace
from cuzk_tpu_torch.utils.device import resolve_device
from cuzk_tpu_torch.utils.stats import TreeBenchmarkResult

MIN_ARITY = constants.MIN_ARITY
MAX_ARITY = constants.MAX_ARITY
# merkle_tree.hpp:20 — the default config height (advisory, as in cuzk_tpu).
DEFAULT_TREE_HEIGHT = 20


# ---------------------------------------------------------------------------
# The hash engine of the host-driven level loops
# ---------------------------------------------------------------------------

ENGINE_PATHS = ("plain", "kernel")
_PATH_OVERRIDE: List[str] = []


@contextlib.contextmanager
def engine_path(path: str):
    """Force the hash engine of tree building, updates and verification:
    ``"plain"`` (the plain PyTorch sponge and verify, on whatever device
    the tensors lie, the card included) or ``"kernel"`` (K1 and K3; on CPU
    tensors it raises, it never falls back).  Overrides nest; the innermost
    wins and is popped on exit, exceptions included.  With no override the
    route follows the device: the kernels on a card, the plain versions on
    the CPU.  The counterpart of ``cuzk_tpu.merkle.engine_path`` (``"jnp"``
    and ``"pallas"`` there), for the benchmark's plain-against-accelerated
    comparison (merkle_tree_cuda.cu:648-856)."""
    if path not in ENGINE_PATHS:
        raise errors.ValidationError(
            f"engine path must be one of {ENGINE_PATHS}, got {path!r}")
    _PATH_OVERRIDE.append(path)
    try:
        yield
    finally:
        _PATH_OVERRIDE.pop()


def _engine(device: torch.device) -> str:
    """The engine on ``device``: the innermost :func:`engine_path`, else
    ``"kernel"`` on a card and ``"plain"`` on the CPU.  Raises when the
    kernels are forced on the CPU."""
    if not _PATH_OVERRIDE:
        return "plain" if device.type == "cpu" else "kernel"
    path = _PATH_OVERRIDE[-1]
    if path == "kernel" and device.type == "cpu":
        raise errors.ValidationError(
            'engine_path("kernel") needs tensors on a CUDA device; the CPU '
            "has only the plain path")
    return path


def _engine_hash_multiple(groups: torch.Tensor) -> torch.Tensor:
    """``[g, n, 16]`` digit groups -> ``[g, 16]`` hashes (ds=3) on the
    engine :func:`_engine` picks for their device: K1, or the plain
    sponge."""
    if _engine(groups.device) == "kernel":
        return poseidon_cuda.hash_multiple_cuda(groups)
    return poseidon.hash_multiple(groups)


@dataclass(frozen=True)
class MerkleConfig:
    """Runtime-validated tree config (merkle_tree.hpp:17-32)."""

    arity: int = 2
    tree_height: int = DEFAULT_TREE_HEIGHT

    def __post_init__(self):
        errors.validate_range(self.arity, MIN_ARITY, MAX_ARITY, "arity")


@functools.lru_cache(maxsize=None)
def empty_hash_int(arity: int) -> int:
    """hash_multiple(arity zeros) as an int (merkle_tree.cpp:347-357), from
    the oracle, once per arity."""
    return oracle.empty_hash(arity)


@functools.lru_cache(maxsize=None)
def _empty_hash_digits(arity: int, device: torch.device) -> torch.Tensor:
    """:func:`empty_hash_int` as ``[16]`` digits on ``device``, once per
    arity and device.  Callers copy it."""
    return torch.as_tensor(
        fr.int_to_digits(empty_hash_int(arity)).astype(np.int64), device=device
    )


padded_leaf_count = oracle.padded_leaf_count
tree_height = oracle.tree_height


def calculate_max_leaves(height: int, arity: int) -> int:
    """``arity ** (height - 1)`` (merkle_tree.cpp:369-372)."""
    errors.validate_range(arity, MIN_ARITY, MAX_ARITY, "arity")
    if height < 1:
        raise errors.ValidationError(f"height must be >= 1, got {height}")
    return arity ** (height - 1)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _build_levels_cuda(padded: torch.Tensor, arity: int,
                       trees: int = 1) -> List[torch.Tensor]:
    """Level loop on the card, one sponge launch a level: the first reads
    the leaves' ``[g, arity, 16]`` digit groups as they are (no copy of
    contiguous leaves, no conversion), each above it the ``[g, arity, 8]``
    limb groups of the level below.  ``padded`` holds ``trees`` equal trees
    side by side; the loop stops at their roots."""
    levels = [padded]
    level, width = padded.contiguous(), fr.NDIGITS
    sponge = poseidon_cuda.sponge_digits
    while level.shape[0] > trees:
        g = level.shape[0] // arity
        level = sponge(level.view(g, arity, width), poseidon.DS_MULTIPLE)
        levels.append(fr.limbs_to_digits(level))
        sponge, width = poseidon_cuda.sponge_limbs, fr.NLIMBS
    return levels


def _build_levels(padded: torch.Tensor, arity: int,
                  trees: int = 1) -> List[torch.Tensor]:
    """All levels of ``trees`` trees whose padded leaves lie side by side
    in ``padded`` (each a power of arity, so no group crosses two trees).
    The kernel engine (:func:`_engine`) keeps the levels in limbs between
    K1 launches (:func:`_build_levels_cuda`); the plain one runs the plain
    sponge a level."""
    if _engine(padded.device) == "kernel":
        return _build_levels_cuda(padded, arity, trees)
    levels = [padded]
    level = padded
    while level.shape[0] > trees:
        level = poseidon.hash_multiple(level.reshape(-1, arity, fr.NDIGITS))
        levels.append(level)
    return levels


def build_tree_levels(leaves, arity: int = 2, device=None) -> List[torch.Tensor]:
    """All levels bottom-up from ``[n, 16]`` leaves: ``[level0 .. root]``,
    level0 the padded leaves.  ``device`` moves the leaves first; by default
    tensors stay where they are and host data goes to the card.  Empty
    input returns [] (merkle_tree.cpp:29-42)."""
    with trace.span("build_tree_levels"):
        MerkleConfig(arity)
        leaves = fr.as_digits(leaves, device=resolve_device(device, leaves))
        n = leaves.shape[0]
        if n == 0:
            return []
        padded = padded_leaf_count(n, arity)
        if padded > n:
            with trace.span("build.pad"):
                pad = _empty_hash_digits(arity, leaves.device).expand(
                    padded - n, fr.NDIGITS
                )
                leaves = torch.cat([leaves, pad], dim=0)
        return _build_levels(leaves, arity)


def merkle_root(leaves, arity: int = 2, device=None) -> torch.Tensor:
    """Root digits ``[16]``; empty input gives empty_hash(arity)
    (merkle_tree.cpp:338-343)."""
    levels = build_tree_levels(leaves, arity, device)
    if not levels:
        return _empty_hash_digits(arity, resolve_device(device, leaves)).clone()
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
    """``[k, w]`` current + ``[k]`` positions + ``[k, a-1, w]`` siblings ->
    ``[k, a, w]`` groups: slot j holds the current node where j == pos,
    else sibling j - (j > pos) clamped to [0, a-2] (an out-of-range
    position drops the current node, as ``cuzk_tpu.merkle`` does).  ``w``
    is 16 for digits and 8 for the kernels' limbs."""
    j = torch.arange(arity, device=current.device)
    p = pos.to(torch.int64)[:, None]
    idx = (j[None, :] - (j[None, :] > p).to(torch.int64)).clamp(0, arity - 2)
    gathered = torch.gather(
        sibs, 1, idx[..., None].expand(-1, -1, current.shape[-1])
    )
    return torch.where((j[None, :] == p)[..., None], current[:, None, :],
                       gathered)


def _verify_plain(positions, siblings, leaves, root, arity: int) -> torch.Tensor:
    """Plain version of the verify kernel: all proofs level by level, one
    batched sponge per level, then a digit-wise compare with the root,
    ``[16]`` for every proof or ``[k, 16]`` row by row."""
    current = leaves
    for lvl in range(positions.shape[1]):
        group = _insert_at_position(
            current, positions[:, lvl], siblings[:, lvl], arity
        )
        current = poseidon.hash_multiple(group)
    return (current == root).all(dim=-1)


def _verify_cuda(positions, siblings, leaves, root, arity: int) -> torch.Tensor:
    """The verify kernel on the proofs' digits as they lie on the card, with
    the plain path's digit semantics: the kernel reads the leaf and siblings
    by value and compares the root digit by digit with the recomputed
    digest's canonical digits, so a root with a digit outside [0, 2^16)
    never verifies; with h = 0 the leaf is compared with the root digit by
    digit, with no launch.  One launch whether ``root`` is ``[16]`` or
    ``[k, 16]``.  Int32 positions go to the kernel as they are (it clamps
    them to [-1, arity]); others are clamped before the int32 cast, so that
    a position 2^32 + p does not alias p."""
    if positions.shape[1] == 0:
        return (leaves == root).all(dim=-1)
    return poseidon_cuda.verify_digits(
        positions.contiguous(), siblings.contiguous(), leaves.contiguous(),
        root.contiguous(), arity)


def _check_proof_shapes(positions, siblings, leaves, root, arity: int) -> None:
    """Raise unless the shapes are positions ``[k, h]``, siblings
    ``[k, h, arity-1, 16]``, leaves ``[k, 16]`` and root ``[16]`` (one root
    for every proof) or ``[k, 16]`` (a root a proof)."""
    if len(positions.shape) != 2:
        raise errors.ValidationError(
            f"positions must be [k, h], got {tuple(positions.shape)}"
        )
    k, h = positions.shape
    if (
        tuple(siblings.shape) != (k, h, arity - 1, fr.NDIGITS)
        or tuple(leaves.shape) != (k, fr.NDIGITS)
        or tuple(root.shape) not in ((fr.NDIGITS,), (k, fr.NDIGITS))
    ):
        raise errors.ValidationError(
            f"proof shapes disagree: positions {tuple(positions.shape)}, "
            f"siblings {tuple(siblings.shape)}, leaves {tuple(leaves.shape)}, "
            f"root {tuple(root.shape)}, arity {arity}"
        )


def verify_proofs(positions, siblings, leaves, root, arity: int,
                  device=None) -> torch.Tensor:
    """Per-proof validity ``[k] bool`` (merkle_tree.cpp:214-254).
    ``positions [k, h]``, ``siblings [k, h, a-1, 16]``, ``leaves [k, 16]``,
    ``root [16]`` (every proof against one root) or ``[k, 16]`` (proof i
    against row i: proofs of many trees in one call), all moved to
    ``device``, else to the leaves' device (the first tensor's, the card
    for host data): the fused verify kernel on the card, the plain
    level-by-level path on the CPU."""
    with trace.span("verify_proofs"):
        errors.validate_range(arity, MIN_ARITY, MAX_ARITY, "arity")
        device = resolve_device(device, leaves, positions, siblings, root)
        leaves = fr.as_digits(leaves, device=device)
        positions = torch.as_tensor(positions, device=device)
        siblings = fr.as_digits(siblings, device=device)
        root = fr.as_digits(root, device=device)
        _check_proof_shapes(positions, siblings, leaves, root, arity)
        if _engine(device) == "plain":
            return _verify_plain(positions, siblings, leaves, root, arity)
        return _verify_cuda(positions, siblings, leaves, root, arity)


def verify_proof(positions, siblings, leaf, root, arity: int,
                 device=None) -> bool:
    """Single-proof verification (``root`` ``[16]`` or ``[1, 16]``)."""
    leaf = fr.as_digits(leaf, device=resolve_device(device, leaf, positions,
                                                    siblings, root))
    ok = verify_proofs(
        torch.as_tensor(positions, device=leaf.device)[None],
        fr.as_digits(siblings, device=leaf.device)[None],
        leaf[None], root, arity,
    )
    return bool(ok[0])


# ---------------------------------------------------------------------------
# Deduplicated batch verification with per-proof failure isolation
# (the counterpart of cuzk_tpu/merkle.py:343-1046).
#
# Proofs of one tree share their upper nodes: two recomputation chains meet
# at level L exactly when their suffixes positions[:, L:] and
# siblings[:, L:] are identical, which the host sees before any hashing.
# The host builds that merge forest with exact grouping (native/), packs it
# into one uint32 buffer, and the device hashes each unique node once,
# checking at every merge point that the entering values agree.  When every
# check passes, the shared chain IS each proof's own recomputation, so the
# result equals the per-proof semantics (merkle_tree_cuda.cu:67-118) bit for
# bit.  A failed check marks the proofs whose chains touch it, and only those
# re-verify on the exact per-proof path.  At the reference's 5K-proof config
# this hashes about 6.7K unique groups instead of 40K.
#
# The job and table counts are padded to the JAX package's buckets, so the
# packed buffer is byte-equal to ``cuzk_tpu.merkle._dedup_pack``'s.
# ---------------------------------------------------------------------------

def _job_bucket(u: int) -> int:
    """Job counts pad to powers of two up to 1024, then to multiples of
    1024 (the JAX package's executable buckets)."""
    if u >= 1024:
        return ((u + 1023) // 1024) * 1024
    return max(8, 1 << (u - 1).bit_length())


def _table_bucket(u: int) -> int:
    """Value-table lengths pad to powers of two up to 1024, then to
    multiples of 256."""
    if u >= 1024:
        return ((u + 255) // 256) * 256
    return max(64, 1 << (u - 1).bit_length())


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to ``n`` by replicating row 0 (padded jobs recompute job
    0's work, so every check on them is vacuously true)."""
    if a.shape[0] == n:
        return a
    reps = np.broadcast_to(a[:1], (n - a.shape[0],) + a.shape[1:])
    return np.concatenate([a, reps], axis=0)


def _in_range(a: np.ndarray, hi: int) -> bool:
    """Every value of the integer array ``a`` lies in [0, hi], read as the
    integer it is (before any cast to a narrower type)."""
    if a.size == 0:
        return True
    if a.dtype.kind not in "ui":
        return False
    return int(a.max()) <= hi and (a.dtype.kind == "u" or int(a.min()) >= 0)


def _dedup_schedule(positions: np.ndarray, siblings: np.ndarray,
                    leaves: np.ndarray):
    """Host merge schedule (numpy and the native grouper, no hash values).
    ``positions`` int32 ``[k, h]`` in [0, arity), ``siblings`` uint32
    ``[k, h, a-1, 16]``, ``leaves`` uint32 ``[k, 16]``, all range-gated.

    Level 0 is content-keyed: each job is a unique reconstructed leaf group
    ``insert(leaf, pos, row)``, which merges the up-to-arity proofs of one
    group.  Levels >= 1 are suffix-keyed: two proofs share a level-L job
    only when (positions[:, L:], siblings[:, L:]) are identical, computed
    root-down as exact (parent-suffix group, row group, position) triples.

    Returns ``(content, j0, upper, m1, iso)`` as
    ``cuzk_tpu.merkle._dedup_schedule`` does: ``content`` the bucketed
    ``[n0b, arity, 16]`` unique level-0 groups; ``j0[i]`` proof i's
    level-0 job; ``upper[L-1] = (ent_idx, pos, sibs, checks)`` the bucketed
    job arrays of level L >= 1 (``checks`` for L >= 2: for each level-L-1
    job, the job whose output its parent used); ``m1[i]`` proof i's level-1
    job (``None`` when h == 1); ``iso = (keys, counts, parents)`` the
    proof->job chain map for failure isolation."""
    k, h = positions.shape
    arity = siblings.shape[2] + 1
    sib_u64 = siblings.reshape(k, h, -1).view("<u8")

    pos0 = positions[:, 0]
    content = np.empty((k, arity, fr.NDIGITS), np.uint32)
    j = np.arange(arity - 1)
    col = j[None, :] + (j[None, :] >= pos0[:, None])  # sibling j's column
    content[np.arange(k)[:, None], col] = siblings[:, 0]
    content[np.arange(k), pos0] = leaves[:k]
    cfirst, j0 = native.group_rows(content.reshape(k, -1))
    content_b = _pad_rows(content[cfirst], _job_bucket(len(cfirst)))

    if h == 1:
        return content_b, j0, [], None, ([j0], (len(cfirst),), {})

    gid = np.zeros(k, np.int32)
    ident = np.arange(k, dtype=np.int32)
    saturated = False  # every proof already its own suffix group?
    reps: List[Optional[np.ndarray]] = [None] * h
    keys: List[Optional[np.ndarray]] = [None] * h
    for L in range(h - 1, 0, -1):
        if saturated:
            # suffix_L refines suffix_{L+1}, which already separates all k
            # proofs: every class stays a singleton.
            reps[L], keys[L] = ident, ident
            continue
        _, rid = native.group_rows(sib_u64[:, L])
        reps[L], keys[L] = native.group_triples(gid, rid, positions[:, L])
        gid = keys[L]
        saturated = len(reps[L]) == k

    keys[0] = j0
    upper = []
    parents = {}
    for L in range(1, h):
        r = reps[L]
        ub = _job_bucket(len(r))
        # Entering value = output of the rep proof's level-L-1 job.
        ent_idx = _pad_rows(keys[L - 1][r].reshape(-1, 1), ub).ravel()
        pos = _pad_rows(positions[r, L], ub)
        sibs = _pad_rows(siblings[r, L], ub)
        # A suffix job has exactly one parent, so one check per level-L-1
        # job covers every edge; level-0 content jobs can have many parents
        # and are checked per proof through m1.
        checks = np.zeros(0, np.int32)
        if L > 1:
            parent = keys[L][reps[L - 1]]  # level-L job of each L-1 job
            parents[L - 1] = parent
            checks = _pad_rows(
                ent_idx[parent].reshape(-1, 1), _job_bucket(len(parent))
            ).ravel()
        upper.append((ent_idx, pos, sibs, checks))

    counts = (len(cfirst),) + tuple(len(reps[L]) for L in range(1, h))
    return content_b, j0, upper, keys[1], (list(keys), counts, parents)


class _Wire(NamedTuple):
    """A packed dedup schedule ready for upload.  ``sizes``/``kb``/``tb``/
    ``lm16`` shape the device program (bucketed job counts, proof bucket,
    value-table bucket, lidx|m1 word packing); ``packed`` is the single
    uint32 upload buffer (layout on :func:`_dedup_verify_levels`); ``iso``
    is the host-only proof->job chain map (:func:`_suspect_mask`)."""

    sizes: tuple
    kb: int
    tb: int
    lm16: bool
    packed: np.ndarray
    iso: tuple


def _dedup_pack(positions, siblings, leaves, root, arity: int):
    """Host phase of the deduplicated verify: range gates, schedule,
    value-table dedup and packing into one buffer.  Returns a
    :class:`_Wire`, or ``None`` when the dedup path cannot soundly decide
    and the exact per-proof path must.

    The gates read every value as the integer it is, before any cast (the
    port holds digits and positions as int64, so 2^32 + d would become d in
    uint32): a digit outside [0, 2^16) would alias in the two-per-word
    packing, a position outside [0, arity) could alias two suffixes or
    groups (the keys and the jp word pack it in 3 bits), arity > 8 does
    not fit those 3 bits, and k >= 2^28 does not fit j0 in jp."""
    positions, siblings = np.asarray(positions), np.asarray(siblings)
    leaves, root = np.asarray(leaves), np.asarray(root)
    k = positions.shape[0]
    if (
        arity > MAX_ARITY
        or k >= 1 << 28
        or not _in_range(positions, arity - 1)
        or not _in_range(leaves, fr.DIGIT_MASK)
        or not _in_range(root, fr.DIGIT_MASK)
        or not _in_range(siblings, fr.DIGIT_MASK)
    ):
        return None
    positions = positions.astype(np.int32)
    siblings = np.ascontiguousarray(siblings, np.uint32)
    leaves = np.ascontiguousarray(leaves[:k], np.uint32)
    root = root.astype(np.uint32)
    content, j0, upper, m1, iso = _dedup_schedule(positions, siblings, leaves)
    kb = _job_bucket(k)
    sizes = (content.shape[0],) + tuple(lvl[1].shape[0] for lvl in upper)

    # Value table: every 256-bit value on the wire (content members, upper
    # sibling nodes, claimed leaves) once, with u32 table indices in their
    # place.  The claimed leaves' indices (lidx) come from a direct lookup
    # and the content's (cidx) from the group scatter, so the device's
    # binding compare re-checks the host's merge by independent paths.
    V = np.concatenate(
        [content.reshape(-1, fr.NDIGITS)]
        + [lvl[2].reshape(-1, fr.NDIGITS) for lvl in upper]
        + [leaves],
        axis=0,
    )
    vfirst, vinv = native.group_rows(V)
    tb = _table_bucket(len(vfirst))
    vinv = vinv.astype(np.uint32)
    e0 = content.shape[0] * arity
    eu = sum(lvl[2].shape[0] for lvl in upper) * (arity - 1)
    cidx, sidx, lidx = vinv[:e0], vinv[e0:e0 + eu], vinv[e0 + eu:]

    # j0 and pos0 share a word (pos0 < 8, j0 < 2^28); lidx and m1 share one
    # when lidx < 2^15 (the device reads the words as int32, so the packed
    # word stays below 2^31) and m1 < 2^16.
    jp = (j0.astype(np.uint32) << np.uint32(3)) | positions[:, 0].astype(
        np.uint32
    )
    parts = [
        fr.pack16_host(_pad_rows(V[vfirst], tb)).ravel(),
        fr.pack16_host(root).ravel(),
        _pad_rows(jp.reshape(-1, 1), kb).ravel(),
    ]
    lm16 = False
    lidx_b = _pad_rows(lidx.reshape(-1, 1), kb).ravel()
    if m1 is None:
        parts.append(lidx_b)
    else:
        m1_b = _pad_rows(m1.reshape(-1, 1), kb).ravel().astype(np.uint32)
        lm16 = len(vfirst) < (1 << 15) and int(m1_b.max(initial=0)) < (1 << 16)
        if lm16:
            parts.append((lidx_b << np.uint32(16)) | m1_b)
        else:
            parts.append(lidx_b)
            parts.append(m1_b)
    for ent_idx, pos, _sibs, _checks in upper:
        parts.append(ent_idx.astype(np.uint32))
        parts.append(pos.astype(np.uint32))
    for _ent, _pos, _sibs, checks in upper[1:]:
        parts.append(checks.astype(np.uint32))
    parts.append(cidx)
    parts.append(sidx)
    return _Wire(sizes, kb, tb, lm16, np.concatenate(parts), iso)


def _upload(packed: np.ndarray, device: torch.device) -> torch.Tensor:
    """The packed buffer as int32 words on ``device``: one pinned,
    non-blocking copy to a card; a view of the same memory on the CPU."""
    words = torch.from_numpy(packed.view(np.int32))
    if device.type == "cpu":
        return words
    return words.pin_memory().to(device, non_blocking=True)


def _dedup_verify_levels(arity: int, sizes: tuple, kb: int, tb: int,
                         lm16: bool, packed: torch.Tensor):
    """Device program: one sponge per unique node touched, level by level,
    with the merge checks folded into two flags and kept as masks.

    ``packed`` is the wire as int32 words on the device:
    ``[value table (tb x 8) | root (8) | idx section | cidx (n0 x arity) |
    sidx (sum n_L x (arity-1), L >= 1)]``.  The table and root words are
    ``fr.pack16`` words, which on the kernel engine are K1's limbs as
    they stand; on the plain engine (:func:`_engine`: the CPU, or an
    ``engine_path("plain")`` override) they unpack to digits and the plain
    sponge runs (the plain version).  The idx section is ``[jp (kb: j0 << 3 | pos0) | lm (h == 1:
    lidx; lm16: lidx << 16 | m1; else lidx then m1) | per level L >= 1:
    ent_idx(n_L) pos(n_L) | per level L >= 2: checks(n_{L-1})]``.

    Checks: the leaf binding (``cidx[j0, pos0] == lidx``: table indices, so
    an integer compare is value equality), the level-0 edges per proof
    (``out0[j0] == out0[ent_idx1[m1]]``), each level-L job's output
    against the entering value its parent used, and the root.  Returns
    ``(flags, bad)``: ``flags = [checks_ok, roots_ok]``; ``bad = [per-proof
    (kb) | per-job check fails (sizes[1..h-2]) | per-job root fails
    (sizes[h-1])]``, all bool tensors on the device."""
    hw = fr.NDIGITS // 2
    h = len(sizes)
    n0 = sizes[0]
    upper_sizes = sizes[1:]
    total_upper = sum(upper_sizes)
    per_proof = 2 if (h == 1 or lm16) else 3
    idx_len = (
        per_proof * kb
        + sum(2 * n for n in upper_sizes)
        + sum(sizes[L - 1] for L in range(2, h))
    )
    o = tb * hw
    table, root = packed[:o].view(tb, hw), packed[o:o + hw]
    if _engine(packed.device) == "plain":
        table, root = fr.unpack16(table), fr.unpack16(root)
        hash_groups = _engine_hash_multiple
    else:
        def hash_groups(groups):
            return poseidon_cuda.sponge_limbs(groups.contiguous(),
                                              poseidon.DS_MULTIPLE)
    o += hw
    idx_all = packed[o:o + idx_len].long()
    o += idx_len
    cidx = packed[o:o + n0 * arity].long().view(n0, arity)
    o += n0 * arity
    sidx = packed[o:o + total_upper * (arity - 1)].long().view(
        total_upper, arity - 1
    )

    jp = idx_all[:kb]
    j0, pos0 = jp >> 3, jp & 7
    io = kb
    m1 = None
    if h == 1:
        lidx = idx_all[io:io + kb]
        io += kb
    elif lm16:
        w = idx_all[io:io + kb]
        lidx, m1 = w >> 16, w & 0xFFFF
        io += kb
    else:
        lidx, m1 = idx_all[io:io + kb], idx_all[io + kb:io + 2 * kb]
        io += 2 * kb
    ents, poss = [], []
    for n in upper_sizes:
        ents.append(idx_all[io:io + n])
        poss.append(idx_all[io + n:io + 2 * n])
        io += 2 * n
    checks = {}
    for L in range(2, h):
        checks[L] = idx_all[io:io + sizes[L - 1]]
        io += sizes[L - 1]

    out = hash_groups(table[cidx])  # [n0, w]
    proof_bad = cidx[j0, pos0] != lidx
    if h > 1:
        proof_bad = proof_bad | (out[j0] != out[ents[0][m1]]).any(dim=-1)
    ok = ~proof_bad.any()
    check_bads = []
    so = 0
    for i, n in enumerate(upper_sizes):
        sibs = table[sidx[so:so + n]]  # [n, arity-1, w]
        so += n
        new_out = hash_groups(
            _insert_at_position(out[ents[i]], poss[i], sibs, arity)
        )
        if i + 2 < h:
            cb = (new_out != new_out[checks[i + 2]]).any(dim=-1)
            check_bads.append(cb)
            ok = ok & ~cb.any()
        out = new_out
    root_bad = (out != root[None, :]).any(dim=-1)
    flags = torch.stack([ok, ~root_bad.any()])
    return flags, torch.cat([proof_bad, *check_bads, root_bad])


def _suspect_mask(bad: np.ndarray, wire: _Wire, k: int):
    """Map the device's failure mask back to proofs: ``(suspects,
    root_false)``, both ``[k] bool``.

    A proof is a suspect when its chain touches a failed binding, edge or
    merge check; only exact re-verification decides it.  A failed merge
    check at level-L job j means its parent consumed an entering value of
    disputed provenance, so every proof routed through that parent is
    marked.  A non-suspect proof whose last-level job missed the root is
    ``root_false``: its chain is check-clean, so the shared recomputation
    is its own and the mismatch is final.  Padded rows replicate index 0,
    so slicing to the real counts never drops a failure."""
    sizes, kb = wire.sizes, wire.kb
    keys, counts, parents = wire.iso
    h = len(sizes)
    suspects = bad[:kb][:k].copy()
    off = kb
    for ell in range(1, h - 1):
        seg = bad[off:off + sizes[ell]][:counts[ell]]
        off += sizes[ell]
        bj = np.flatnonzero(seg)
        if len(bj):
            suspects |= np.isin(keys[ell + 1], parents[ell][bj])
    seg = bad[off:off + sizes[h - 1]][:counts[h - 1]]
    bj = np.flatnonzero(seg)
    root_false = np.zeros(k, bool)
    if len(bj):
        root_false = np.isin(keys[h - 1], bj) & ~suspects
    return suspects, root_false


def _exact(positions, siblings, leaves, root, arity: int,
           device: torch.device) -> np.ndarray:
    """The per-proof path (the verify kernel on a card) as host bools;
    ``root`` ``[16]`` or ``[k, 16]``."""
    return verify_proofs(
        torch.as_tensor(positions, device=device),
        fr.as_digits(siblings, device=device),
        fr.as_digits(leaves, device=device),
        fr.as_digits(root, device=device),
        arity,
    ).cpu().numpy()


def _dedup_results(positions, siblings, leaves, root, arity: int,
                   device: torch.device):
    """Deduplicated per-proof verify with failure isolation on host arrays:
    ``[k] bool`` equal to the exact path, or ``None`` when the gates
    decline and the exact path must decide everything.

    The happy path is one upload, one device program and a readback of
    the two flags.  On a failure the mask is read back, mapped to the
    suspect proofs, and only those re-verify exactly."""
    wire = _dedup_pack(positions, siblings, leaves, root, arity)
    if wire is None:
        return None
    k = positions.shape[0]
    flags, bad = _dedup_verify_levels(
        arity, wire.sizes, wire.kb, wire.tb, wire.lm16,
        _upload(wire.packed, device),
    )
    if bool(flags.all()):
        return np.ones(k, bool)
    suspects, root_false = _suspect_mask(bad.cpu().numpy(), wire, k)
    out = np.ones(k, bool)
    out[root_false] = False
    si = np.flatnonzero(suspects)
    if len(si):
        out[si] = _exact(positions[si], siblings[si], leaves[si], root, arity,
                         device)
    elif not root_false.any():
        return None  # defensive: a tripped flag always marks something
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on_card(*xs) -> bool:
    return all(isinstance(x, torch.Tensor) and x.is_cuda for x in xs)


def _verdicts(positions, siblings, leaves, root, arity: int,
              dedupe: Optional[bool], device):
    """:func:`verify_each`'s verdicts: a ``[k]`` bool tensor on the card for
    proofs already there, else a host array.  A host batch with a root a
    proof takes the exact route: the dedup schedule shares one tree's
    upper paths.  Counts the route it takes: ``verify.route.card``,
    ``.dedup`` or ``.exact``."""
    if dedupe is not True and _on_card(positions, siblings, leaves):
        trace.count("verify.route.card")
        return verify_proofs(positions, siblings, leaves, root, arity,
                             device=device)
    device = resolve_device(device, positions, siblings, leaves, root)
    pos, sib, lv, rt = (_host(x) for x in (positions, siblings, leaves, root))
    _check_proof_shapes(pos, sib, lv, rt, arity)
    k, h = pos.shape
    if dedupe is None:
        dedupe = k >= 64 and h >= 2
    if dedupe and h >= 1 and k >= 2 and rt.ndim == 1:
        res = _dedup_results(pos, sib, lv, rt, arity, device)
        if res is not None:
            trace.count("verify.route.dedup")
            return res
    trace.count("verify.route.exact")
    return _exact(pos, sib, lv, rt, arity, device)


def verify_each(positions, siblings, leaves, root, arity: int,
                dedupe: Optional[bool] = None, device=None) -> np.ndarray:
    """Per-proof batch verification, ``[k] bool`` on the host: the
    reference kernel's result (merkle_tree_cuda.cu:67-118, before the
    host's all_of).  Inputs are numpy arrays or tensors; the work runs on
    ``device``, else on the first tensor argument's device, else on the
    card.  ``root`` is ``[16]``, one tree's root for every proof, or
    ``[k, 16]``, a root a proof (proofs of many trees, each checked against
    its own).  Proofs already on the card (positions, siblings and leaves)
    take the per-proof path on ``device``, by default where they lie (one
    launch of the verify kernel, no host copy), unless ``dedupe=True`` asks
    for the host schedule.  Host batches of one root that share tree nodes
    (``dedupe`` defaults to ``k >= 64 and h >= 2``) take the deduplicated
    schedule with failure isolation, built on the host; the rest, every
    host batch with a root a proof, and every batch the gates decline, the
    per-proof path."""
    with trace.span("verify_each"):
        out = _verdicts(positions, siblings, leaves, root, arity, dedupe,
                        device)
        if not isinstance(out, torch.Tensor):
            return out
        with trace.span("verify.readback", wait=True):
            return out.cpu().numpy()


def verify_all(positions, siblings, leaves, root, arity: int,
               dedupe: Optional[bool] = None, device=None) -> bool:
    """All-or-nothing batch verification (merkle_tree_cuda.cu:464, all_of
    over the per-proof bools); on card proofs the all_of runs on the card
    and one bool comes back."""
    return bool(
        _verdicts(positions, siblings, leaves, root, arity, dedupe, device)
        .all()
    )


# ---------------------------------------------------------------------------
# Incremental leaf updates (the reference's update_leaf is a full rebuild,
# merkle_tree.cpp:290-301): only the affected leaf-to-root paths rehash,
# bit-identical to a rebuild because every recomputed node hashes exactly
# the inputs the rebuild would.
# ---------------------------------------------------------------------------

def _update_paths(arity: int, idx: torch.Tensor, vals: torch.Tensor,
                  levels) -> List[torch.Tensor]:
    """New levels with ``vals`` at leaf rows ``idx`` (unique) and each
    affected group rehashed per level (:func:`_engine_hash_multiple`: one
    K1 launch per level on a card).  Duplicate parents recompute the same
    value."""
    levels = [lv.clone() for lv in levels]
    levels[0][idx] = vals
    lane = torch.arange(arity, device=idx.device)
    for L in range(len(levels) - 1):
        pidx = idx // arity
        rows = (pidx * arity)[:, None] + lane
        levels[L + 1][pidx] = _engine_hash_multiple(levels[L][rows])
        idx = pidx
    return levels


def update_tree_levels(levels, arity: int, indices, values) -> List[torch.Tensor]:
    """Incrementally updated levels: a new level list with ``values`` at
    leaf ``indices`` and only the affected paths rehashed; ``levels`` is
    left as it was.  Raises ``ValidationError`` for duplicate indices or
    ``values`` that are not ``[k, 16]``, and ``IndexError_`` for an index
    outside level 0."""
    idx_np = np.atleast_1d(_host(indices)).astype(np.int64)
    if len(np.unique(idx_np)) != len(idx_np):
        raise errors.ValidationError("update indices must be unique")
    n = int(levels[0].shape[0])
    if idx_np.size and not (0 <= int(idx_np.min()) and int(idx_np.max()) < n):
        bad = idx_np[(idx_np < 0) | (idx_np >= n)]
        errors.validate_index(int(bad[0]), n, "leaf index")
    device = levels[0].device
    vals = fr.as_digits(values, device=device)
    if vals.dim() == 1:
        vals = vals[None]
    k = idx_np.shape[0]
    if tuple(vals.shape) != (k, fr.NDIGITS):
        raise errors.ValidationError(
            f"values must be [{k}, {fr.NDIGITS}], got {tuple(vals.shape)}"
        )
    return _update_paths(arity, torch.as_tensor(idx_np, device=device), vals,
                         levels)


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
        levels as numpy ``uint32 [m, 16]``, which go to the card unless
        ``device`` says otherwise), without rehashing."""
        if levels:
            device = resolve_device(device, *levels)
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
        leaves = fr.as_digits(leaves,
                              device=resolve_device(self.device, leaves))
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
        """All-or-nothing batch verification (merkle_tree_cuda.cu:464),
        through :func:`verify_all` on the tree's device."""
        root = self.get_root_hash()
        return verify_all(positions, siblings, leaves, root,
                          self.config.arity, device=root.device)

    def update_leaf(self, index: int, value) -> bool:
        """Update one leaf: the levels a full rebuild gives
        (merkle_tree.cpp:290-301), rehashing one path."""
        return self.update_leaves([index], fr.as_digits(value)[None])

    def update_leaves(self, indices, values) -> bool:
        """Batched incremental update: only the affected leaf-to-root paths
        rehash, giving the levels of a rebuild.  Indices must be unique and
        below the leaf count, and ``values`` one row per index; otherwise
        returns False and leaves the tree as it was."""
        if not self._levels:
            return False
        idx = np.atleast_1d(_host(indices)).astype(np.int64)
        if idx.size == 0 or idx.min() < 0 or idx.max() >= self._num_leaves:
            return False
        try:
            self._levels = update_tree_levels(
                self._levels, self.config.arity, idx, values
            )
        except errors.ValidationError:
            return False
        return True

    def insert_leaf(self, value) -> bool:
        """Append a leaf (merkle_tree.cpp:290-295).  Into a free padded
        slot (it held ``empty_hash(arity)``, which a rebuild would replace)
        it is an incremental path update; when the capacity grows, the
        tree is rebuilt."""
        device = self._levels[0].device if self._levels else self.device
        new = fr.as_digits(value, device=resolve_device(device, value))[None, :]
        if self._levels and self._num_leaves < self._levels[0].shape[0]:
            self._levels = update_tree_levels(
                self._levels, self.config.arity, [self._num_leaves], new
            )
            self._num_leaves += 1
            return True
        if self._levels:
            new = torch.cat([self._levels[0][:self._num_leaves], new])
        return self.build_tree(new)


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
    (merkle_tree.cpp:443-457): one u64 draw per leaf
    (:func:`cuzk_tpu_torch.oracle.generate_test_leaves`)."""
    draws = np.array(oracle.generate_test_leaves(count, seed), dtype=np.uint64)
    digits = np.zeros((count, fr.NDIGITS), np.int64)
    for i in range(4):
        digits[:, i] = (draws >> np.uint64(16 * i)) & np.uint64(fr.DIGIT_MASK)
    return torch.as_tensor(digits, device=device)


# ---------------------------------------------------------------------------
# MerkleUtils parity (merkle_tree.hpp:113-136)
# ---------------------------------------------------------------------------

def validate_proof_structure(positions, siblings, arity: int) -> bool:
    """Structural proof check (MerkleUtils::validate_proof,
    merkle_tree.cpp:374-393): matching level counts, positions in range,
    arity-1 siblings of 16 digits per level."""
    positions, siblings = _host(positions), _host(siblings)
    if positions.ndim != 1 or siblings.ndim != 3:
        return False
    if positions.shape[0] != siblings.shape[0]:
        return False
    if siblings.shape[1] != arity - 1 or siblings.shape[2] != fr.NDIGITS:
        return False
    return bool(np.all((positions >= 0) & (positions < arity)))


def benchmark_tree(leaf_count: int, arity: int, num_proofs: int = 100,
                   seed: int = 42, device=None) -> TreeBenchmarkResult:
    """Build, proof-generation and verification times of one tree
    (MerkleUtils::benchmark_tree, merkle_tree.cpp:399-440), in ms on the
    host clock, on ``device`` (the card by default).  The phases are the
    batched APIs over ``num_proofs`` seeded random indices: build,
    ``generate_batch_proofs``, ``verify_batch_proofs``.  Each phase runs
    once untimed first; on a card the clock is read after
    ``torch.cuda.synchronize()``."""
    device = resolve_device(device)
    leaves = generate_test_leaves(leaf_count, seed, device=device)
    idx = torch.as_tensor(
        np.random.default_rng(seed).integers(0, leaf_count, num_proofs),
        device=device,
    )
    cfg = MerkleConfig(arity)

    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    tree = NaryMerkleTree(leaves, cfg, device=device)
    pos, sib = tree.generate_batch_proofs(idx)
    tree.verify_batch_proofs(pos, sib, tree.levels[0][idx])

    start = clock()
    tree = NaryMerkleTree(leaves, cfg, device=device)
    build_ms = (clock() - start) * 1e3
    start = clock()
    pos, sib = tree.generate_batch_proofs(idx)
    proof_ms = (clock() - start) * 1e3
    proved = tree.levels[0][idx]
    start = clock()
    ok = tree.verify_batch_proofs(pos, sib, proved)
    verify_ms = (clock() - start) * 1e3
    if not ok:
        raise errors.ComputationError("benchmark_tree: proofs failed to verify")
    return TreeBenchmarkResult(
        leaf_count=leaf_count, arity=arity,
        tree_height=tree.get_tree_height(), build_time_ms=build_ms,
        proof_time_ms=proof_ms, verify_time_ms=verify_ms,
    )


def compare_trees(a: NaryMerkleTree, b: NaryMerkleTree) -> bool:
    """Root, height and leaf-count equality (MerkleUtils::compare_trees,
    merkle_tree.cpp:395-412)."""
    if not a.levels or not b.levels:
        return bool(a.levels) == bool(b.levels)
    return (
        a.get_tree_height() == b.get_tree_height()
        and a.get_leaf_count() == b.get_leaf_count()
        and torch.equal(a.get_root_hash().cpu(), b.get_root_hash().cpu())
    )


def print_tree(tree: NaryMerkleTree, max_nodes_per_level: int = 8) -> str:
    """Level-by-level render (NaryMerkleTree::print_tree,
    merkle_tree.cpp:319-344).  Returns the string and prints it."""
    lines = []
    if not tree.levels:
        lines.append("(empty tree)")
    else:
        top = len(tree.levels) - 1
        for lvl in range(top, -1, -1):
            vals = fr.array_to_ints(tree.levels[lvl][:max_nodes_per_level])
            shown = ", ".join(f"0x{v:016x}"[:18] for v in vals)
            extra = tree.levels[lvl].shape[0] - len(vals)
            suffix = f" ... (+{extra})" if extra > 0 else ""
            name = "root" if lvl == top else f"level {lvl}"
            lines.append(f"{name}: [{shown}]{suffix}")
    out = "\n".join(lines)
    print(out)
    return out


# ---------------------------------------------------------------------------
# Batch builds
# ---------------------------------------------------------------------------

def build_batch_trees(leaf_sets, arity: int = 2,
                      device=None) -> List[NaryMerkleTree]:
    """Build many trees.  Equal-size sets build side by side as
    ``[k * m, 16]`` levels, one sponge launch per level for all k trees (the
    reference loops over the trees, merkle_tree_cuda.cu:467-482); mixed
    sizes build tree by tree.  ``device`` moves the leaves first; by
    default tensors stay where they are and host data goes to the card."""
    if leaf_sets:
        device = resolve_device(device, *leaf_sets)
    sets = [fr.as_digits(ls, device=device) for ls in leaf_sets]
    sizes = {int(s.shape[0]) for s in sets}
    if len(sizes) != 1 or sizes == {0}:
        return [NaryMerkleTree(s, MerkleConfig(arity), device=device)
                for s in sets]
    cfg = MerkleConfig(arity)
    n, k = sizes.pop(), len(sets)
    stacked = torch.stack(sets)
    padded = padded_leaf_count(n, arity)
    if padded > n:
        pad = _empty_hash_digits(arity, stacked.device).expand(
            k, padded - n, fr.NDIGITS
        )
        stacked = torch.cat([stacked, pad], dim=1)
    levels = _build_levels(stacked.reshape(k * padded, fr.NDIGITS), arity,
                           trees=k)
    trees = []
    for t in range(k):
        tree = NaryMerkleTree(config=cfg, device=device)
        tree._num_leaves = n
        tree._levels = [lv.view(k, -1, fr.NDIGITS)[t] for lv in levels]
        trees.append(tree)
    return trees


# ---------------------------------------------------------------------------
# Save and load, in the ``.npz`` layout of ``cuzk_tpu.merkle.save_tree``
# (``arity``, ``num_leaves``, ``level_i`` as uint32 ``[m, 16]``), so a file
# written by either package loads in the other.
# ---------------------------------------------------------------------------

_U32_MAX = (1 << 32) - 1


def _check_u32(level: np.ndarray, i: int) -> None:
    """A level's digits must be integers in [0, 2^32): a uint32 cast would
    alias anything else (2^32 + d would read back as d)."""
    if not _in_range(level, _U32_MAX):
        raise errors.ValidationError(
            f"level {i} holds a digit outside [0, 2^32) or a non-integer"
        )


def save_tree(tree: NaryMerkleTree, path: str) -> None:
    """Write a built tree (config and every level) to an ``.npz`` file."""
    errors.validate_non_empty(tree.levels, "tree levels")
    levels = [lv.cpu().numpy() for lv in tree.levels]
    for i, lv in enumerate(levels):
        _check_u32(lv, i)
    np.savez_compressed(
        path,
        arity=np.int64(tree.config.arity),
        num_leaves=np.int64(tree.get_leaf_count()),
        **{f"level_{i}": lv.astype(np.uint32) for i, lv in enumerate(levels)},
    )


def load_tree(path: str, verify: bool = False, device=None) -> NaryMerkleTree:
    """Restore a tree saved by :func:`save_tree` (by either package)
    without rehashing, its levels on ``device``.  ``verify=True`` rebuilds
    every level from the stored level 0 and compares all of them, so a
    tampered intermediate level whose root still chains is caught too;
    a mismatch raises :class:`~cuzk_tpu_torch.utils.errors.ComputationError`."""
    with np.load(path) as data:
        arity = int(data["arity"])
        num_leaves = int(data["num_leaves"])
        n_levels = sum(1 for name in data.files if name.startswith("level_"))
        levels = [data[f"level_{i}"] for i in range(n_levels)]
    for i, lv in enumerate(levels):
        _check_u32(lv, i)
    tree = NaryMerkleTree.from_levels(levels, arity, num_leaves, device=device)
    if verify:
        rebuilt = build_tree_levels(tree.levels[0], arity)
        if len(rebuilt) != len(tree.levels) or not all(
            torch.equal(a, b) for a, b in zip(rebuilt, tree.levels)
        ):
            raise errors.ComputationError(
                f"loaded tree failed verification: stored levels do not "
                f"match a rebuild from the stored leaves ({path})"
            )
    return tree
