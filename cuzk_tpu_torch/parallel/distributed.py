"""Sharded hashing and Merkle builds over ``torch.distributed`` ranks.

The counterpart of :mod:`cuzk_tpu.parallel.distributed`, in PyTorch's idiom:
one process a rank, one device a rank, the same program on every rank.

- **Data-parallel hashing**: each rank hashes its contiguous block of the
  batch through the sponge kernel (the plain sponge on the CPU); no
  collective.
- **Sharded tree build**: each rank holds a contiguous block of the padded
  leaves and builds its subtrees bottom-up while group boundaries stay
  local (local level size divisible by the arity), then ONE all-gather
  collapses the shrunken level onto every rank and the few upper levels are
  computed replicated.  Bit-exact to the single-device build, because
  blocks are contiguous and the gather keeps rank order.
- **Sharded proofs**: per level only the O(k * arity) nodes a proof batch
  touches cross the mesh (each rank contributes the siblings it owns, zeros
  elsewhere, one all-reduce); a sharded level is never gathered whole.

Every rank must call each function here with the same host values: the
branches (the replicated fallback, the empty-tree error, a bad index) are
taken from those values alone, so all ranks take the same one and none is
left waiting in a collective.

Collectives ride NCCL when each rank owns a card.  NCCL refuses two ranks
on one device, so ranks that share a card (and ranks on the CPU) use gloo,
with the small collective operands (``d * r`` rows of the gathered level,
``k * (arity - 1)`` sibling rows a level) staged through host memory.  The
backend is chosen from what the mesh is (:func:`choose_backend`) or by the
caller, recorded on the mesh, and never changed after a failure.

The JAX module's ``_LEVEL_CACHE`` / ``_mesh_key`` cache compiled XLA
executables; there is nothing to compile here, so they have no counterpart.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cuzk_tpu_torch import merkle
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import poseidon_cuda
from cuzk_tpu_torch.utils import errors
from cuzk_tpu_torch.utils.device import require_cuda, resolve_device

DATA_AXIS = "data"
# A rank that raises alone leaves the others in their next collective; the
# process group gives up after this long.
DEFAULT_TIMEOUT_S = 600


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: this process's view of it.

    ``group`` is the process group that carries the collectives (None for
    the one-rank mesh made without a process group), ``rank`` this
    process's place in it, ``size`` the number of ranks, ``device`` the
    device this rank computes on, and ``backend`` the group's backend
    (``"nccl"``, ``"gloo"``, or None without a group).  ``shared_card``
    says whether several ranks of the mesh compute on one card
    (:func:`ranks_share_a_card`)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]
    axis_name: str = DATA_AXIS
    shared_card: bool = False


def ranks_share_a_card(num_processes: int, device=None) -> bool:
    """Whether ``num_processes`` ranks placed by ``device`` put two on one
    card.  With no ``device`` a rank takes card ``rank`` modulo the number
    of cards, so they share once there are more ranks than cards; a card
    given by name takes every rank."""
    if num_processes < 2:
        return False
    if device is None:
        return num_processes > torch.cuda.device_count()
    return torch.device(device).type == "cuda"


def _rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: ``device`` when given, else
    card ``rank`` modulo the number of cards (raises without a card)."""
    if device is not None:
        return torch.device(device)
    require_cuda()
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device=None) -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` ranks (default: all).

    With no process group initialised this is the one-rank mesh over the
    card (``device="cpu"`` for the CPU), needing no launcher.  With one
    (:func:`initialize_multiprocess`), the ranks are the group's; a sub-mesh
    (``n_devices`` below the world size) makes a new group, so every rank
    of the world must call this, and a rank outside the sub-mesh gets None.
    Asking for more ranks than there are raises ``ValueError``."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices is not None and n_devices > 1:
            raise ValueError(
                f"requested {n_devices} devices, only 1 available"
            )
        return Mesh(None, 0, 1, resolve_device(device), None, axis_name)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    rank = dist.get_rank()
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group, rank, n, _rank_device(device, rank),
                dist.get_backend(group), axis_name,
                ranks_share_a_card(n, device))


def choose_backend(num_processes: int, device=None) -> str:
    """``"nccl"`` when every rank owns a card, else ``"gloo"``: ranks on
    the CPU, or sharing a card, which NCCL refuses.  Decided from where
    the ranks are placed (``device`` as :func:`make_mesh` and
    :func:`initialize_multiprocess` take it: None for card ``rank`` modulo
    the number of cards, or one device for every rank)."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if (on_cpu or ranks_share_a_card(num_processes, device)
            or not dist.is_nccl_available()):
        return "gloo"
    return "nccl"


def initialize_multiprocess(coordinator_address: str, num_processes: int,
                            process_id: int, backend: Optional[str] = None,
                            init_method: Optional[str] = None, device=None,
                            timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """``torch.distributed.init_process_group`` wrapper: call once per
    process, then build meshes with :func:`make_mesh`.  The rendezvous is
    ``init_method``, else a TCP store at ``coordinator_address``
    (``host:port``).  ``backend`` defaults to :func:`choose_backend` for
    the ranks' placement (``device`` for every rank, else card ``rank``
    modulo the number of cards); returns the backend.

    The JAX entry's ``local_device_count`` has no counterpart: a rank has
    one device."""
    mine = _rank_device(device, process_id)
    if backend is None:
        backend = choose_backend(num_processes, device)
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    dist.init_process_group(
        backend,
        init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return backend


# ---------------------------------------------------------------------------
# Collectives: NCCL on tensors where they lie, gloo on host copies.
# ---------------------------------------------------------------------------

def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return (x if mesh.backend == "nccl" else x.cpu()).contiguous()


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``x`` joined along axis 0 in rank order, on every rank."""
    if mesh.group is None:
        return x
    mine = _staged(x, mesh)
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    return torch.cat(parts).to(mesh.device)


def _all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the ranks' ``x`` (int64, which both backends add), on
    every rank."""
    if mesh.group is None:
        return x
    total = _staged(x, mesh)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total.to(mesh.device)


def _rows(x, lo: int, hi: int, device: torch.device) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``x`` (a tensor or a host value) as int64 digits
    on ``device``; only those rows cross to the device."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return fr.as_digits(x[lo:hi], device=device)


def shard_batch(x, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of ``[n, ...]`` along axis 0, as int64
    digits on ``mesh.device``.  Every rank passes the same value; tensors
    already on a device are converted too (any integer dtype in, the
    port's digit type out).  ``n`` must divide by the mesh size."""
    n = len(x)
    if n % mesh.size:
        raise ValueError(
            f"cannot shard {n} rows evenly over {mesh.size} ranks"
        )
    block = n // mesh.size
    return _rows(x, mesh.rank * block, (mesh.rank + 1) * block, mesh.device)


def unshard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole of a sharded value on every rank: the ranks' blocks joined
    in rank order by one all-gather (what ``np.asarray`` of a sharded
    ``jax.Array`` gives)."""
    return _all_gather(x, mesh)


def sharded_hash_pairs(left, right, mesh: Mesh) -> torch.Tensor:
    """Data-parallel batched pair hash: this rank's block of the result,
    through the sponge kernel on the card; no collective."""
    return poseidon_cuda.hash_pair_cuda(shard_batch(left, mesh),
                                        shard_batch(right, mesh))


def sharded_hash_single(x, mesh: Mesh) -> torch.Tensor:
    """Data-parallel batched single hash: this rank's block of the result."""
    return poseidon_cuda.hash_single_cuda(shard_batch(x, mesh))


# ---------------------------------------------------------------------------
# Sharded Merkle build
# ---------------------------------------------------------------------------

def _padded_block(leaves, n: int, m: int, arity: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the ``n`` leaves padded to ``m`` rows with the
    empty hash."""
    local_m = m // mesh.size
    lo = mesh.rank * local_m
    block = _rows(leaves, min(lo, n), min(lo + local_m, n), mesh.device)
    if block.shape[0] < local_m:
        pad = merkle._empty_hash_digits(arity, mesh.device).expand(
            local_m - block.shape[0], fr.NDIGITS
        )
        block = torch.cat([block, pad], dim=0)
    return block


def _local_subtrees(local_m: int, arity: int) -> int:
    """The rows a rank's block shrinks to while its groups stay local: the
    block is that many subtrees side by side."""
    while local_m > 1 and local_m % arity == 0:
        local_m //= arity
    return local_m


def sharded_build_levels(
    leaves, arity: int, mesh: Mesh
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Build a Merkle tree from leaves sharded over the mesh.

    Returns ``(sharded_levels, replicated_levels)``: the lower levels as
    this rank's block (level 0 = the padded leaves), the gathered level and
    everything above it replicated; ``replicated_levels[-1][0]`` is the
    root.  ``replicated_levels[0]`` is the gathered version of
    ``sharded_levels[-1]``, so ``sharded_levels[:-1] + replicated_levels``,
    blocks joined in rank order, is exactly ``merkle.build_tree_levels``.
    A padded leaf count the mesh size does not divide (a tiny tree on a big
    mesh) is built replicated: ``([], merkle.build_tree_levels(...))``.
    """
    merkle.MerkleConfig(arity)
    n = len(leaves)
    if n == 0:
        raise ValueError("cannot shard-build an empty tree")
    m = merkle.padded_leaf_count(n, arity)
    if m % mesh.size != 0:
        return [], merkle.build_tree_levels(leaves, arity, device=mesh.device)
    block = _padded_block(leaves, n, m, arity, mesh)
    # The block is r subtrees side by side: the level loop of the
    # single-device and the batch build, stopped at their r roots.
    r = _local_subtrees(m // mesh.size, arity)
    sharded_levels = merkle._build_levels(block, arity, trees=r)
    gathered = _all_gather(sharded_levels[-1], mesh)
    return sharded_levels, merkle._build_levels(gathered, arity)


def sharded_merkle_root(leaves, arity: int, mesh: Mesh) -> torch.Tensor:
    """Root ``[16]`` of a sharded tree build."""
    _, replicated = sharded_build_levels(leaves, arity, mesh)
    return replicated[-1][0]


# ---------------------------------------------------------------------------
# Sharded proof generation
# ---------------------------------------------------------------------------

def _owned_rows(level_local: torch.Tensor, rows: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """Global rows ``rows [k, w]`` of a sharded level as ``[k, w, 16]``:
    the rows this rank owns, zeros for the rest."""
    local_m = level_local.shape[0]
    rel = rows - mesh.rank * local_m
    owned = (rel >= 0) & (rel < local_m)
    return level_local[rel.clamp(0, local_m - 1)] * owned[..., None]


def sharded_generate_proofs(
    sharded_levels: List[torch.Tensor],
    replicated_levels: List[torch.Tensor],
    arity: int,
    leaf_indices,
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch proofs from a sharded build (:func:`sharded_build_levels`'s
    output), replicated on every rank: the ``(positions [k, h-1] int32,
    siblings [k, h-1, a-1, 16])`` of :func:`merkle.generate_proofs`, value
    for value.  At every sharded level each rank contributes the siblings
    it owns, zeros elsewhere, and one all-reduce of the ``[levels, k, a-1,
    16]`` stack replicates them: exact, one non-zero term a row, and
    O(k * arity) a level whatever the level's size.  The replicated upper
    levels index locally."""
    device = mesh.device
    idx = torch.as_tensor(leaf_indices, device=device).reshape(-1).to(torch.int64)
    k = idx.shape[0]
    n = (sharded_levels[0].shape[0] * mesh.size if sharded_levels
         else int(replicated_levels[0].shape[0]))
    if k:
        bad = idx[(idx < 0) | (idx >= n)]
        if bad.numel():
            errors.validate_index(int(bad[0]), n, "leaf index")
    lower = len(sharded_levels[:-1])
    height = lower + len(replicated_levels) - 1
    if height == 0:
        return (
            torch.zeros((k, 0), dtype=torch.int32, device=device),
            torch.zeros((k, 0, arity - 1, fr.NDIGITS), dtype=fr.DTYPE,
                        device=device),
        )
    # Per level: each node's position in its group and the rows of its
    # arity-1 siblings (sibling j is child j + (j >= pos)).
    j = torch.arange(arity - 1, device=device)
    positions, rows = [], []
    for _ in range(height):
        pos = idx % arity
        positions.append(pos)
        rows.append((idx - pos)[:, None] + j[None, :]
                    + (j[None, :] >= pos[:, None]))
        idx = idx // arity
    siblings = []
    if lower:
        owned = torch.stack([
            _owned_rows(level, rows[lvl], mesh)
            for lvl, level in enumerate(sharded_levels[:-1])
        ])
        siblings.extend(_all_reduce_sum(owned, mesh))
    for lvl, level in enumerate(replicated_levels[:-1], start=lower):
        siblings.append(level[rows[lvl]])
    return (
        torch.stack(positions, dim=1).to(torch.int32),
        torch.stack(siblings, dim=1),
    )
