"""CUDA kernels for Hopper and their wrappers.

The analog of ``cuzk_tpu.ops``: the plain PyTorch modules are the reference
path, and these kernels (CUDA C++ under ``cuzk_tpu_torch/csrc/``, built at
first use by :mod:`cuzk_tpu_torch.ops._build`) are the accelerated path,
held against the plain versions on the card.
"""

from cuzk_tpu_torch.ops.poseidon_cuda import (
    FR_OPS,
    LANES,
    choose_lanes,
    fr_op_cuda,
    hash_multiple_cuda,
    hash_multiple_cuda_packed,
    hash_pair_cuda,
    hash_pair_cuda_loop,
    hash_pair_cuda_packed,
    hash_single_cuda,
    hash_single_cuda_loop,
    hash_single_cuda_packed,
    launch_counts,
    permutation_cuda,
    reset_launch_counts,
    resident_states,
    sponge_digits,
    sponge_limbs,
    sponge_resident_threads,
    verify_digits,
)

__all__ = [
    "FR_OPS",
    "LANES",
    "choose_lanes",
    "fr_op_cuda",
    "hash_multiple_cuda",
    "hash_multiple_cuda_packed",
    "hash_pair_cuda",
    "hash_pair_cuda_loop",
    "hash_pair_cuda_packed",
    "hash_single_cuda",
    "hash_single_cuda_loop",
    "hash_single_cuda_packed",
    "launch_counts",
    "permutation_cuda",
    "reset_launch_counts",
    "resident_states",
    "sponge_digits",
    "sponge_limbs",
    "sponge_resident_threads",
    "verify_digits",
]
