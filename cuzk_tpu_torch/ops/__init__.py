"""CUDA kernels for Hopper and their wrappers.

The analog of ``cuzk_tpu.ops``: the plain PyTorch modules are the reference
path, and these kernels (CUDA C++ under ``cuzk_tpu_torch/csrc/``, built at
first use by :mod:`cuzk_tpu_torch.ops._build`) are the accelerated path,
held against the plain versions on the card.
"""

from cuzk_tpu_torch.ops.poseidon_cuda import (
    FR_OPS,
    fr_op_cuda,
    hash_multiple_cuda,
    hash_pair_cuda,
    hash_single_cuda,
    launch_counts,
    reset_launch_counts,
    sponge_limbs,
    verify_limbs,
)

__all__ = [
    "FR_OPS",
    "fr_op_cuda",
    "hash_multiple_cuda",
    "hash_pair_cuda",
    "hash_single_cuda",
    "launch_counts",
    "reset_launch_counts",
    "sponge_limbs",
    "verify_limbs",
]
