"""Exception types and validators (src/common/error_handling.hpp:15-55).

The same names and classes as ``cuzk_tpu.utils.errors``, kept here because
``cuzk_tpu.utils`` imports jax when it is imported.  Two types are new:
the CUDA errors the port raises instead of falling back to the CPU.
"""

from __future__ import annotations


class ValidationError(ValueError):
    """Invalid argument (error_handling.hpp:15-19)."""


class ComputationError(RuntimeError):
    """Computation failed (error_handling.hpp:21-25)."""


class IndexError_(IndexError):
    """Index out of range (error_handling.hpp:27-31)."""


class CudaUnavailableError(RuntimeError):
    """No usable CUDA device: none visible, or not compute capability 9.0."""


class KernelBuildError(RuntimeError):
    """The CUDA kernels failed to build or load; carries the compiler output."""


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch returned an error."""


def validate_range(value, lo, hi, name: str = "value"):
    """error_handling.hpp:34-41."""
    if not lo <= value <= hi:
        raise ValidationError(f"{name} must be in [{lo}, {hi}], got {value}")
    return value


def validate_index(index: int, size: int, name: str = "index"):
    """error_handling.hpp:43-49."""
    if not 0 <= index < size:
        raise IndexError_(f"{name} {index} out of range (size {size})")
    return index


def validate_non_empty(seq, name: str = "sequence"):
    """error_handling.hpp:51-55."""
    if len(seq) == 0:
        raise ValidationError(f"{name} must not be empty")
    return seq
