"""Cross-cutting utilities: validators and exception types, timing, and
device checks."""

from cuzk_tpu_torch.utils.errors import (
    ComputationError,
    CudaUnavailableError,
    IndexError_,
    KernelBuildError,
    KernelLaunchError,
    ValidationError,
    validate_index,
    validate_non_empty,
    validate_range,
)
from cuzk_tpu_torch.utils.stats import (
    HashingStats,
    TreeBenchmarkResult,
    cuda_time_ms,
    timed,
)
from cuzk_tpu_torch.utils.device import (
    check_cuda_compatibility,
    device_info,
    nvidia_smi_name_power,
    require_cuda,
    resolve_device,
)

__all__ = [
    "ComputationError",
    "CudaUnavailableError",
    "IndexError_",
    "KernelBuildError",
    "KernelLaunchError",
    "ValidationError",
    "validate_index",
    "validate_non_empty",
    "validate_range",
    "HashingStats",
    "TreeBenchmarkResult",
    "cuda_time_ms",
    "timed",
    "check_cuda_compatibility",
    "device_info",
    "nvidia_smi_name_power",
    "require_cuda",
    "resolve_device",
]
