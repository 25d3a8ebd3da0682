"""Cross-cutting utilities: field-element I/O, validators and exception
types, timing, and device checks."""

from cuzk_tpu_torch.utils.io import (
    from_decimal,
    from_hex,
    random_element,
    random_elements,
    to_decimal,
    to_hex,
)
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
    "to_hex",
    "from_hex",
    "to_decimal",
    "from_decimal",
    "random_element",
    "random_elements",
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
