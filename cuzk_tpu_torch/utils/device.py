"""Device introspection (the analog of print_device_info /
check_cuda_compatibility — field_arithmetic_cuda.cu:629-650,
merkle_tree_cuda.cu:603-621)."""

from __future__ import annotations

import subprocess
from typing import Dict

import torch

from cuzk_tpu_torch.utils.errors import CudaUnavailableError

# The kernels are compiled for sm_90a (Hopper) only.
REQUIRED_CAPABILITY = (9, 0)


def require_cuda() -> torch.device:
    """The first CUDA device, or :class:`CudaUnavailableError` when none is
    visible or it is not compute capability 9.0."""
    if not torch.cuda.is_available():
        raise CudaUnavailableError("no CUDA device is available")
    cap = torch.cuda.get_device_capability(0)
    if cap != REQUIRED_CAPABILITY:
        raise CudaUnavailableError(
            f"the kernels are built for sm_90a; device 0 has capability {cap}"
        )
    return torch.device("cuda", 0)


def resolve_device(device=None, *data) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    device of the first torch tensor among ``data``, else the card
    (:func:`require_cuda`, which raises without one).  So the CPU runs only
    when the caller asks for it, by name or with tensors on the CPU."""
    if device is not None:
        return torch.device(device)
    for x in data:
        if isinstance(x, torch.Tensor):
            return x.device
    return require_cuda()


def nvidia_smi_name_power() -> str:
    """``name, power.limit`` of the cards as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip()


def device_info() -> Dict:
    """Name, compute capability, count and power limit of CUDA device 0."""
    require_cuda()
    return {
        "name": torch.cuda.get_device_name(0),
        "capability": torch.cuda.get_device_capability(0),
        "count": torch.cuda.device_count(),
        "name_power_limit": nvidia_smi_name_power().splitlines()[0],
    }


def check_cuda_compatibility() -> bool:
    """True when a Hopper card is present (merkle_tree_cuda.cu:603-621)."""
    try:
        require_cuda()
    except CudaUnavailableError:
        return False
    return True
