"""Batched field operations with timing stats: the counterpart of
``cuzk_tpu.field.batch`` and of the reference's ``CudaFieldArithmetic``
batch surface (cuda/field_arithmetic_cuda.cuh:25-81: batch add, subtract,
multiply, square, power5 over element arrays).

On the card each call is one launch of the field core's check kernel
(``ops.fr_op_cuda``: ``csrc/fr254.cuh`` through ``fr_op_digits_kernel``, on
the digits themselves); on CPU tensors it is the plain ``fr`` op.  The
device is the one the other entry points pick
(:func:`~cuzk_tpu_torch.utils.device.resolve_device`): the class's
``device`` when given, else the first tensor operand's, else the card.
Operands are ``[..., 16]`` digits (torch, numpy or lists) and
broadcast against each other.
"""

from __future__ import annotations

import torch

from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.utils.device import resolve_device
from cuzk_tpu_torch.utils.stats import HashingStats, timed

# Each batch op: its plain version and its field-core op (ops.FR_OPS).
_OPS = {
    "add": (fr.add, "add_wrap_red"),
    "sub": (fr.sub, "sub"),
    "mul": (fr.mul, "mul"),
    "square": (fr.square, "square"),
    "power5": (fr.power5, "power5"),
    "red": (fr.red, "red"),
}


class BatchFieldArithmetic:
    """``CudaFieldArithmetic``'s batch API: stateless batch ops and their
    timing stats.  ``stats.total_hashes`` adds each output's leading axis,
    as ``cuzk_tpu.field.batch`` does (so a lone ``[16]`` element adds
    16)."""

    def __init__(self, device=None):
        self.device = device
        self.stats = HashingStats()

    def initialize(self) -> bool:
        """Set up the device: on a card, build the kernels (the reference
        probes and configures its device here, field_arithmetic_cuda.cu:
        316-353).  Raises without a card unless the class runs on the
        CPU."""
        if resolve_device(self.device).type != "cpu":
            from cuzk_tpu_torch.ops import _build

            _build.kernels()
        return True

    @staticmethod
    def cleanup() -> None:
        return None

    def _run(self, op: str, *operands) -> torch.Tensor:
        plain, core = _OPS[op]
        device = resolve_device(self.device, *operands)
        xs = torch.broadcast_tensors(
            *(fr.as_digits(x, device=device) for x in operands))
        if device.type == "cpu":
            out, sec = timed(plain, *xs)
        else:
            from cuzk_tpu_torch.ops import poseidon_cuda

            flat = [x.reshape(-1, fr.NDIGITS) for x in xs]
            out, sec = timed(poseidon_cuda.fr_op_cuda, core, *flat)
            out = out.reshape(xs[0].shape)
        self.stats.total_hashes += int(out.shape[0]) if out.dim() else 1
        self.stats.total_time_s += sec
        return out

    def batch_add(self, a, b) -> torch.Tensor:
        return self._run("add", a, b)

    def batch_subtract(self, a, b) -> torch.Tensor:
        return self._run("sub", a, b)

    def batch_multiply(self, a, b) -> torch.Tensor:
        return self._run("mul", a, b)

    def batch_square(self, a) -> torch.Tensor:
        return self._run("square", a)

    def batch_power5(self, a) -> torch.Tensor:
        return self._run("power5", a)

    def batch_reduce(self, a) -> torch.Tensor:
        return self._run("red", a)
