"""Wrappers of the CUDA Poseidon kernels, each beside its plain version.

The counterpart of the wrapper half of ``cuzk_tpu/ops/poseidon_pallas.py``.
Every public function takes ``[..., 16]`` digit tensors, as the JAX package
does, and dispatches on the tensors' device:

- on the CPU it runs the plain PyTorch version (``cuzk_tpu_torch.poseidon``);
- on any other device it builds the kernels (at the first call), checks
  device, dtype, shape and contiguity, converts digits to limbs, launches
  on PyTorch's current stream and raises on a launch error.  There is no
  fallback: without a Hopper card, or when the build fails, it raises.

The TPU path's batch and width bucketing (``_bucket_tiles``,
``_bucket_batch``, ``PAD_WIDTH``, ``_SCALAR_CACHE``) existed to bound
Mosaic compile counts; a CUDA kernel takes the batch and width at run time,
so none of it is here.

The ``*_limbs`` launchers take 8 x u32 limb tensors on the card and run on
no other device; :mod:`cuzk_tpu_torch.merkle` calls them for the tree
build (K1) and proof verification (K3), after its own device dispatch.

``launch_counts`` counts each kernel's launches, so that a run can show
which kernels its main path went through.
"""

from __future__ import annotations

import torch

from cuzk_tpu_torch import constants, poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import _build
from cuzk_tpu_torch.utils.errors import KernelLaunchError, ValidationError

ND = fr.NDIGITS
NL = fr.NLIMBS

launch_counts = {"sponge": 0, "verify": 0, "fr_op": 0}

# Op codes of the per-op check kernel (csrc/poseidon_kernels.cu::FrOp),
# each with its plain version.
FR_OPS = {
    "mul": (0, fr.mul),
    "square": (1, fr.square),
    "power5": (2, fr.power5),
    "add_wrap_red": (3, fr.add),
    "add_rr": (4, fr.add_rr),
    "mul_small": (5, fr.mul_small),
    "reduce_wide": (6, fr.reduce_wide),
    "red": (7, fr.red),
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_limbs(t: torch.Tensor, name: str, ndim: int) -> None:
    if not t.is_cuda:
        raise ValidationError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValidationError(f"{name} must be int32 limbs, got {t.dtype}")
    if t.dim() != ndim:
        raise ValidationError(f"{name} must have {ndim} dims, got {t.shape}")
    if not t.is_contiguous():
        raise ValidationError(f"{name} must be contiguous")


def _launch(kernels: _build.Kernels, fn, device: torch.device, *args) -> None:
    """Call one C launcher on ``device`` and PyTorch's current stream;
    raise if the launch returned an error."""
    kernels.ensure_round_constants(device.index)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        raise KernelLaunchError(
            f"{fn.__name__} failed: {kernels.error_string(code)}"
        )


# ---------------------------------------------------------------------------
# K1: the sponge
# ---------------------------------------------------------------------------

def sponge_limbs(x: torch.Tensor, ds: int) -> torch.Tensor:
    """K1 on limbs: ``x [B, n, 8]`` int32 on the card -> ``[B, 8]`` int32,
    the sponge with domain separator ``ds`` over each row's n inputs."""
    kernels = _build.kernels()
    _check_limbs(x, "inputs", 3)
    b, n, nl = x.shape
    if nl != NL:
        raise ValidationError(f"inputs must be [B, n, {NL}] limbs, got {x.shape}")
    out = torch.empty((b, NL), dtype=torch.int32, device=x.device)
    if b == 0 or n == 0:
        # The empty input returns 0 with no permutation (SURVEY.md B.4).
        return out.zero_()
    _launch(kernels, kernels.lib.cuzk_sponge, x.device,
            x.data_ptr(), out.data_ptr(), b, n, ds)
    launch_counts["sponge"] += 1
    return out


def _sponge(inputs, ds: int) -> torch.Tensor:
    """``[..., n, 16]`` digits -> ``[..., 16]``: the plain sponge on the CPU,
    K1 elsewhere."""
    inputs = fr.as_digits(inputs)
    if inputs.device.type == "cpu":
        return poseidon.sponge(inputs, ds)
    _build.kernels()
    batch, n = inputs.shape[:-2], inputs.shape[-2]
    if n == 0:
        # The empty input returns 0 with no permutation (SURVEY.md B.4).
        return fr.zeros(batch, device=inputs.device)
    limbs = fr.digits_to_limbs(inputs.reshape((-1, n, ND))).contiguous()
    out = sponge_limbs(limbs, ds)
    return fr.limbs_to_digits(out).reshape(batch + (ND,))


def hash_single_cuda(x) -> torch.Tensor:
    """Batched single-input hash, ds=1: ``[..., 16] -> [..., 16]``."""
    return _sponge(fr.as_digits(x)[..., None, :], poseidon.DS_SINGLE)


def hash_pair_cuda(left, right) -> torch.Tensor:
    """Batched pair hash, ds=2: two ``[..., 16]`` -> ``[..., 16]``."""
    left, right = torch.broadcast_tensors(fr.as_digits(left), fr.as_digits(right))
    return _sponge(torch.stack([left, right], dim=-2), poseidon.DS_PAIR)


def hash_multiple_cuda(inputs) -> torch.Tensor:
    """Batched n-input hash, ds=3: ``[..., n, 16] -> [..., 16]``, any n
    (n = 0 gives zeros)."""
    return _sponge(inputs, poseidon.DS_MULTIPLE)


# ---------------------------------------------------------------------------
# K3: per-proof verification
# ---------------------------------------------------------------------------

def verify_limbs(positions: torch.Tensor, siblings: torch.Tensor,
                 leaves: torch.Tensor, root: torch.Tensor,
                 arity: int) -> torch.Tensor:
    """K3 on limbs: ``positions [k, h]`` int32, ``siblings [k, h, a-1, 8]``,
    ``leaves [k, 8]`` and ``root [8]`` int32 on the card, h >= 1 ->
    ``[k] bool``, whether each proof's recomputed root equals ``root``."""
    kernels = _build.kernels()
    _check_limbs(positions, "positions", 2)
    _check_limbs(siblings, "siblings", 4)
    _check_limbs(leaves, "leaves", 2)
    _check_limbs(root, "root", 1)
    k, h = positions.shape
    if len({t.device for t in (positions, siblings, leaves, root)}) != 1:
        raise ValidationError("proof limbs must lie on one device")
    if not constants.MIN_ARITY <= arity <= constants.MAX_ARITY:
        raise ValidationError(f"arity must be in [2, 8], got {arity}")
    if h < 1 or (
        tuple(siblings.shape) != (k, h, arity - 1, NL)
        or tuple(leaves.shape) != (k, NL)
        or tuple(root.shape) != (NL,)
    ):
        raise ValidationError(
            f"proof limbs disagree: positions {tuple(positions.shape)}, "
            f"siblings {tuple(siblings.shape)}, leaves {tuple(leaves.shape)}, "
            f"root {tuple(root.shape)}, arity {arity}"
        )
    ok = torch.empty(k, dtype=torch.uint8, device=leaves.device)
    if k:
        _launch(kernels, kernels.lib.cuzk_verify, leaves.device,
                positions.data_ptr(), siblings.data_ptr(), leaves.data_ptr(),
                root.data_ptr(), ok.data_ptr(), k, h, arity)
        launch_counts["verify"] += 1
    return ok.bool()


# ---------------------------------------------------------------------------
# The per-op check kernel
# ---------------------------------------------------------------------------

def fr_op_cuda(op: str, a, b=None, c: int = 0) -> torch.Tensor:
    """One field operation of the device library on ``[n, 16]`` digits
    (``reduce_wide`` takes ``[n, 32]``): ``b`` for the binary ops, the
    constant ``c`` for ``mul_small``.  The plain ``fr`` op on the CPU."""
    code, plain = FR_OPS[op]
    a = fr.as_digits(a)
    if a.device.type == "cpu":
        if op == "mul_small":
            return plain(a, c)
        return plain(a) if b is None else plain(a, b)
    kernels = _build.kernels()
    n = a.shape[0]
    width = 2 * ND if op == "reduce_wide" else ND
    if a.dim() != 2 or a.shape[1] != width:
        raise ValidationError(f"{op} takes [n, {width}] digits, got {a.shape}")
    al = fr.digits_to_limbs(a.reshape(n, -1, ND)).reshape(n, -1).contiguous()
    bl = al
    if b is not None:
        bl = fr.digits_to_limbs(fr.as_digits(b, device=a.device)).contiguous()
        if tuple(bl.shape) != (n, NL):
            raise ValidationError(f"{op}: b must be [{n}, 16] digits")
    out = torch.empty((n, NL), dtype=torch.int32, device=a.device)
    if n:
        _launch(kernels, kernels.lib.cuzk_fr_op, a.device,
                code, al.data_ptr(), bl.data_ptr(), c, out.data_ptr(), n)
        launch_counts["fr_op"] += 1
    return fr.limbs_to_digits(out)
