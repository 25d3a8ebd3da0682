"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper card and skips without one.  The
file imports no jax, so on a machine with a card and no jax it runs with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerance: none — every comparison is integer-exact.
"""

import numpy as np
import pytest
import torch

from cuzk_tpu import oracle
from cuzk_tpu_torch import merkle, poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import _build, poseidon_cuda
from cuzk_tpu_torch.utils import errors

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def digits(rng, shape, device):
    return torch.as_tensor(
        rng.integers(0, 1 << 16, tuple(shape) + (16,)), device=device
    )


def test_kernels_build_into_the_build_dir(cuda_device):
    kernels = _build.kernels()
    assert kernels.path.startswith(_build.BUILD_DIR)


@pytest.mark.parametrize("op", sorted(poseidon_cuda.FR_OPS))
def test_fr_op_kernel_matches_plain(op, cuda_device):
    rng = np.random.default_rng(19)
    a = digits(rng, (4096,), cuda_device)
    b = fr.red(digits(rng, (4096,), cuda_device))
    plain = poseidon_cuda.FR_OPS[op][1]
    if op == "reduce_wide":
        w = fr.mul_wide(a, b)
        got, want = poseidon_cuda.fr_op_cuda(op, w), plain(w)
    elif op == "mul_small":
        got, want = poseidon_cuda.fr_op_cuda(op, a, c=23), plain(a, 23)
    elif op == "add_rr":
        ra = fr.red(a)
        got, want = poseidon_cuda.fr_op_cuda(op, ra, b), plain(ra, b)
    elif op in ("mul", "add_wrap_red"):
        got, want = poseidon_cuda.fr_op_cuda(op, a, b), plain(a, b)
    else:
        got, want = poseidon_cuda.fr_op_cuda(op, a), plain(a)
    assert torch.equal(got, want)


@pytest.mark.parametrize("width", [0, 1, 2, 3, 5, 9, 16, 33])
def test_sponge_kernel_matches_plain(width, cuda_device):
    rng = np.random.default_rng(200 + width)
    g = digits(rng, (256, width), cuda_device)
    if width:
        g[3, 0, 1] += 1 << 16  # non-canonical digit: counts by value
    got = poseidon_cuda.hash_multiple_cuda(g)
    assert torch.equal(got, poseidon.hash_multiple(g))
    row = fr.array_to_ints(g[3])
    assert fr.array_to_ints(got[3])[0] == oracle.hash_multiple(
        [v & ((1 << 256) - 1) for v in row])


@pytest.mark.parametrize("n,arity", [(16, 2), (17, 3), (17, 4), (16, 8)])
def test_tree_and_verify_kernels_match_plain(n, arity, cuda_device):
    rng = np.random.default_rng(300 + n)
    leaves = digits(rng, (n,), cuda_device)
    levels = merkle.build_tree_levels(leaves, arity)
    plain = merkle.build_tree_levels(leaves.cpu(), arity)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(levels, plain))
    idx = [0, 1, n // 2, n - 1]
    pos, sib = merkle.generate_proofs(levels, arity, idx)
    proved = levels[0][idx].clone()
    pos[3, 0] = arity + 1  # out of range: the current node is dropped
    sib[2, 0, 0, 0] += 1 << 16
    proved[1, 0] ^= 1
    got = merkle.verify_proofs(pos, sib, proved, levels[-1][0], arity)
    want = merkle._verify_plain(pos, sib, proved, levels[-1][0], arity)
    assert torch.equal(got, want)
    assert got.tolist() == [True, False, False, False]


def test_verify_limbs_rejects_bad_arity_and_shapes(cuda_device):
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=cuda_device)

    pos, leaves, root = zeros(4, 1), zeros(4, 8), zeros(8)
    with pytest.raises(errors.ValidationError, match="arity"):
        poseidon_cuda.verify_limbs(pos, zeros(4, 1, 0, 8), leaves, root, 1)
    with pytest.raises(errors.ValidationError, match="disagree"):
        poseidon_cuda.verify_limbs(pos, zeros(4, 1, 1, 8), leaves, root, 3)
    with pytest.raises(errors.ValidationError, match="CUDA tensor"):
        poseidon_cuda.verify_limbs(pos, zeros(4, 1, 1, 8), leaves, root.cpu(), 2)
