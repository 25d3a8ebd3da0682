"""cuzk_tpu_torch — the cuzk_tpu ZK hashing framework on PyTorch and CUDA.

A port of ``cuzk_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a): BN254-Fr arithmetic with the
reference's truncated k-fold reduction, the Poseidon sponge (t=3, R_F=8,
R_P=56, x^5), and n-ary (2-8) Merkle trees with proofs and batch
verification, bit-exact against the reference (SURVEY.md Appendix A).
``PARITY.md`` beside this file maps every public name of ``cuzk_tpu`` to
its counterpart here.

- field elements are ``[..., 16]`` 16-bit digit tensors at every public
  function, as in ``cuzk_tpu``; the kernels work on 8 x u32 limbs;
- every entry point runs on the card unless asked for the CPU: host data
  (numpy, lists) with no ``device=`` goes to CUDA device 0 and raises
  ``CudaUnavailableError`` without one; ``device="cpu"`` or CPU tensors
  take the plain PyTorch versions, tensors on a card the kernels
  (``utils.device.resolve_device``);
- :mod:`.oracle` (Python ints) and :mod:`.native` (C++) are the port's own
  oracles of the reference semantics;
- the kernels and native libraries build at their first use, never at
  import.

Submodules load lazily; importing the package builds nothing, and the
package imports neither jax nor ``cuzk_tpu``.
"""

__version__ = "0.1.0"

__all__ = [
    "oracle",
    "poseidon",
    "merkle",
    "engine",
    "field",
    "ops",
    "parallel",
    "utils",
    "native",
    "bench",
    "__version__",
]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"cuzk_tpu_torch.{name}")
    raise AttributeError(f"module 'cuzk_tpu_torch' has no attribute {name!r}")
