"""BN254-Fr field layer: plain PyTorch digit arithmetic (:mod:`.fr`)."""

from cuzk_tpu_torch.field import fr

__all__ = ["fr"]
