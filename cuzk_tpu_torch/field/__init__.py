"""BN254-Fr field layer: plain PyTorch digit arithmetic (:mod:`.fr`) and the
batched ops with timing stats (:mod:`.batch`, imported on its own)."""

from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.field.fr import (
    DIGIT_BITS,
    NDIGITS,
    add,
    array_to_ints,
    digits_to_int,
    eq,
    int_to_digits,
    ints_to_array,
    is_zero,
    mul,
    mul_small,
    power5,
    red,
    square,
    sub,
)

__all__ = [
    "fr",
    "NDIGITS",
    "DIGIT_BITS",
    "add",
    "sub",
    "mul",
    "square",
    "power5",
    "mul_small",
    "red",
    "eq",
    "is_zero",
    "int_to_digits",
    "digits_to_int",
    "ints_to_array",
    "array_to_ints",
]
