"""Rounding to TF32 and the dtype of each precision."""

import torch

PRECISIONS = ("float64", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest, ties
    to even, as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & -0x2000).view(torch.float32)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as an operand of a product in ``precision``."""
    if precision == "float64":
        return x.double()
    if precision == "tf32":
        return to_tf32(x.float())
    raise ValueError(f"unknown precision {precision!r}")


def dtype(precision: str) -> torch.dtype:
    """The type that sums and elementwise work take in ``precision``."""
    return torch.float64 if precision == "float64" else torch.float32
