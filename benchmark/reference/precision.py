"""The arithmetic the reference runs in: float64, or float32 with the
operands of every matrix product rounded to TF32 (10 mantissa bits,
products accumulated in float32), as the card's TF32 mode computes a
float32 product.  The rounding is written out so that the control runs
alike on the CPU and on the card."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value, ties away from zero;
    non-finite entries unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


class Arith:
    """dtype and matrix products: `tf32=True` (float32 only) rounds both
    operands of each product to TF32."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounding applies to float32 products")
        self.dtype = dtype
        self.tf32 = tf32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (batched)."""
        return self.r(a) @ self.r(b)

    def mv(self, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """M (..., r, c) times v (..., c)."""
        return (self.r(M) @ self.r(v)[..., None])[..., 0]

    def mtv(self, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """M' (..., c, r) times v (..., r)."""
        return (self.r(M).transpose(-1, -2) @ self.r(v)[..., None])[..., 0]
