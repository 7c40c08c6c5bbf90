"""TF32 rounding as the card's 3xTF32 products round (``csrc/tf32.cuh``),
for the plain emulations of K1-D's and K2-D's products
(``capsule_cuda.tf32x3_matmul_reference``) and of K4's float32 body
(``conv_dw.dw3x3_tf32x3_reference``)."""

from __future__ import annotations

import torch


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value (10 stored significand bits),
    ties away from zero, by bit arithmetic on the float32 pattern, as
    ``cvt.rna.tf32.f32`` rounds; infinities and NaNs pass unchanged."""
    bits = a.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(a), rounded, a.float())
