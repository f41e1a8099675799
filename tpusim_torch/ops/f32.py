"""Float32 arithmetic as the JAX package's compiled CPU code performs it.

XLA and LLVM rewrite two patterns that change float32 results, and the port
reproduces both where the JAX package's scoring code has them:

- a division by a constant c becomes a multiplication by float32(1 / c)
  (`recip_f32`);
- a multiply feeding an add is contracted into one fused multiply-add,
  rounded once (`fma_f32`). Which multiply of a sum is fused follows LLVM's
  choice in the compiled code; each policy module says where.

The CUDA kernel does the same with `__fmul_rn` and `__fmaf_rn`; it is built
with `--fmad=false`, so nothing else is contracted.
"""

from __future__ import annotations

import numpy as np
import torch


def recip_f32(c: float) -> float:
    """float32(1 / c), the factor XLA multiplies by for a division by c."""
    return float(np.float32(1.0) / np.float32(c))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once: the product of two float32 values is
    exact in float64, and the sum is rounded to float32 once after a
    rounding to float64 (the two roundings differ from one only on a tie
    at float32 precision, about once in 2^29 operations)."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    c = c.double() if isinstance(c, torch.Tensor) else float(np.float32(c))
    return (a.double() * b + c).float()
