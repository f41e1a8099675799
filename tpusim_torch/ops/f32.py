"""Float32 arithmetic as the JAX package's compiled CPU code performs it.

XLA and LLVM rewrite two patterns that change float32 results, and the port
reproduces both where the JAX package's scoring code has them (XLA's own
float32 exp, `xla_exp`, is a third):

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


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """x with its subnormal values flushed to zero of the same sign, as
    XLA's CPU code runs (flush-to-zero)."""
    tiny = float(np.finfo(np.float32).tiny)
    return torch.where(x.abs() < tiny, x * 0.0, x)


def _f32_bits(v: int) -> float:
    return float(np.frombuffer(np.uint32(v).tobytes(), np.float32)[0])


# XLA's float32 exp on the CPU (its LLVM IR, jax 0.9): the clamp bounds,
# log2(e), ln(2) in two parts, and the polynomial's coefficients
_EXP_LO, _EXP_HI = _f32_bits(0xC2AF999A), _f32_bits(0x42B1999A)
_LOG2E = _f32_bits(0x3FB8AA3B)
_LN2_HI, _LN2_LO = 0.693359375, _f32_bits(0xB95E8083)
_EXP_POLY = tuple(_f32_bits(v) for v in (
    0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor as XLA's CPU build computes it (not
    correctly rounded): x clamped to [-87.8, 88.8], n = floor(x log2(e) +
    0.5) clamped to [-127, 127], r = x - n ln(2) in two parts, a degree-5
    polynomial p in Horner's form, then (1 + (r + p r^2)) x 2^n; each
    multiply that feeds an add contracted into an FMA, as LLVM contracts
    them."""
    x = x.to(torch.float32).clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(fma_f32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma_f32(-n, _LN2_HI, x)
    r = fma_f32(-n, _LN2_LO, r)
    p = fma_f32(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:] + (0.5,):
        p = fma_f32(p, r, c)
    y = 1.0 + fma_f32(p, r * r, r)
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale
