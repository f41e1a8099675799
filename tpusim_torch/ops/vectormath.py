"""Vector helpers (counterpart of tpusim/ops/vectormath.py; ref:
pkg/utils/utils.go:1181-1272).

The Go versions return -1 on malformed input; shapes are fixed here, so only
the zero-magnitude guard is kept. Each reduces over the last axis, in the
float32 order of the JAX package's functions run op by op on the CPU.
"""

from __future__ import annotations

import torch

from tpusim_torch.ops.f32 import flush_subnormal, xla_exp
from tpusim_torch.ops.frag import tree_sum


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in XLA's order (`tree_sum`: element
    after element up to 32, then the tree's windows)."""
    return tree_sum(x.movedim(-1, 0), 1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (taken in float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CalculateVectorCosineSimilarity (utils.go:1196-1219): -1 where
    either vector has zero magnitude."""
    ma = _sqrt(_sum_last(a * a))
    mb = _sqrt(_sum_last(b * b))
    ok = (ma > 0) & (mb > 0)
    denom = torch.where(ok, ma * mb, torch.ones_like(ma))
    return torch.where(ok, _sum_last(a * b) / denom, -torch.ones_like(ma))


def dot_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """utils.go:1246-1256."""
    return _sum_last(a * b)


def l2_norm_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The squared L2 distance (utils.go:1258-1267)."""
    d = a - b
    return _sum_last(d * d)


def normalize_by(vec: torch.Tensor, norm) -> torch.Tensor:
    """vec / norm elementwise, 0 where norm <= 0 (NormalizeVector,
    utils.go:1221-1244)."""
    norm = torch.as_tensor(norm, dtype=vec.dtype, device=vec.device)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(norm > 0, vec / safe, torch.zeros_like(vec / safe))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """plugin_utils.go:76-78, with the JAX package's exp (`xla_exp`) and
    its flush of subnormal results to zero."""
    return flush_subnormal(1.0 / (1.0 + xla_exp(-x)))
