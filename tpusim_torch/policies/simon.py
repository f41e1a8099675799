"""Simon (counterpart of tpusim/policies/simon.py; ref: plugin/simon.go:47-71).

score = round(100 x max over (milli-CPU, MiB, milli-GPU) of
share(req, cap - req)), with share(a, t) = a / t, or 1 where t == 0 and
a > 0 (0 where both are 0) (algo/greed.go:78-91). The base is the node's
capacity, not what is free: the reference reads the static Allocatable,
so the column never changes during a replay. Min-max normalised.

Float order, as the JAX package's compiled table build computes it: float32
capacity minus float32 request, a true division, the dims' max from 0 in
the order CPU, memory, GPU, then 100 x max rounded half to even and
converted to int32 (saturating).
"""

from __future__ import annotations

import torch

from tpusim_torch.constants import MAX_NODE_SCORE, MILLI
from tpusim_torch.policies.base import column_scorer
from tpusim_torch.types import NodeState, PodSpec, TypicalPods


def _share(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    zero = total == 0
    frac = alloc / torch.where(zero, torch.ones_like(total), total)
    return torch.where(zero, (alloc != 0).to(torch.float32), frac)


def simon_column(nodes: NodeState, types: PodSpec, ks: int,
                 tp: TypicalPods):
    """Simon raw score i32[K, B] of every type on a batch of B nodes, and no
    device pick (-1)."""
    req = (types.cpu, types.mem, types.gpu_milli * types.gpu_num)
    cap = (nodes.cpu_cap, nodes.mem_cap, nodes.gpu_cnt * MILLI)
    res = torch.zeros((types.cpu.shape[0], nodes.cpu_cap.shape[0]),
                      dtype=torch.float32, device=nodes.cpu_cap.device)
    for r, c in zip(req, cap):
        a = r.to(torch.float32)[:, None]
        res = torch.maximum(res, _share(a, c.to(torch.float32)[None] - a))
    scaled = torch.round(res * float(MAX_NODE_SCORE))
    # XLA's float -> int32 saturates; the scores are >= 0
    score = torch.where(scaled >= 2.0**31, torch.iinfo(torch.int32).max,
                        scaled.clamp(max=2.0**31 - 128).to(torch.int32))
    return score, torch.full_like(score, -1)


# the per-pod scorer: (state, pod, ctx) -> PolicyResult over every node
simon_score = column_scorer(simon_column)
