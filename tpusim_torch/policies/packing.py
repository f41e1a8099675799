"""GpuPacking (counterpart of tpusim/policies/packing.py and the Pallas
column _packing_column; ref: plugin/gpu_packing_score.go:67-117), three
tiers in integers:

  case 1, only partly used GPUs: max(100 - sum trunc(left x 100 / 1000) / 10, 50)
  case 2, dips into idle GPUs:    max(50 - #idle GPUs used, 33)
  case 3, an all-idle node:       max(33 - #idle GPUs, #idle GPUs)

The allocation is Sub's: fitting devices, least free first, ties by index.
"""

from __future__ import annotations

import torch

from tpusim_torch.constants import MAX_NODE_SCORE, MILLI
from tpusim_torch.ops.resource import select_devices_packed
from tpusim_torch.policies.base import column_scorer
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

_T3 = MAX_NODE_SCORE // 3  # 33
_T2 = MAX_NODE_SCORE // 2  # 50


def packing_column(nodes: NodeState, types: PodSpec, ks: int,
                   tp: TypicalPods):
    """GpuPacking raw score i32[K, B] of every type on a batch of B nodes,
    and no device pick (-1)."""
    g = nodes.gpu_left  # [B, 8]
    idle = g == MILLI
    fully_free = idle.sum(-1, dtype=torch.int32)  # [B]
    case3 = torch.maximum(_T3 - fully_free, fully_free)
    take, ok = select_devices_packed(g[None], types.gpu_milli[:, None],
                                     types.gpu_num[:, None])  # [K, B, 8]
    free_used = (take & idle).sum(-1, dtype=torch.int32)
    ratio = torch.where(take, g * 100 // MILLI, 0).sum(-1, dtype=torch.int32)
    case1 = torch.clamp(MAX_NODE_SCORE - ratio // 10, min=_T2)
    case2 = torch.clamp(_T2 - free_used, min=_T3)
    score = torch.where(
        fully_free == nodes.gpu_cnt, case3,
        torch.where(~ok, 0, torch.where(free_used > 0, case2, case1)))
    needs_gpu = (types.gpu_milli * types.gpu_num > 0)[:, None]
    score = torch.where(needs_gpu, score, 0).to(torch.int32)
    return score, torch.full_like(score, -1)


# the per-pod scorer: (state, pod, ctx) -> PolicyResult over every node
packing_score = column_scorer(packing_column)
