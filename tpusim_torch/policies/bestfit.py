"""BestFit (counterpart of tpusim/policies/bestfit.py and the Pallas column
_bestfit_column; ref: plugin/best_fit_score.go:66-97).

score = floor((1 - sum_i 0.5 x (free_i - req_i) / maxSpec_i) x 100) over
{milli-CPU, milli-GPU}, maxSpec = 128000 / 8000; min-max normalised.

Float order, as the JAX package's compiled code computes it: each
`/ maxSpec * 0.5` is one multiplication by float32(1 / maxSpec) / 2, and
the CPU term's multiplication is fused into the sum:
s = fma(free_cpu - req_cpu, r_cpu / 2, (free_gpu - req_gpu) x r_gpu / 2).
"""

from __future__ import annotations

import torch

from tpusim_torch.constants import MAX_NODE_SCORE, MAX_SPEC_CPU, MAX_SPEC_GPU
from tpusim_torch.ops.f32 import fma_f32, recip_f32
from tpusim_torch.policies.base import column_scorer
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

_R_CPU = recip_f32(MAX_SPEC_CPU)
_R_GPU = recip_f32(MAX_SPEC_GPU)


def bestfit_column(nodes: NodeState, types: PodSpec, ks: int,
                   tp: TypicalPods):
    """BestFit raw score i32[K, B] of every type on a batch of B nodes, and
    no device pick (-1)."""
    free_cpu = nodes.cpu_left.to(torch.float32)
    free_gpu = nodes.gpu_left.sum(-1).to(torch.float32)
    req_cpu = types.cpu.to(torch.float32)[:, None]
    req_gpu = (types.gpu_milli * types.gpu_num).to(torch.float32)[:, None]
    s = fma_f32(free_cpu - req_cpu, _R_CPU * 0.5,
                (free_gpu - req_gpu) * (_R_GPU * 0.5))
    score = torch.floor((1.0 - s) * float(MAX_NODE_SCORE)).to(torch.int32)
    return score, torch.full_like(score, -1)


# the per-pod scorer: (state, pod, ctx) -> PolicyResult over every node
bestfit_score = column_scorer(bestfit_column)
