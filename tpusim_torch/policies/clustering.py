"""GpuClustering (counterpart of tpusim/policies/clustering.py and the Pallas
column _clustering_column; ref: plugin/gpu_clustering_score.go:32-56).

A quartile by the node's GPU-affinity classes against the pod's class
(share GPU, or N whole GPUs; pod.go:111-123), plus the packing term
25 x (8000 - total GPU left) // 8000 inside it:

  (75, 100] the node's only class is the pod's
  (50,  75] several classes, the pod's among them
  (25,  50] an idle node (no GPU pod at all)
  ( 0,  25] only other classes
  0         the pod requests no GPU
"""

from __future__ import annotations

import torch

from tpusim_torch.constants import (
    MAX_NODE_SCORE,
    MAX_SPEC_GPU,
    MILLI,
    NUM_AFF_CLASSES,
)
from tpusim_torch.policies.base import column_scorer
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

_Q = MAX_NODE_SCORE // 4  # 25


def affinity_class(types: PodSpec) -> torch.Tensor:
    """Share-GPU pod -> 0, N whole GPUs -> N, no GPU -> -1, per type."""
    share = (types.gpu_num == 1) & (types.gpu_milli < MILLI)
    cls = torch.where(share, 0, types.gpu_num)
    return torch.where(types.gpu_num == 0, -1, cls).to(torch.int32)


def pod_affinity_class(pod: PodSpec) -> int:
    """The affinity class of one pod of host scalars (the per-pod form of
    affinity_class): share-GPU -> 0, N whole GPUs -> N, no GPU -> -1."""
    if pod.gpu_num == 0:
        return -1
    if pod.gpu_num == 1 and pod.gpu_milli < MILLI:
        return 0
    return int(pod.gpu_num)


def clustering_column(nodes: NodeState, types: PodSpec, ks: int,
                      tp: TypicalPods):
    """GpuClustering raw score i32[K, B] of every type on a batch of B
    nodes, and no device pick (-1)."""
    counts = nodes.aff_cnt  # [B, 9]
    n_classes = (counts > 0).sum(-1)  # [B]
    cls = affinity_class(types)  # [K]
    # a class past the 9 counted ones (more than 8 GPUs) is on no node
    in_range = (cls < NUM_AFF_CLASSES)[:, None]
    idx = cls.clamp(0, NUM_AFF_CLASSES - 1).long()
    has_cls = in_range & (counts.T[idx] > 0)  # [K, B]
    total = nodes.gpu_left.sum(-1)
    pack = _Q * (MAX_SPEC_GPU - total) // MAX_SPEC_GPU  # [B]
    base = torch.where(has_cls, torch.where(n_classes == 1, 3 * _Q, 2 * _Q),
                       torch.where(n_classes == 0, _Q, 0))
    score = torch.where(cls[:, None] < 0, 0, base + pack).to(torch.int32)
    return score, torch.full_like(score, -1)


# the per-pod scorer: (state, pod, ctx) -> PolicyResult over every node
clustering_score = column_scorer(clustering_column)
