"""What every policy shares (counterpart of tpusim/policies/base.py): the
per-pod scorers' context and result, and the score normalisation (ref:
plugin_utils.go:48-74 NormalizeScore and pwr_score.go:104-139).

A policy's per-pod scorer is `(state, pod, ctx) -> PolicyResult` over all N
nodes, where `pod` is a PodSpec of host scalars (Python ints): the scorers
run the policies' column functions on the pod as a one-type batch
(`column_scorer`), so the sequential oracle and the replays' tables score
with the same float32 order.

The reference min-max rescales a policy's raw scores over the feasible
nodes to [0, MAX_NODE_SCORE] with integer division; a zero range maps every
node to the mode's degenerate value. Infeasible entries pass through
unchanged: the select never reads them.

The arithmetic is XLA's int32: `(raw - lo) * MAX_NODE_SCORE` and the range
wrap modulo 2^32, and `//` is a floor division. The port computes in int64
and wraps explicitly, so the result does not depend on how torch treats an
int32 overflow.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tpusim_torch.constants import MAX_NODE_SCORE
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

_INT_MAX = torch.iinfo(torch.int32).max

# zero-range (all-equal) value per normalize mode
NORMALIZE_DEGENERATE = {"minmax": 0, "pwr": MAX_NODE_SCORE}


class ScoreContext(NamedTuple):
    """What a per-pod scorer may read beside the state and the pod: the
    typical pods (FGD), the Filter mask (RandomScore draws over the
    feasible nodes) and the event's key k_rand (RandomScore; two ints)."""

    tp: TypicalPods
    feasible: torch.Tensor  # bool[N]
    rng: object  # (k0, k1), or None where nothing draws


class PolicyResult(NamedTuple):
    raw_scores: torch.Tensor  # i32[N]
    share_dev: torch.Tensor  # i32[N] the policy's share-GPU device, -1 none


def pod_as_type(pod: PodSpec, device) -> PodSpec:
    """A pod of host scalars as a one-type PodSpec of [1] int32 tensors on
    `device`. Each field is a fill on the device, so nothing waits on a
    copy to the card."""
    return PodSpec(*(torch.full((1,), int(v), dtype=torch.int32,
                                device=device) for v in pod))


def column_scorer(column: Callable) -> Callable:
    """The per-pod scorer of a column function: the column on the pod as
    the only type (a share type where the pod is a share-GPU pod)."""

    def score(state: NodeState, pod: PodSpec,
              ctx: ScoreContext) -> PolicyResult:
        one = pod_as_type(pod, state.cpu_left.device)
        raw, dev = column(state, one, int(bool(pod.is_gpu_share())), ctx.tp)
        return PolicyResult(raw[0], dev[0])

    return score


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 modulo 2^32, as int32."""
    x = x.to(torch.int64)
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def feasible_min_max(scores: torch.Tensor, feasible: torch.Tensor):
    """(lo, hi) of the scores over the feasible entries of the last axis;
    (INT_MAX, -INT_MAX) where none is feasible."""
    lo = torch.where(feasible, scores, _INT_MAX).min(-1).values
    hi = torch.where(feasible, scores, -_INT_MAX).max(-1).values
    return lo, hi


def minmax_scale_i32(scores, feasible, lo, hi, degenerate: int):
    """Rescale against the extrema `lo`, `hi` (broadcast over the last
    axis): (scores - lo) * MAX_NODE_SCORE // max(hi - lo, 1), or
    `degenerate` where hi == lo; infeasible entries unchanged."""
    lo, hi = lo.to(torch.int64)[..., None], hi.to(torch.int64)[..., None]
    rng = wrap_i32(hi - lo).to(torch.int64)
    num = wrap_i32(wrap_i32(scores.to(torch.int64) - lo).to(torch.int64)
                   * MAX_NODE_SCORE).to(torch.int64)
    scaled = torch.div(num, rng.clamp(min=1), rounding_mode="floor")
    scaled = torch.where(rng == 0, degenerate, scaled).to(torch.int32)
    return torch.where(feasible, scaled, scores)


def minmax_normalize_i32(scores, feasible):
    """Min-max rescale over the feasible entries; all equal -> 0."""
    lo, hi = feasible_min_max(scores, feasible)
    return minmax_scale_i32(scores, feasible, lo, hi, 0)


def pwr_normalize_i32(scores, feasible):
    """PWR's own rescale: as min-max, but all equal -> MAX_NODE_SCORE."""
    lo, hi = feasible_min_max(scores, feasible)
    return minmax_scale_i32(scores, feasible, lo, hi, MAX_NODE_SCORE)


def normalize(mode: str, scores, feasible):
    """The normalisation of `mode` ("none", "minmax" or "pwr")."""
    if mode == "none":
        return scores
    return {"minmax": minmax_normalize_i32,
            "pwr": pwr_normalize_i32}[mode](scores, feasible)
