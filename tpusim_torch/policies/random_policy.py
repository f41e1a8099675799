"""RandomScore (counterpart of tpusim/policies/random_policy.py; ref:
plugin/random_score.go:42-68).

PreScore draws one node uniformly from the feasible ones; Score gives it 100
and every other node 0; no normalisation. The draw is tpusim's: the node
with the largest `uniform(k_rand, (N,))` among the feasible ones, the first
on ties, node 0 where none is feasible (the event then fails at
selectHost). Ties of 23-bit uniforms are common over a thousand nodes, so
the first-index rule decides real placements.

Its score is a draw per event, not a function of the node state, so it
has no table column: the replays draw `random_row` each event from the
event's key (tpusim_torch.ops.prng.event_keys), and the sequential
oracle's per-pod scorer `random_score` from its context's key.
"""

from __future__ import annotations

import torch

from tpusim_torch.constants import MAX_NODE_SCORE
from tpusim_torch.ops.prng import uniform
from tpusim_torch.policies.base import PolicyResult, ScoreContext
from tpusim_torch.types import NodeState, PodSpec


def random_row(key, feasible: torch.Tensor) -> torch.Tensor:
    """RandomScore's raw scores i32[N] of one event: 100 on the draw, 0
    elsewhere. The pick stays on the device."""
    n = feasible.shape[0]
    u = uniform(key, n, feasible.device)
    pick = torch.where(feasible, u, -1.0).argmax()
    lane = torch.arange(n, device=feasible.device)
    return torch.where(lane == pick, MAX_NODE_SCORE, 0).to(torch.int32)


def random_score(state: NodeState, pod: PodSpec,
                 ctx: ScoreContext) -> PolicyResult:
    """The per-pod scorer: the draw of the context's key over its feasible
    nodes, and no device pick."""
    score = random_row(ctx.rng, ctx.feasible)
    return PolicyResult(score, torch.full_like(score, -1))
