"""RandomScore (counterpart of tpusim/policies/random_policy.py; ref:
plugin/random_score.go:42-68).

PreScore draws one node uniformly from the feasible ones; Score gives it 100
and every other node 0; no normalisation. The draw is tpusim's: the node
with the largest `uniform(k_rand, (N,))` among the feasible ones, the first
on ties, node 0 where none is feasible (the event then fails at
selectHost). Ties of 23-bit uniforms are common over a thousand nodes, so
the first-index rule decides real placements.

Its score is a draw per event, not a function of the node state, so it
has no table column: the replays compute `random_score` each event from
the event's key (tpusim_torch.ops.prng.event_keys).
"""

from __future__ import annotations

import torch

from tpusim_torch.constants import MAX_NODE_SCORE
from tpusim_torch.ops.prng import uniform


def random_pick(key, feasible: torch.Tensor) -> int:
    """The node RandomScore gives 100 on this event: the argmax of
    where(feasible, uniform(key, (N,)), -1), the first on ties."""
    u = uniform(key, feasible.shape[0], feasible.device)
    return int(torch.where(feasible, u, -1.0).argmax())


def random_score(key, feasible: torch.Tensor) -> torch.Tensor:
    """RandomScore's raw scores i32[N] of one event."""
    pick = random_pick(key, feasible)
    score = torch.zeros(feasible.shape[0], dtype=torch.int32,
                        device=feasible.device)
    score[pick] = MAX_NODE_SCORE
    return score
