"""Node-axis padding (counterpart of pad_nodes in
tpusim/parallel/sharding.py).

The blocked replay summarises the cluster in whole 128-node blocks, so its
node axis is padded to a multiple of the block size with rows that no pod
can use.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpusim_torch.constants import NO_GPU
from tpusim_torch.types import NodeState

_INT_MAX = torch.iinfo(torch.int32).max


def pad_nodes(state: NodeState, rank: torch.Tensor,
              multiple: int) -> Tuple[NodeState, torch.Tensor]:
    """Pad the node axis to a multiple of `multiple` with never-feasible,
    never-chosen, metric-inert rows: mem_left = -1 fails every fit test
    (pod memory requests are >= 0), rank = INT_MAX loses every tie-break,
    and cpu_left = cpu_cap = gpu_cnt = 0 with gpu_type = NO_GPU keeps the
    row out of every cluster aggregate."""
    pad = (-state.num_nodes) % multiple
    if pad == 0:
        return state, rank

    def pad_rows(x: torch.Tensor, fill: int = 0) -> torch.Tensor:
        return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])

    fills = {"mem_left": -1, "gpu_type": NO_GPU}
    padded = NodeState(*(pad_rows(x, fills.get(name, 0))
                         for name, x in state._asdict().items()))
    return padded, pad_rank(rank, multiple)


def pad_rank(rank: torch.Tensor, multiple: int) -> torch.Tensor:
    """A tie-break rank padded as pad_nodes pads it: INT_MAX rows."""
    pad = (-rank.shape[0]) % multiple
    return torch.cat([rank, rank.new_full((pad,), _INT_MAX)]) if pad else rank


def trim_nodes(state: NodeState, num_nodes: int) -> NodeState:
    """The first `num_nodes` rows of a padded state."""
    return NodeState(*(x[:num_nodes] for x in state))
