"""PWR, power-aware scoring (counterpart of tpusim/policies/pwr.py and the
Pallas column _pwr_column; ref: plugin/pwr_score.go).

score = trunc(old watts - new watts) after placing the pod hypothetically:
on every fitting device for a share-GPU pod, keeping the first best device
(pwr_score.go:150-200); with Sub for whole-GPU and CPU-only pods
(pwr_score.go:204-218). The watts change through two channels only: the
CPU package count, from cpu_left - pod.cpu, and devices that flip from
fully idle to working. Raw scores are <= 0; PWR's own normalisation maps
them to [0, 100] with the all-equal case at 100.

The branch follows the pod (one GPU, under 1000 milli), not the type's
group, as the JAX package's policy does.
"""

from __future__ import annotations

import torch

from tpusim_torch.constants import MAX_GPUS_PER_NODE, MILLI
from tpusim_torch.ops.energy import (
    cpu_power_watts,
    gpu_busy_delta_watts,
    gpu_power_watts,
)
from tpusim_torch.ops.resource import select_devices_packed
from tpusim_torch.policies.base import column_scorer
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

NEG = -(2**31) + 1  # the share branch's "no fitting device" score


def pwr_column(nodes: NodeState, types: PodSpec, ks: int, tp: TypicalPods):
    """PWR raw score and PWR's share-device pick, i32[K, B] each, of every
    type on a batch of B nodes."""
    g = nodes.gpu_left  # [B, 8]
    gpu_old = gpu_power_watts(g, nodes.gpu_cnt, nodes.gpu_type)  # [B]
    old = cpu_power_watts(nodes.cpu_left, nodes.cpu_cap, nodes.cpu_type) \
        + gpu_old
    cpu_new = cpu_power_watts(nodes.cpu_left - types.cpu[:, None],
                              nodes.cpu_cap, nodes.cpu_type)  # [K, B]
    busy = gpu_busy_delta_watts(nodes.gpu_type)  # [B]
    was_idle = g == MILLI
    milli = types.gpu_milli[:, None, None]

    # share: device d flips iff it was fully idle and the pod takes milli
    flip_d = was_idle & (milli > 0)  # [K, B, 8]
    new_d = (cpu_new + gpu_old)[..., None] + torch.where(
        flip_d, busy[:, None], 0.0)
    fits = g >= milli
    dev = torch.where(fits, (old[:, None] - new_d).to(torch.int32), NEG)
    best = dev.max(-1).values
    lane = torch.arange(MAX_GPUS_PER_NODE, device=g.device, dtype=torch.int32)
    best_dev = torch.where(dev == best[..., None], lane,
                           MAX_GPUS_PER_NODE).min(-1).values
    any_fit = fits.any(-1)
    share_score = torch.where(any_fit, best, NEG)
    share_dev = torch.where(any_fit, best_dev, -1)

    # whole GPUs / CPU only: Sub's taken devices flip iff they were idle
    take, _ = select_devices_packed(g[None], types.gpu_milli[:, None],
                                    types.gpu_num[:, None])
    take = take & (types.gpu_num > 0)[:, None, None]
    flips = (take & was_idle).sum(-1).to(torch.float32)
    whole = (old - (cpu_new + gpu_old + flips * busy)).to(torch.int32)

    share = ((types.gpu_num == 1) & (types.gpu_milli < MILLI))[:, None]
    return (torch.where(share, share_score, whole).to(torch.int32),
            torch.where(share, share_dev, -1).to(torch.int32))


# the per-pod scorer: (state, pod, ctx) -> PolicyResult over every node
pwr_score = column_scorer(pwr_column)
