"""Replay result, event kinds and the per-event report rows (counterpart of
tpusim/sim/engine.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpusim_torch.constants import MILLI
from tpusim_torch.ops.energy import node_power
from tpusim_torch.types import NodeState

EV_CREATE = 0
EV_DELETE = 1
EV_SKIP = 2  # padding / pods carrying the pod-unscheduled annotation
# fault events (tpusim_torch.sim.faults): the segmented host loop applies
# them between replays; the in-scan lane (tpusim_torch.sim.fault_lane)
# merges them into the event stream of the replays' fault forms
EV_NODE_FAIL = 3  # a node crashes; its pods are evicted into the retry queue
EV_NODE_RECOVER = 4  # the node returns, empty
EV_EVICT = 5  # one pod is evicted and re-enters through the retry queue
EV_RETRY = 6  # the lane's retry slot: pops a due pod and creates it, or skips


class EventMetrics(NamedTuple):
    """Per-event report rows (analysis.go:59-126, the [Report], [Alloc],
    [AllocCPU] and [Power] lines): the cluster after each event."""

    frag_amounts: torch.Tensor  # f32[E, 7]
    used_nodes: torch.Tensor  # i32[E]
    used_gpus: torch.Tensor  # i32[E]
    used_gpu_milli: torch.Tensor  # i32[E]
    used_cpu_milli: torch.Tensor  # i32[E]
    arrived_gpu_milli: torch.Tensor  # i32[E]
    arrived_cpu_milli: torch.Tensor  # i32[E]
    power_cpu: torch.Tensor  # f32[E]
    power_gpu: torch.Tensor  # f32[E]


class ReplayResult(NamedTuple):
    state: NodeState
    placed_node: torch.Tensor  # i32[P], -1 = unscheduled/not-arrived/deleted
    dev_mask: torch.Tensor  # bool[P, 8]
    ever_failed: torch.Tensor  # bool[P] creation attempted and rejected
    metrics: object  # EventMetrics after the post-pass, else None
    event_node: torch.Tensor  # i32[E] chosen node (create) / freed node
    event_dev: torch.Tensor  # bool[E, 8] devices touched at each event


def cluster_usage(state: NodeState):
    """The [Alloc]/[AllocCPU] aggregates of a state, int32 scalars
    (analysis.go:91-99): a node is used if any GPU is not fully idle or any
    CPU is taken, and a used node counts all its GPUs."""
    fully_free = (state.gpu_left == MILLI).sum(-1)
    used = (fully_free < state.gpu_cnt) | (state.cpu_left < state.cpu_cap)
    zero = torch.zeros_like(state.gpu_cnt)
    total_left = state.gpu_left.sum(-1, dtype=torch.int32)
    return (
        used.sum().to(torch.int32),
        torch.where(used, state.gpu_cnt, zero).sum().to(torch.int32),
        torch.where(used, state.gpu_cnt * MILLI - total_left,
                    zero).sum().to(torch.int32),
        torch.where(used, state.cpu_cap - state.cpu_left,
                    zero).sum().to(torch.int32),
    )


def power_rows(state: NodeState):
    """(cpu watts, gpu watts) per node (ClusterPowerConsumptionReport,
    analysis.go:24-56)."""
    return node_power(state.cpu_left, state.cpu_cap, state.gpu_left,
                      state.gpu_cnt, state.gpu_type, state.cpu_type)
