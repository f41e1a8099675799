"""Fault injection: node crash and recovery and pod eviction (counterpart
of tpusim/sim/faults.py): the schedule, its validation, the eviction draw
and the node transitions.

The segmented host loop (Simulator._schedule_pods_with_faults_segmented)
splits the trace at the fault positions, replays each segment through the
normal kernels (Simulator.run_events) and applies the transitions between
segments; the in-scan lane (tpusim_torch.sim.fault_lane) merges them into
the replay's event stream instead.

A schedule is an explicit FaultEvent list, or is drawn by
generate_fault_schedule from a seeded numpy generator: geometric gaps
between failures, repairs and evictions, counted in events, so a fixed seed
gives the same schedule on any device.

A down node is mem_left == -1: every request's memory check fails there
(a pod's memory request is never negative), so the kernels need no new
input. The rest of its row is reset to idle capacity, so a down node adds
nothing to the used-capacity totals; the capacity it holds while down is
counted apart (DisruptionMetrics.failed_node_gpu_events).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpusim_torch.constants import MAX_GPUS_PER_NODE, MILLI
from tpusim_torch.sim.engine import EV_EVICT, EV_NODE_FAIL, EV_NODE_RECOVER
from tpusim_torch.types import NodeState

FAULT_KINDS = (EV_NODE_FAIL, EV_NODE_RECOVER, EV_EVICT)


@dataclass(frozen=True)
class FaultEvent:
    """One fault, between two events of the trace.

    pos: the fault fires after `pos` trace events have been replayed
    (clamped to the trace length; faults at one position fire in list
    order). kind: EV_NODE_FAIL | EV_NODE_RECOVER | EV_EVICT. node: the
    node (fail, recover). pod: the pod of an EV_EVICT; -1 draws a placed
    pod at replay time."""

    pos: int
    kind: int
    node: int = -1
    pod: int = -1


@dataclass
class FaultConfig:
    """The knobs of the seeded schedule and of the retry policy.

    mtbf_events / mttr_events: mean events between node failures / until a
    failed node returns (0: no failures / a failed node never returns).
    evict_every_events: mean events between single-pod evictions (0: none).
    An evicted pod re-enters the stream min(backoff_base * 2^(attempt-1),
    backoff_cap) events after its eviction; after max_retries failed
    attempts in a row it is terminal (reason "max-retries-exceeded"), and a
    successful reschedule resets the count. The host loop's queue is
    unbounded; the in-scan lane's holds queue_capacity entries
    (fault_lane.resolve_capacity: 0 = min(pods, 256)), and a pod pushed
    past it is terminal too."""

    mtbf_events: float = 0.0
    mttr_events: float = 0.0
    evict_every_events: float = 0.0
    seed: int = 0
    max_retries: int = 3
    backoff_base: int = 8
    backoff_cap: int = 256
    queue_capacity: int = 0


def _geometric(rng: np.random.Generator, mean: float) -> int:
    """A whole gap >= 1 with the given mean (geometric: MTBF counted in
    events)."""
    p = min(1.0, 1.0 / max(mean, 1.0))
    return int(rng.geometric(p))


def generate_fault_schedule(num_nodes: int, num_events: int,
                            cfg: FaultConfig) -> List[FaultEvent]:
    """The seeded schedule over a trace of num_events events.

    One walk draws geometric gaps between failures; each failure takes a
    node drawn uniformly from those up at that position and, when
    mttr_events > 0, brings it back a geometric repair gap later. A second
    walk places single-pod evictions (the pod is drawn at replay time).
    The same (cfg.seed, num_nodes, num_events) gives the same schedule."""
    rng = np.random.default_rng(cfg.seed)
    events: List[FaultEvent] = []
    if cfg.mtbf_events > 0 and num_nodes > 0:
        recover_at = {}  # node -> its recovery position
        t = _geometric(rng, cfg.mtbf_events)
        while t < num_events:
            up = [i for i in range(num_nodes) if recover_at.get(i, -1) <= t]
            if not up:
                t += _geometric(rng, cfg.mtbf_events)
                continue
            node = int(up[rng.integers(0, len(up))])
            events.append(FaultEvent(pos=t, kind=EV_NODE_FAIL, node=node))
            if cfg.mttr_events > 0:
                back = t + _geometric(rng, cfg.mttr_events)
                recover_at[node] = back
                if back < num_events:
                    events.append(
                        FaultEvent(pos=back, kind=EV_NODE_RECOVER, node=node))
            else:
                recover_at[node] = num_events + 1  # lost for good
            t += _geometric(rng, cfg.mtbf_events)
    if cfg.evict_every_events > 0:
        t = _geometric(rng, cfg.evict_every_events)
        while t < num_events:
            events.append(FaultEvent(pos=t, kind=EV_EVICT))
            t += _geometric(rng, cfg.evict_every_events)
    events.sort(key=lambda e: e.pos)  # stable: faults at one position keep order
    return events


def is_down(state: NodeState) -> torch.Tensor:
    """bool[N]: the nodes that carry the down marker."""
    return state.mem_left < 0


def _reset_node(state: NodeState, node: int, mem_left: int) -> NodeState:
    """A new state whose row `node` is empty at capacity with the given
    mem_left (fail and recover differ in that value only); `state` is left
    as it was."""
    node = int(node)
    cnt = int(state.gpu_cnt[node])
    full = (torch.arange(MAX_GPUS_PER_NODE, device=state.gpu_left.device)
            < cnt).to(state.gpu_left.dtype) * MILLI

    def row_set(a: torch.Tensor, value) -> torch.Tensor:
        out = a.clone()
        out[node] = value
        return out

    return state._replace(
        cpu_left=row_set(state.cpu_left, state.cpu_cap[node]),
        mem_left=row_set(state.mem_left, int(mem_left)),
        gpu_left=row_set(state.gpu_left, full),
        aff_cnt=row_set(state.aff_cnt, 0),
    )


def fail_node(state: NodeState, node: int) -> NodeState:
    """Crash one node: its row becomes the down encoding (mem_left -1
    blocks every request; cpu and devices read as idle, so the dead node
    adds nothing to the used totals). The caller evicts the node's pods;
    their resources need no return, for the row is rebuilt from
    capacity."""
    return _reset_node(state, node, -1)


def recover_node(state: NodeState, node: int) -> NodeState:
    """Bring a failed node back, empty: its former pods are in the retry
    queue or placed elsewhere."""
    return _reset_node(state, node, int(state.mem_cap[int(node)]))


def pick_eviction_victim(placed: np.ndarray, pos: int, seed: int,
                         explicit_pod: int = -1) -> Optional[int]:
    """The pod an EV_EVICT takes: the explicit pod if it is placed, else a
    uniform draw over the placed pods from a generator seeded by the
    schedule's seed and the position (two runs of one schedule evict the
    same pods). None when nothing is placed."""
    if explicit_pod >= 0:
        return explicit_pod if placed[explicit_pod] >= 0 else None
    candidates = np.flatnonzero(placed >= 0)
    if candidates.size == 0:
        return None
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(pos) * 2654435761)
    return int(candidates[rng.integers(0, candidates.size)])


def validate_fault_schedule(faults: Sequence[FaultEvent], num_nodes: int,
                            num_pods: int) -> None:
    """Raise on a fault whose kind, target or position is out of range
    (a bad target must not become a silent no-op)."""
    for i, ev in enumerate(faults):
        if ev.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault {i}: kind {ev.kind} is not EV_NODE_FAIL={EV_NODE_FAIL}"
                f" | EV_NODE_RECOVER={EV_NODE_RECOVER} | EV_EVICT={EV_EVICT}"
            )
        if ev.kind in (EV_NODE_FAIL, EV_NODE_RECOVER) and not (
            0 <= ev.node < num_nodes
        ):
            raise ValueError(
                f"fault {i}: node {ev.node} out of range for {num_nodes} nodes"
            )
        if ev.kind == EV_EVICT and ev.pod >= num_pods:
            raise ValueError(
                f"fault {i}: pod {ev.pod} out of range for {num_pods} pods"
            )
        if ev.pos < 0:
            raise ValueError(f"fault {i}: negative position {ev.pos}")
