"""The per-event report rows, rebuilt from a replay's telemetry, and the
fault replay's disruption totals (counterpart of tpusim/sim/metrics.py
compute_event_metrics and DisruptionMetrics).

A replay emits the node each event touched (`event_node`) and the devices
it touched (`event_dev`). From those alone, in a few batched tensor ops on
the telemetry's device:

  1. each event's touched node after the event, by a cumulative sum of the
     resources taken, segmented by node (integers, exact);
  2. that node's frag and power rows after the event, batched over the
     events;
  3. the cluster series: the initial totals plus a cumulative sum of the
     per-event row changes.

The integer series are exact in any order. The float32 frag series are
printed with enough digits for their order to show, so each float sum
follows the reference's CPU build as XLA compiles this function there:
once an axis is longer than 32, the initial total in one tree sum over
nodes and typical pods (`ops.frag.tree_sum`) and each row in the tree's
windows over the typical pods; else the vectorised loops LLVM makes of
them (`ops.frag.initial_total`, `initial_rows`, `row_stages`); and the
cumulative sums in XLA's blocked scan (`xla_cumsum`). Every step is an
elementwise add, so the card gives the CPU's bits. The power rows are
whole watts, exact in float32 at any cluster size the port runs, but take
the same orders.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch

from tpusim_torch.constants import MILLI
from tpusim_torch.ops.energy import node_power
from tpusim_torch.ops.frag import (
    initial_rows,
    initial_total,
    node_frag_contrib,
    tree_sum,
)
from tpusim_torch.sim.engine import (
    EV_CREATE,
    EV_DELETE,
    EventMetrics,
    cluster_usage,
    power_rows,
)
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

# block of XLA's cumulative sum on the CPU
_SCAN_BLOCK = 16


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 scan along dim 0 in XLA's blocked order."""
    e = x.shape[0]
    b = _SCAN_BLOCK
    if e <= b:
        acc, out = x.new_zeros(x.shape[1:]), []
        for i in range(e):
            acc = acc + x[i]
            out.append(acc)
        return torch.stack(out) if out else x.clone()
    nb = -(-e // b)
    pad = x.new_zeros((nb * b - e,) + tuple(x.shape[1:]))
    xb = torch.cat([x, pad]).reshape((nb, b) + tuple(x.shape[1:]))
    acc, loc = xb.new_zeros((nb,) + tuple(x.shape[1:])), []
    for i in range(b):
        acc = acc + xb[:, i]
        loc.append(acc)
    loc = torch.stack(loc, 1)  # [nb, b, ...]
    inc = _scan(loc[:, -1])
    excl = torch.cat([inc.new_zeros((1,) + tuple(inc.shape[1:])), inc[:-1]])
    out = loc + excl[:, None]
    return out.reshape((nb * b,) + tuple(x.shape[1:]))[:e]


def xla_cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """float32 inclusive cumulative sum along `dim` in the order of the
    reference's CPU build (jnp.cumsum lowers to XLA's reduce_window, which
    the CPU compiler turns into a blocked scan): a sequential prefix inside
    each block of 16 (the last block zero-padded at the end), the block
    totals scanned the same way, recursively, and each block's exclusive
    prefix added to its elements. Every step is an elementwise add, on any
    device."""
    x = x.to(torch.float32).movedim(dim, 0)
    return _scan(x).movedim(0, dim)


def _segment_inclusive_cumsum(delta_s: torch.Tensor,
                              head: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumulative sum of `delta_s` along dim 0 restarting at
    every True of `head`."""
    csum = torch.cumsum(delta_s, 0)
    excl = csum - delta_s
    idx = torch.arange(head.shape[0], device=head.device)
    head_idx = torch.cummax(torch.where(head, idx, 0), 0).values
    return csum - excl[head_idx]


def _usage_contrib(cpu_left, gpu_left, cpu_cap, gpu_cnt):
    """One node's share of the [Alloc]/[AllocCPU] aggregates (the
    cluster_usage rule) for batched [E] states, int64."""
    fully_free = (gpu_left == MILLI).sum(-1)
    u = ((fully_free < gpu_cnt) | (cpu_left < cpu_cap)).long()
    return (u, u * gpu_cnt, u * (gpu_cnt * MILLI - gpu_left.sum(-1)),
            u * (cpu_cap - cpu_left))


def _rows_delta(new_s, init_rows, node_s, head, valid_s, order):
    """Per-event change of the touched node's row, in event order: the new
    row minus the node's previous one (its initial row at the head of its
    group), zero for events that touched no node."""
    prev_s = torch.cat([new_s.new_zeros((1, new_s.shape[1])), new_s[:-1]])
    old_s = torch.where(head[:, None], init_rows[node_s], prev_s)
    delta_s = torch.where(valid_s[:, None], new_s - old_s, 0.0)
    out = torch.zeros_like(delta_s)
    out[order] = delta_s
    return out


def compute_event_metrics(init_state: NodeState, specs: PodSpec, ev_kind,
                          ev_pod, event_node, event_dev,
                          tp: TypicalPods) -> EventMetrics:
    """EventMetrics of a replayed event stream, from its telemetry alone,
    on the telemetry's device."""
    dev = event_node.device
    ev_kind = torch.as_tensor(ev_kind, device=dev).long()
    ev_pod = torch.as_tensor(ev_pod, device=dev).long()
    n, e = init_state.num_nodes, ev_kind.shape[0]
    p_cpu = specs.cpu[ev_pod].long()
    p_milli = specs.gpu_milli[ev_pod].long()
    p_num = specs.gpu_num[ev_pod].long()

    valid = event_node >= 0
    # resources the event takes from its node (a release takes negatively)
    sign = torch.where(valid & (ev_kind == EV_CREATE), 1,
                       torch.where(valid & (ev_kind == EV_DELETE), -1, 0))
    taken_cpu = sign * p_cpu  # [E]
    taken_gpu = sign[:, None] * event_dev.long() * p_milli[:, None]

    # group the events by touched node, keeping their order inside a node
    key = torch.where(valid, event_node.long(), n)
    order = torch.sort(key, stable=True).indices
    key_s = key[order]
    head = torch.ones(e, dtype=torch.bool, device=dev)
    head[1:] = key_s[1:] != key_s[:-1]
    node_s = key_s.clamp(max=n - 1)  # untouched rows land in key n, masked
    valid_s = key_s < n

    # the touched node's state after each event (integers, exact)
    s = init_state
    tcpu_s, tgpu_s = taken_cpu[order], taken_gpu[order]
    post_cpu_s = s.cpu_left[node_s] - _segment_inclusive_cumsum(tcpu_s, head)
    post_gpu_s = s.gpu_left[node_s] - _segment_inclusive_cumsum(tgpu_s, head)
    pre_cpu_s = post_cpu_s + tcpu_s
    pre_gpu_s = post_gpu_s + tgpu_s
    cap_s, gcnt_s = s.cpu_cap[node_s].long(), s.gpu_cnt[node_s].long()
    gtyp_s, ctyp_s = s.gpu_type[node_s], s.cpu_type[node_s]
    post_cpu32, post_gpu32 = post_cpu_s.int(), post_gpu_s.int()

    # frag series: initial totals + the cumulative row changes (XLA folds
    # the sum over nodes of the per-node sums over typical pods into one
    # sum over both axes)
    init_contrib = node_frag_contrib(s.cpu_left, s.gpu_left, s.gpu_type, tp)
    init_rows = initial_rows(init_contrib)
    # (the per-event rows' sums over typical pods are fused into the loop
    # that computes the contributions, which XLA vectorises: `lanes`)
    new_rows = tree_sum(node_frag_contrib(post_cpu32, post_gpu32, gtyp_s,
                                          tp).movedim(1, 0), 1, lanes=True)
    frag_delta = _rows_delta(new_rows, init_rows, node_s, head, valid_s,
                             order)
    frag_amounts = (initial_total(init_contrib)[None, :]
                    + xla_cumsum(frag_delta))

    # power series: the same, on (cpu watts, gpu watts) per node
    init_pw = torch.stack(power_rows(s), -1)
    new_pw = torch.stack(node_power(post_cpu32, cap_s.int(), post_gpu32,
                                    gcnt_s.int(), gtyp_s, ctyp_s), -1)
    pw_delta = _rows_delta(new_pw, init_pw, node_s, head, valid_s, order)
    pw = tree_sum(init_pw, 1)[None, :] + xla_cumsum(pw_delta)

    # [Alloc]/[AllocCPU]: integer changes, exact
    post_c = _usage_contrib(post_cpu_s, post_gpu_s, cap_s, gcnt_s)
    pre_c = _usage_contrib(pre_cpu_s, pre_gpu_s, cap_s, gcnt_s)
    usage = []
    for init, po, pr in zip(cluster_usage(s), post_c, pre_c):
        d = torch.zeros(e, dtype=torch.long, device=dev)
        d[order] = torch.where(valid_s, po - pr, 0)
        usage.append((init.long() + torch.cumsum(d, 0)).int())

    # arrived counters count every create, failed ones too
    # (simulator.go:406-408)
    is_create = ev_kind == EV_CREATE
    arr_cpu = torch.cumsum(torch.where(is_create, p_cpu, 0), 0).int()
    arr_gpu = torch.cumsum(torch.where(is_create, p_milli * p_num, 0),
                           0).int()

    return EventMetrics(
        frag_amounts=frag_amounts,
        used_nodes=usage[0],
        used_gpus=usage[1],
        used_gpu_milli=usage[2],
        used_cpu_milli=usage[3],
        arrived_gpu_milli=arr_gpu,
        arrived_cpu_milli=arr_cpu,
        power_cpu=pw[:, 0],
        power_gpu=pw[:, 1],
    )


@dataclass
class DisruptionMetrics:
    """What a fault replay did to the workload (filled by
    Simulator.schedule_pods_with_faults, printed by
    reports.disruption_report_block). The clock is the event counter,
    positions in the trace, so every number is reproducible under a fixed
    fault seed."""

    node_failures: int = 0
    node_recoveries: int = 0
    evicted_pods: int = 0  # node-crash evictions + single-pod evictions
    retries_enqueued: int = 0
    rescheduled_pods: int = 0  # evicted pods that found a node again
    unscheduled_after_retries: int = 0  # out of retries: terminal
    # sum over failed nodes of gpu_count x events down: failed-node
    # GPU-hours with the event counter as the clock
    failed_node_gpu_events: int = 0
    # per rescheduled pod: placement position - eviction position
    reschedule_latency_events: List[int] = field(default_factory=list)
    # per recovery: the cluster frag (frag_sum_except_q3 of the amounts)
    # right after the node returned minus right before
    post_recovery_frag_delta: List[float] = field(default_factory=list)

    def mean_reschedule_latency(self) -> float:
        lat = self.reschedule_latency_events
        return float(sum(lat)) / len(lat) if lat else 0.0

    def as_dict(self) -> dict:
        """The scalar summary (the analysis stash's disruption_* keys)."""
        return {
            "node_failures": self.node_failures,
            "node_recoveries": self.node_recoveries,
            "evicted_pods": self.evicted_pods,
            "retries_enqueued": self.retries_enqueued,
            "rescheduled_pods": self.rescheduled_pods,
            "unscheduled_after_retries": self.unscheduled_after_retries,
            "failed_node_gpu_events": self.failed_node_gpu_events,
            "mean_reschedule_latency_events": self.mean_reschedule_latency(),
            "max_reschedule_latency_events": (
                max(self.reschedule_latency_events)
                if self.reschedule_latency_events else 0
            ),
            "post_recovery_frag_delta_sum": float(
                sum(self.post_recovery_frag_delta)
            ),
        }
