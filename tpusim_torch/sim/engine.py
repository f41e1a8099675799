"""Replay result, event kinds, the per-event report rows and the sequential
oracle (counterpart of tpusim/sim/engine.py).

`make_replay` builds the sequential engine: a host loop over the events
that runs each cycle through tpusim_torch.sim.step (schedule_one on a
create, unschedule on a delete) on tensors on the replay's device,
recomputing every score from the state with no tables. It is the engine
`SimulatorConfig(engine="sequential")` runs, and the independent check of
the replay kernels. Event kinds, pods and the key chain stay on the host,
so no branch reads the card; only a retry slot of the fault form reads
whether it popped a pod.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpusim_torch.constants import MAX_GPUS_PER_NODE, MILLI
from tpusim_torch.ops.energy import node_power
from tpusim_torch.ops.prng import split
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
    # int32[6] the obs counters after the replay (obs.counters), where the
    # replay counted them
    counters: object = None
    # obs.decisions.DecisionRecord stacked over the events (the policies
    # in the configuration's order as given), where decisions were
    # recorded
    decisions: object = None
    # obs.series.SeriesSample stacked over the real samples, where the
    # series was recorded
    series: object = None


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


def metrics_row(state: NodeState, tp, arr_cpu: int, arr_gpu: int):
    """The EventMetrics row of a state (analysis.go:59-126), on the state's
    device, as tpusim's sequential engine computes it in its scan: the
    cluster's frag amounts and watts in the reference's summation order
    (ops.frag.initial_total, tree_sum), the usage aggregates, and the
    arrived counters (host ints)."""
    from tpusim_torch.ops.frag import initial_total, node_frag_contrib, tree_sum

    amounts = initial_total(node_frag_contrib(
        state.cpu_left, state.gpu_left, state.gpu_type, tp))
    pc, pg = power_rows(state)
    return (amounts, *cluster_usage(state), arr_gpu, arr_cpu,
            tree_sum(pc, 1), tree_sum(pg, 1))


def _i32(values, device) -> torch.Tensor:
    """Host ints as an int32 tensor, wrapped modulo 2^32 as XLA's int32."""
    return torch.tensor([((v + 2**31) % 2**32) - 2**31 for v in values],
                        dtype=torch.int32, device=device)


def make_replay(policies, gpu_sel: str = "best", report: bool = True,
                decisions: bool = False, series_every: int = 0,
                faults: bool = False, fault_frag: bool = False):
    """The sequential oracle for a policy configuration (tpusim's
    make_replay): `policies` are (tpusim_torch.policies.Policy, weight)
    pairs, `gpu_sel` the gpuSelMethod. Returns

        replay(state, pods, ev_kind, ev_pod, tp, key, tiebreak_rank=None,
               weights=None, fault_ops=None, fault_carry0=None)

    on tensors of one device (the replay's), with `key` the root of the
    event key chain (two ints, ops.prng.prng_key) and `weights` an optional
    weight row in the policies' order (step.resolve_weights). It returns a
    ReplayResult; with report=True its metrics are the per-event rows of
    the state after each event, computed in the loop (metrics_row). Each
    event splits the chain once; a create splits its key again into
    k_rand and k_sel (step.schedule_one).

    With faults=True the replay is the fault form (tpusim's
    _make_sequential_fault_engine): the events are a merged stream of
    fault_lane.compile_fault_plan, `fault_ops` and `fault_carry0` its
    FaultOps and initial FaultCarry; a retry slot pops the retry queue and
    creates the popped pod, its rejection ORed into its ever-failed flag,
    or skips; a node failure, recovery or eviction applies after the
    step's own (skip) outcome, and the touched node is its event node;
    `fault_frag` captures the recovers' frag. It runs metric-free and
    returns (ReplayResult, fault_lane.FaultOut).

    decisions=True records each event's DecisionRecord
    (step.schedule_one_recorded; non-creates obs.decisions.no_decision),
    series_every > 0 a SeriesSample wherever the processed count before
    the event sits on the stride (the committed state and the event's
    unpinned Filter row and raw scores, RandomScore's zero), and
    heartbeat_every > 0 a heartbeat tick after each stride crossing: the
    result's `decisions` and `series`; its `counters` always. The fault
    form records nothing, as tpusim's."""
    if faults and (decisions or series_every):
        raise ValueError(
            "the in-scan fault plane (faults=True) does not combine with "
            "decisions/series builds; run those through the segmented "
            "fault path (Simulator fault_mode='segments')")
    if series_every < 0:
        raise ValueError(f"series_every must be >= 0 (got {series_every})")
    if faults and report:
        raise ValueError(
            "fault-plane replays run metric-free (the merged stream "
            "interleaves fault transitions the report postpass does not "
            "model); reconstruct reports via the segmented path")
    policies = [(pol, int(w)) for pol, w in policies]

    def replay(state, pods, ev_kind, ev_pod, tp, key, tiebreak_rank=None,
               weights=None, fault_ops=None, fault_carry0=None,
               heartbeat_every=0):
        if faults:
            return _fault_loop(policies, gpu_sel, fault_frag, state, pods,
                               ev_kind, ev_pod, tp, key, tiebreak_rank,
                               weights, fault_ops, fault_carry0)
        return _event_loop(policies, gpu_sel, report, state, pods, ev_kind,
                           ev_pod, tp, key, tiebreak_rank, weights,
                           decisions, int(series_every), heartbeat_every)

    return replay


def _host_list(x):
    return [int(v) for v in (x.tolist() if hasattr(x, "tolist") else x)]


def _setup(state, pods, ev_kind, ev_pod, key, tiebreak_rank, policies,
           weights):
    """What both loops share: the device, host copies of the stream and
    the pods, the root key, the rank and the weights."""
    from tpusim_torch.sim.step import host_pods, resolve_weights

    dev = state.cpu_left.device
    if tiebreak_rank is None:
        tiebreak_rank = torch.arange(state.num_nodes, dtype=torch.int32,
                                     device=dev)
    return (dev, _host_list(ev_kind), _host_list(ev_pod), host_pods(pods),
            tuple(int(w) & 0xFFFFFFFF for w in _host_list(key)),
            tiebreak_rank, resolve_weights(policies, weights))


def _oracle_sample(policies, state, pod, tp, processed: int):
    """The oracle's series sample before an event (tpusim's sequential
    engine): the pod's unpinned Filter row, and every policy's raw row as
    the table build computes it (all nodes in the context's feasible
    mask, key (0, 0)); RandomScore's row is zeros."""
    from tpusim_torch.obs.series import build_sample
    from tpusim_torch.policies import ScoreContext
    from tpusim_torch.sim.step import filter_nodes

    n, dev = state.num_nodes, state.cpu_left.device
    feas = filter_nodes(state, pod._replace(pinned=-1))
    ctx = ScoreContext(tp=tp, feasible=torch.ones(n, dtype=torch.bool,
                                                  device=dev), rng=(0, 0))
    raws = torch.stack([
        torch.zeros(n, dtype=torch.int32, device=dev) if pol.per_event
        else pol.scorer(state, pod, ctx).raw_scores
        for pol, _ in policies])
    return build_sample(state, tp, raws, feas, [p for p, _ in policies],
                        processed)


def _stack(records, cls):
    """A list of records of `cls` (tensors) stacked field by field."""
    return cls(*(torch.stack(list(col)) for col in zip(*records))) \
        if records else None


def _event_loop(policies, gpu_sel, report, state, pods, ev_kind, ev_pod, tp,
                key, tiebreak_rank, weights, decisions=False, series_every=0,
                heartbeat_every=0) -> ReplayResult:
    from tpusim_torch.obs import heartbeat
    from tpusim_torch.obs.counters import counters_from_events
    from tpusim_torch.obs.decisions import DecisionRecord, no_decision
    from tpusim_torch.obs.series import SeriesSample
    from tpusim_torch.sim.step import (
        Placement,
        schedule_one,
        schedule_one_recorded,
        unschedule,
    )

    dev, kinds, idxs, hp, key, rank, wts = _setup(
        state, pods, ev_kind, ev_pod, key, tiebreak_rank, policies, weights)
    p, e = len(hp), len(kinds)
    placed = torch.full((p,), -1, dtype=torch.int32, device=dev)
    masks = torch.zeros((p, MAX_GPUS_PER_NODE), dtype=torch.bool, device=dev)
    failed = torch.zeros(p, dtype=torch.bool, device=dev)
    event_node = torch.full((e,), -1, dtype=torch.int32, device=dev)
    event_dev = torch.zeros((e, MAX_GPUS_PER_NODE), dtype=torch.bool,
                            device=dev)
    arr_cpu = arr_gpu = 0
    rows, decs, sers = [], [], []
    for i in range(e):
        kind, idx = min(max(kinds[i], 0), EV_SKIP), idxs[i]
        key, sub = split(key)
        pod = hp[idx]
        # every event is a create, delete or skip: i events processed
        if series_every and i % series_every == 0:
            sers.append(_oracle_sample(policies, state, pod, tp, i))
        if decisions and kind != EV_CREATE:
            decs.append(no_decision(len(policies), dev))
        if kind == EV_CREATE:
            if decisions:
                state, pl, dec = schedule_one_recorded(
                    state, pod, sub, policies, gpu_sel, tp, rank, wts)
                decs.append(dec)
            else:
                state, pl = schedule_one(state, pod, sub, policies, gpu_sel,
                                         tp, rank, wts)
            placed[idx] = pl.node
            masks[idx] = pl.dev_mask
            failed[idx] = pl.node < 0
            event_node[i] = pl.node
            event_dev[i] = pl.dev_mask
            # arrived counters accumulate per creation event whatever its
            # outcome (simulator.go:406-408)
            arr_cpu += pod.cpu
            arr_gpu += pod.gpu_milli * pod.gpu_num
        elif kind == EV_DELETE:
            event_node[i] = placed[idx]
            event_dev[i] = masks[idx]
            state = unschedule(state, pod, Placement(event_node[i],
                                                     event_dev[i]))
            placed[idx] = -1
            masks[idx] = False
        if heartbeat.due(i + 1, heartbeat_every):
            heartbeat.tick(i + 1)
        if report:
            rows.append(metrics_row(state, tp, arr_cpu, arr_gpu))
    metrics = None
    if report:
        cols = list(zip(*rows)) if rows else [[]] * len(EventMetrics._fields)
        metrics = EventMetrics(*(
            _i32(c, dev) if j in (5, 6) else
            (torch.stack(c) if c else torch.zeros(
                (0, 7) if j == 0 else (0,), device=dev,
                dtype=torch.float32 if j in (0, 7, 8) else torch.int32))
            for j, c in enumerate(cols)))
    return ReplayResult(
        state, placed, masks, failed, metrics, event_node, event_dev,
        counters_from_events(torch.tensor(kinds, dtype=torch.int32,
                                          device=dev), event_node),
        _stack(decs, DecisionRecord) if decisions else None,
        _stack(sers, SeriesSample) if series_every else None)


def _fault_loop(policies, gpu_sel, fault_frag, state, pods, ev_kind, ev_pod,
                tp, key, tiebreak_rank, weights, ops, fc):
    from tpusim_torch.sim import fault_lane as fl
    from tpusim_torch.sim.step import Placement, schedule_one, unschedule

    dev, kinds, idxs, hp, key, rank, wts = _setup(
        state, pods, ev_kind, ev_pod, key, tiebreak_rank, policies, weights)
    p, e = len(hp), len(kinds)
    pos, arg, aux = (_host_list(x) for x in (ops.pos, ops.arg, ops.aux))
    node_ids = torch.arange(state.num_nodes, dtype=torch.int32, device=dev)
    placed = torch.full((p,), -1, dtype=torch.int32, device=dev)
    masks = torch.zeros((p, MAX_GPUS_PER_NODE), dtype=torch.bool, device=dev)
    failed = torch.zeros(p, dtype=torch.bool, device=dev)
    none = torch.tensor(-1, dtype=torch.int32, device=dev)
    no_dev = torch.zeros(MAX_GPUS_PER_NODE, dtype=torch.bool, device=dev)
    inert = fl.no_fault_y(dev)
    nodes, devs, ys = [], [], []
    for i in range(e):
        kind, idx = kinds[i], idxs[i]
        rpod = -1
        if kind == EV_RETRY:
            fc, has, popped = fl.pop_retry(fc, True, pos[i], arg[i])
            # the one read of the card a step may make: whether the slot
            # popped a pod, and which
            if bool(has):
                rpod = int(popped)
        eff = rpod if rpod >= 0 else idx
        kc = ((EV_CREATE if rpod >= 0 else EV_SKIP) if kind == EV_RETRY
              else min(max(kind, 0), EV_SKIP))
        pod = hp[eff]
        key, sub = split(key)
        node, dmask = none, no_dev
        if kc == EV_CREATE:
            state, pl = schedule_one(state, pod, sub, policies, gpu_sel, tp,
                                     rank, wts)
            newf = pl.node < 0
            placed[eff] = pl.node
            masks[eff] = pl.dev_mask
            # a retry ORs its rejection into the pod's ever-failed flag; a
            # base create (once a pod) sets it
            failed[eff] = failed[eff] | newf if kind == EV_RETRY else newf
            node, dmask = pl.node, pl.dev_mask
        elif kc == EV_DELETE:
            node, dmask = placed[eff].clone(), masks[eff].clone()
            state = unschedule(state, pod, Placement(node, dmask))
            placed[eff] = -1
            masks[eff] = False
        y = inert
        if kind in (EV_NODE_FAIL, EV_NODE_RECOVER, EV_EVICT):
            state, placed, masks, failed, fc, touched, y = \
                fl.apply_fault_step(state, placed, masks, failed, fc, pods,
                                    kind, arg[i], aux[i], pos[i], ops, tp,
                                    node_ids, fault_frag)
            node = torch.where(touched >= 0, touched, node)
        if rpod >= 0:
            fc, lat, _ = fl.commit_retry(fc, True, rpod, node, pos[i],
                                         arg[i], ops.params)
            y = y._replace(rpod=torch.full_like(none, rpod), lat=lat)
        nodes.append(node)
        devs.append(dmask)
        ys.append(y)
    stacked = fl.FaultY(*(
        torch.stack(c) if c else torch.zeros(
            0, device=dev, dtype=torch.float32 if f in ("fb", "fa")
            else torch.int32)
        for f, c in zip(fl.FaultY._fields, zip(*ys) if ys else
                        [[]] * len(fl.FaultY._fields))))
    event_node = (torch.stack(nodes).to(torch.int32) if nodes else
                  torch.zeros(0, dtype=torch.int32, device=dev))
    event_dev = (torch.stack(devs) if devs else
                 torch.zeros((0, MAX_GPUS_PER_NODE), dtype=torch.bool,
                             device=dev))
    return (ReplayResult(state, placed, masks, failed, None, event_node,
                         event_dev),
            fl.FaultOut(fc, stacked))
