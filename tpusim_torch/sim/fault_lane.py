"""The in-scan fault lane (counterpart of tpusim/sim/fault_lane.py): a fault
schedule as operands of one replay.

The segmented host loop (Simulator._schedule_pods_with_faults_segmented)
replays the trace in pieces between host-applied fault transitions. The
lane runs the whole disruption trajectory in one replay instead:

  1. `compile_fault_plan` merges the schedule into the base event stream
     on the host: EV_NODE_FAIL / EV_NODE_RECOVER / EV_EVICT become steps at
     their trace positions, and blocks of EV_RETRY slots are inserted at
     every position a queued retry could become due (attempt k of an
     eviction at e fires at e + the sum of backoff(1..k), a function of
     the schedule alone; a slot with nothing due is an inert skip). After
     the trace, max_retries flush rounds pop what is left.

  2. `FaultCarry` holds the retry queue as int32 arrays with
     queues.RetryQueue's semantics: capped exponential backoff, FIFO ties
     ((ready, seq) order), and a dead list (attempts past max_retries, or
     a push past the queue's capacity: both terminal
     "max-retries-exceeded").

  3. Random eviction victims are the host loop's numpy PCG64 draw
     (faults.pick_eviction_victim): it depends on the count of placed pods
     at replay time, so each drawn EV_EVICT ships the draw for every
     possible count, and the replay reads draws[row, count].

The plan's arrays and the draw table are the operands of the replays'
fault forms: `replay_faults` and `replay_blocked_faults` and their lanes
forms (tpusim_torch.sim.fused_engine, hbm_engine; the CUDA kernels of
kernels/replay_faults.cu and replay_blocked_faults.cu), whose plain
versions run the step functions below, the plain PyTorch counterparts of
tpusim's. Under a deterministic configuration the lane equals the
segmented loop; a randomized one draws from one key chain over the merged
stream.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tpusim_torch.constants import MAX_GPUS_PER_NODE, MILLI
from tpusim_torch.sim.engine import (
    EV_CREATE,
    EV_EVICT,
    EV_NODE_FAIL,
    EV_NODE_RECOVER,
    EV_RETRY,
    EV_SKIP,
)

_INT_MAX = torch.iinfo(torch.int32).max
_VICTIM_MIX = 2654435761  # pick_eviction_victim's Knuth multiplier

# dctr layout (i32[7] disruption counters in the carry)
D_EVICTED = 0
D_RETRIES_ENQ = 1
D_RESCHEDULED = 2
D_FAILURES = 3
D_RECOVERIES = 4
D_FN_GPU_EVENTS = 5
D_DEAD = 6
NUM_DCTR = 7


class FaultOps(NamedTuple):
    """The fault operands of one lane, on the replay's device: pos, arg and
    aux ride the merged stream beside its kinds and pod indices."""

    pos: torch.Tensor  # i32[E_m] base-trace position of each merged step
    arg: torch.Tensor  # i32[E_m] node (fail/recover) | explicit pod (evict,
    #                    -1 = drawn) | flush round (retry slots)
    aux: torch.Tensor  # i32[E_m] eviction draw-table row (-1 otherwise)
    draws: torch.Tensor  # i32[n_rows (>= 1), P+1] pre-drawn victim ranks
    params: torch.Tensor  # i32[4]: backoff base, cap, max_retries, E
    gcnt: torch.Tensor  # i32[N] per-node GPU counts


class FaultPlan(NamedTuple):
    """The host compilation of one fault schedule (numpy arrays)."""

    kind: np.ndarray  # i32[E_m] merged stream kinds (0..6)
    idx: np.ndarray  # i32[E_m] base pod index (0 on non-base steps)
    pos: np.ndarray  # i32[E_m]
    arg: np.ndarray  # i32[E_m]
    aux: np.ndarray  # i32[E_m]
    draws: np.ndarray  # i32[n_rows, P+1]
    params: np.ndarray  # i32[4]
    capacity: int  # retry-queue capacity R
    num_events: int  # base trace length E
    has_recover: bool  # whether the recover frag capture is armed


class FaultCarry(NamedTuple):
    """The retry queue and the disruption bookkeeping (queues.RetryQueue's
    semantics) as int32 tensors. Free queue slots hold pod -1 and ready ==
    seq == INT_MAX, so the (ready, seq) pops never see them."""

    q_ready: torch.Tensor  # i32[R]
    q_seq: torch.Tensor  # i32[R]
    q_pod: torch.Tensor  # i32[R]
    q_att: torch.Tensor  # i32[R]
    q_era: torch.Tensor  # i32[R] flush round the entry was pushed in (0 =
    #                      during the trace); round r pops only era < r
    seq: torch.Tensor  # i32 next insertion sequence number
    attempts: torch.Tensor  # i32[P] consecutive failed attempts so far
    evicted_at: torch.Tensor  # i32[P] eviction position (-1 = not evicted)
    dead: torch.Tensor  # bool[P] terminal max-retries-exceeded
    down_at: torch.Tensor  # i32[N] failure position per node (-1 = up)
    dctr: torch.Tensor  # i32[NUM_DCTR] disruption counters


class FaultY(NamedTuple):
    """What each merged step reports: enough for the host to rebuild every
    DisruptionMetrics list, the [Fault] log lines, the creation ranks and
    the true event count. One entry a step ([E_m] tensors, or scalars from
    the step functions)."""

    rpod: torch.Tensor  # i32 popped retry pod (-1 = no pop this step)
    lat: torch.Tensor  # i32 reschedule latency on retry success (-1 else)
    vpod: torch.Tensor  # i32 EV_EVICT victim (-1 none)
    vnode: torch.Tensor  # i32 the evict victim's node (-1 none)
    nvict: torch.Tensor  # i32 pods evicted at this step (fail/evict)
    rec: torch.Tensor  # i32 1 = recover applied this step
    fb: torch.Tensor  # f32 cluster frag before a recover (frag flag only)
    fa: torch.Tensor  # f32 cluster frag after a recover


class FaultLane(NamedTuple):
    """A lane's fault operands for a replay's fault form: its FaultOps,
    its initial carry, and the recover steps of its stream (the snapshot
    slots of the recover frag capture)."""

    ops: FaultOps
    carry: FaultCarry
    n_recover: int


class FaultOut(NamedTuple):
    """A fault form's fault outputs: the final carry and the steps'
    FaultY ([E_m] tensors)."""

    carry: FaultCarry
    ys: FaultY


def _i32(value, device=None) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=device)


def no_fault_y(device=None) -> FaultY:
    z = _i32(-1, device)
    zero = _i32(0, device)
    f = torch.zeros((), dtype=torch.float32, device=device)
    return FaultY(z, z, z, z, zero, zero, f, f)


# ---------------------------------------------------------------------------
# Host-side plan compilation
# ---------------------------------------------------------------------------


def resolve_capacity(fcfg, num_pods: int) -> int:
    """The retry queue's capacity R: the explicit knob, else
    min(num_pods, 256), enough that the host RetryQueue (unbounded) and
    the lane's queue never diverge on realistic schedules; an eviction
    wave past it goes terminal."""
    cap = int(getattr(fcfg, "queue_capacity", 0) or 0)
    if cap > 0:
        return cap
    return max(1, min(int(num_pods), 256))


def _backoffs(fcfg) -> List[int]:
    return [
        min(fcfg.backoff_base * (1 << max(k - 1, 0)), fcfg.backoff_cap)
        for k in range(1, max(fcfg.max_retries, 0) + 1)
    ]


def _victim_draw_row(seed: int, pos: int, num_pods: int) -> np.ndarray:
    """draws[size] = the host loop's PCG64 pick for every possible
    placed-count `size` (pick_eviction_victim: a fresh generator per
    (seed, pos), first draw). Entry 0 is -1 (nothing placed). The
    generator is seeded once and its state restored before each draw:
    numpy then draws exactly what a fresh default_rng(base) draws, without
    paying the seeding a size."""
    row = np.full(num_pods + 1, -1, np.int32)
    base = np.uint64(seed) + np.uint64(pos) * np.uint64(_VICTIM_MIX)
    rng = np.random.default_rng(base)
    fresh = rng.bit_generator.state
    for s in range(1, num_pods + 1):
        rng.bit_generator.state = fresh
        row[s] = int(rng.integers(0, s))
    return row


def compile_fault_plan(
    ev_kind: np.ndarray,
    ev_pod: np.ndarray,
    faults: Sequence,
    fcfg,
    num_nodes: int,
    num_pods: int,
    capacity: int = 0,
) -> FaultPlan:
    """Merge a fault schedule into the base stream (module docstring).

    The merged order is the segmented host loop's: base events run to each
    boundary position, faults clamped to that position fire first (in
    schedule order), then one block of EV_RETRY slots pops the retries due
    there (FIFO (ready, seq) order); after the trace and the faults,
    max_retries flush rounds pop the queue whatever the backoff, each
    round seeing only the entries pushed before it (the host loop's
    thresh=inf drain)."""
    from tpusim_torch.sim.faults import validate_fault_schedule

    ev_kind = np.asarray(ev_kind, np.int32)
    ev_pod = np.asarray(ev_pod, np.int32)
    e = int(ev_kind.shape[0])
    faults = sorted(faults, key=lambda f: f.pos)  # stable like the host
    validate_fault_schedule(faults, num_nodes, num_pods)
    if fcfg.backoff_cap > (1 << 20):
        raise ValueError(
            f"backoff_cap {fcfg.backoff_cap} > 2^20: the in-scan backoff "
            "is computed in f32-exact integer range"
        )
    cap_r = capacity or resolve_capacity(fcfg, num_pods)
    bos = _backoffs(fcfg)

    # potential retry boundaries: attempt k of an eviction at e0 fires at
    # e0 + sum(backoff(1..k)); chains past the trace end land in the flush
    # rounds. Slots per position: 1 per reaching EVICT chain, capacity per
    # reaching FAIL chain (victim counts depend on the outcome), capped at
    # capacity (the most the queue holds).
    slot_need: dict = {}
    any_evict_src = False
    for f in faults:
        if f.kind not in (EV_NODE_FAIL, EV_EVICT):
            continue
        any_evict_src = True
        mult = cap_r if f.kind == EV_NODE_FAIL else 1
        t = min(f.pos, e)
        for b in bos:
            t = t + b
            if t >= e:
                break
            slot_need[t] = min(cap_r, slot_need.get(t, 0) + mult)

    boundaries = sorted(
        set(min(f.pos, e) for f in faults) | set(slot_need)
    )

    kinds: List[int] = []
    idxs: List[int] = []
    poss: List[int] = []
    args: List[int] = []
    auxs: List[int] = []
    draw_rows: List[np.ndarray] = []

    def emit(kind, idx=0, pos=0, arg=0, aux=-1):
        kinds.append(kind)
        idxs.append(idx)
        poss.append(pos)
        args.append(arg)
        auxs.append(aux)

    fi = 0
    cursor = 0
    for p in boundaries:
        p = min(p, e)
        # base events up to the boundary
        for i in range(cursor, p):
            emit(int(ev_kind[i]), int(ev_pod[i]), pos=i)
        cursor = max(cursor, p)
        # faults clamped to this boundary, in schedule order
        while fi < len(faults) and min(faults[fi].pos, e) <= p:
            f = faults[fi]
            fi += 1
            if f.kind == EV_EVICT:
                row = -1
                if f.pod < 0:
                    row = len(draw_rows)
                    draw_rows.append(
                        _victim_draw_row(fcfg.seed, p, num_pods)
                    )
                emit(EV_EVICT, pos=p, arg=int(f.pod), aux=row)
            else:
                emit(int(f.kind), pos=p, arg=int(f.node))
        # due-retry slots (normal mode: ready <= pos gate)
        for _ in range(slot_need.get(p, 0)):
            emit(EV_RETRY, pos=p, arg=0)
    # trace tail + faults clamped past the end
    for i in range(cursor, e):
        emit(int(ev_kind[i]), int(ev_pod[i]), pos=i)
    while fi < len(faults):
        f = faults[fi]
        fi += 1
        if f.kind == EV_EVICT:
            row = -1
            if f.pod < 0:
                row = len(draw_rows)
                draw_rows.append(_victim_draw_row(fcfg.seed, e, num_pods))
            emit(EV_EVICT, pos=e, arg=int(f.pod), aux=row)
        else:
            emit(int(f.kind), pos=e, arg=int(f.node))
    # flush rounds: pop everything queued before the round, whatever its
    # backoff (the host loop's end-of-trace thresh=inf drain)
    if any_evict_src:
        for r in range(1, max(fcfg.max_retries, 1) + 1):
            for _ in range(cap_r):
                emit(EV_RETRY, pos=e, arg=r)

    draws = (
        np.stack(draw_rows)
        if draw_rows else np.full((1, num_pods + 1), -1, np.int32)
    )
    has_rec = any(f.kind == EV_NODE_RECOVER for f in faults)
    return FaultPlan(
        kind=np.asarray(kinds, np.int32),
        idx=np.asarray(idxs, np.int32),
        pos=np.asarray(poss, np.int32),
        arg=np.asarray(args, np.int32),
        aux=np.asarray(auxs, np.int32),
        draws=draws.astype(np.int32),
        params=np.asarray(
            [fcfg.backoff_base, fcfg.backoff_cap, fcfg.max_retries, e],
            np.int32,
        ),
        capacity=cap_r,
        num_events=e,
        has_recover=has_rec,
    )


def pad_fault_plans(
    plans: Sequence[FaultPlan], bucket: int = 256, min_stream: int = 0,
    min_rows: int = 0,
) -> Tuple[np.ndarray, ...]:
    """Pad B per-lane plans to common shapes (tpusim's vmapped chaos sweep
    needs them): streams to a shared bucketed length (inert EV_SKIP
    steps), draw tables to a shared row count. Returns the stacked (kind,
    idx, pos, arg, aux, draws, params) arrays and the unified (capacity,
    has_recover). The capacities must already agree. The port's lanes
    each take their own plan; the chaos sweep keeps these shapes as its
    sticky floors and in its log line."""
    caps = {p.capacity for p in plans}
    if len(caps) != 1:
        raise ValueError(
            f"chaos-sweep lanes must share one queue capacity, got {caps}"
        )
    # power-of-two shape classes above the base bucket; min_stream /
    # min_rows are the caller's sticky high-water floors
    em = max(
        max(int(p.kind.shape[0]) for p in plans), int(min_stream)
    )
    em = bucket if em <= bucket else (1 << (em - 1).bit_length())
    rows = max(
        max(int(p.draws.shape[0]) for p in plans), int(min_rows)
    )
    # a 64-row floor keeps typical waves in one class
    rows = max(64, 1 << max(rows - 1, 0).bit_length())
    pp = max(int(p.draws.shape[1]) for p in plans)

    def pad_stream(a, fill):
        out = np.full(em, fill, np.int32)
        out[: a.shape[0]] = a
        return out

    kinds, idxs, poss, args, auxs, draws, params = [], [], [], [], [], [], []
    for p in plans:
        kinds.append(pad_stream(p.kind, EV_SKIP))
        idxs.append(pad_stream(p.idx, 0))
        poss.append(pad_stream(p.pos, p.num_events))
        args.append(pad_stream(p.arg, 0))
        auxs.append(pad_stream(p.aux, -1))
        d = np.full((rows, pp), -1, np.int32)
        d[: p.draws.shape[0], : p.draws.shape[1]] = p.draws
        draws.append(d)
        params.append(p.params)
    return (
        np.stack(kinds), np.stack(idxs), np.stack(poss), np.stack(args),
        np.stack(auxs), np.stack(draws), np.stack(params),
        plans[0].capacity, any(p.has_recover for p in plans),
    )


def plan_recovers(plan: FaultPlan) -> int:
    """The recover steps of a plan: the most recover frag snapshots its
    replay takes."""
    return int((plan.kind == EV_NODE_RECOVER).sum())


def fault_ops(plan: FaultPlan, gcnt: torch.Tensor) -> FaultOps:
    """A plan's FaultOps on the device of `gcnt` (the nodes' GPU counts,
    padded as the replay's state is)."""
    dev = gcnt.device
    return FaultOps(
        pos=_i32(plan.pos, dev), arg=_i32(plan.arg, dev),
        aux=_i32(plan.aux, dev), draws=_i32(plan.draws, dev),
        params=_i32(plan.params, dev), gcnt=gcnt.to(torch.int32),
    )


def lane_of(plan: FaultPlan, state, num_pods: int) -> FaultLane:
    """A plan's FaultLane over `state` (padded to whole blocks or not): its
    operands, a fresh carry and its recover snapshot slots, on the state's
    device."""
    return FaultLane(
        fault_ops(plan, state.gpu_cnt),
        init_fault_carry(num_pods, state.num_nodes, plan.capacity,
                         state.cpu_left.device),
        plan_recovers(plan))


# ---------------------------------------------------------------------------
# The carry and the queue
# ---------------------------------------------------------------------------


def init_fault_carry(num_pods: int, num_nodes: int, capacity: int,
                     device=None) -> FaultCarry:
    r = int(capacity)

    def full(n, value):
        return torch.full((n,), value, dtype=torch.int32, device=device)

    return FaultCarry(
        q_ready=full(r, _INT_MAX),
        q_seq=full(r, _INT_MAX),
        q_pod=full(r, -1),
        q_att=full(r, 0),
        q_era=full(r, 0),
        seq=_i32(0, device),
        attempts=full(num_pods, 0),
        evicted_at=full(num_pods, -1),
        dead=torch.zeros(num_pods, dtype=torch.bool, device=device),
        down_at=full(num_nodes, -1),
        dctr=full(NUM_DCTR, 0),
    )


def pad_fault_carry(fc0: FaultCarry) -> FaultCarry:
    """The carry with one more pod row (tpusim's engines keep P+1
    bookkeeping rows; the extra row is never evicted, so it is inert);
    trim_fault_carry is the inverse."""
    return fc0._replace(
        attempts=torch.nn.functional.pad(fc0.attempts, (0, 1)),
        evicted_at=torch.nn.functional.pad(fc0.evicted_at, (0, 1),
                                           value=-1),
        dead=torch.nn.functional.pad(fc0.dead, (0, 1)),
    )


def trim_fault_carry(fc: FaultCarry) -> FaultCarry:
    return fc._replace(
        attempts=fc.attempts[:-1],
        evicted_at=fc.evicted_at[:-1],
        dead=fc.dead[:-1],
    )


def backoff_of(att, base, cap):
    """min(base * 2^(att-1), cap), exact: the shift is clamped so that
    base << s stays in int32 (past the clamp the min is cap anyway, which
    compile_fault_plan bounds at 2^20)."""
    att, base, cap = _i32(att), _i32(base), _i32(cap)
    s = torch.clamp(att - 1, min=0)
    lb = torch.floor(
        torch.log2(torch.clamp(base, min=1).to(torch.float32))
    ).to(torch.int32)
    s = torch.minimum(s, torch.clamp(29 - lb, min=0))
    return torch.minimum(torch.bitwise_left_shift(base, s), cap)


def _set(a: torch.Tensor, i, value) -> torch.Tensor:
    """A copy of `a` with a[i] = value."""
    out = a.clone()
    out[i] = value
    return out


def pop_retry(fc: FaultCarry, is_slot, pos, flush_round):
    """One EV_RETRY slot's pop: the earliest (ready, seq) entry that is due
    (normal slots: ready <= pos) or from before the round (flush round r:
    era < r). Returns (fc', has, pod); inert when nothing qualifies."""
    pos, flush_round = _i32(pos), _i32(flush_round)
    eligible = (fc.q_pod >= 0) & torch.where(
        flush_round > 0, fc.q_era < flush_round, fc.q_ready <= pos
    )
    any_e = eligible.any()
    rmin = torch.where(eligible, fc.q_ready, _INT_MAX).min()
    cand = eligible & (fc.q_ready == rmin)
    slot = int(torch.argmin(torch.where(cand, fc.q_seq, _INT_MAX)))
    has = torch.as_tensor(is_slot, dtype=torch.bool) & any_e
    pod = torch.where(has, fc.q_pod[slot], 0).to(torch.int32)
    fc = fc._replace(
        q_pod=_set(fc.q_pod, slot, torch.where(has, -1, fc.q_pod[slot])),
        q_ready=_set(fc.q_ready, slot,
                     torch.where(has, _INT_MAX, fc.q_ready[slot])),
        q_seq=_set(fc.q_seq, slot,
                   torch.where(has, _INT_MAX, fc.q_seq[slot])),
    )
    return fc, has, pod


def _queue_push_mask(fc: FaultCarry, vm, att, pos, era, params):
    """Push every pod of mask `vm` (ascending pod order is FIFO seq order,
    the host's flatnonzero order) with attempt vector `att`. An entry with
    att > max_retries goes dead instead (RetryQueue.push -> None), and so
    does one past the queue's capacity. Returns (fc', pushed bool[P],
    dead_now bool[P])."""
    r = fc.q_pod.shape[0]
    base, cap, maxr = params[0], params[1], params[2]
    dead_now = vm & (att > maxr)
    want = vm & ~dead_now
    rank = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32) - 1
    free = fc.q_pod < 0
    nfree = free.sum().to(torch.int32)
    free_order = torch.argsort((~free).to(torch.int8), stable=True)
    fits = want & (rank < nfree)
    pods = torch.nonzero(fits)[:, 0]
    tgt = free_order[torch.clamp(rank[pods], 0, r - 1).long()]
    ready = _i32(pos) + backoff_of(att, base, cap)
    fc = fc._replace(
        q_pod=_set(fc.q_pod, tgt, pods.to(torch.int32)),
        q_att=_set(fc.q_att, tgt, att[pods]),
        q_ready=_set(fc.q_ready, tgt, ready[pods]),
        q_seq=_set(fc.q_seq, tgt, fc.seq + rank[pods]),
        q_era=_set(fc.q_era, tgt,
                   _i32(era, fc.q_era.device).expand(pods.shape[0])),
        seq=(fc.seq + fits.sum()).to(torch.int32),
    )
    return fc, fits, dead_now | (want & ~fits)


def _evict_into_queue(fc: FaultCarry, vm, pos, era, params):
    """The eviction bookkeeping of a victim mask: attempts += 1, the
    eviction position stamped, push or dead, the disruption counters.
    Returns (fc', newly_dead bool[P])."""
    att = torch.where(vm, fc.attempts + 1, 0).to(torch.int32)
    fc, pushed, dead_now = _queue_push_mask(fc, vm, att, pos, era, params)
    nd = vm & dead_now
    dctr = fc.dctr.clone()
    dctr[D_EVICTED] += vm.sum().to(torch.int32)
    dctr[D_RETRIES_ENQ] += pushed.sum().to(torch.int32)
    dctr[D_DEAD] += nd.sum().to(torch.int32)
    fc = fc._replace(
        attempts=torch.where(vm, att, fc.attempts),
        evicted_at=torch.where(vm, _i32(pos), fc.evicted_at),
        dead=fc.dead | nd,
        dctr=dctr,
    )
    return fc, nd


# ---------------------------------------------------------------------------
# One fault step
# ---------------------------------------------------------------------------


def frag_scalars(cpu_left, gpu_left, gpu_type, tp, b: int) -> torch.Tensor:
    """The cluster frag (frag_sum_except_q3 of the cluster's frag amounts)
    of b states stacked along the node axis ([b * N] rows), f32[b], on
    their device: the amounts are summed in the order of
    ops.frag.cluster_frag_report for every state at once."""
    from tpusim_torch.ops.frag import (
        frag_sum_except_q3,
        node_frag_contrib,
        tree_sum,
    )

    contrib = node_frag_contrib(cpu_left, gpu_left, gpu_type, tp)
    n = contrib.shape[0] // b
    contrib = contrib.view(b, n, *contrib.shape[1:]).permute(1, 2, 0, 3)
    return frag_sum_except_q3(tree_sum(contrib, 2))


def _frag_scalar(state, tp) -> torch.Tensor:
    return frag_scalars(state.cpu_left, state.gpu_left, state.gpu_type,
                        tp, 1)[0]


def recover_frags(snaps, nodes, state, tp):
    """(fb, fa) f32[S] of S recover snapshots: snaps (cpu_left [S, N],
    gpu_left [S, N, 8]) is the cluster right before each recover of node
    nodes[s]; the frag after it is that of the same snapshot with the node
    reset to its capacity (the reset leaves cpu and devices idle, as the
    failure had). `state` gives the capacities and GPU types."""
    cpu, gpu = snaps
    s, n = cpu.shape
    dev = cpu.device
    nodes = nodes.long()
    full = ((torch.arange(MAX_GPUS_PER_NODE, device=dev)[None, :]
             < state.gpu_cnt[nodes][:, None]).to(torch.int32) * MILLI)
    cpu_a, gpu_a = cpu.clone(), gpu.clone()
    rows = torch.arange(s, device=dev)
    cpu_a[rows, nodes] = state.cpu_cap[nodes]
    gpu_a[rows, nodes] = full
    both = frag_scalars(
        torch.cat([cpu, cpu_a]).reshape(-1),
        torch.cat([gpu, gpu_a]).reshape(-1, MAX_GPUS_PER_NODE),
        state.gpu_type.repeat(2 * s), tp, 2 * s)
    return both[:s], both[s:]


def _affinity_class(milli, num):
    """share-GPU pod -> 0, N whole GPUs -> N, no GPU -> -1 (pod.go:111-123)."""
    share = (num == 1) & (milli < MILLI)
    return torch.where(num == 0, -1, torch.where(share, 0, num))


def _fault_decisions(placed, fc: FaultCarry, kind, arg, aux, ops: FaultOps):
    """The decision half of one fault step: which transition fires and on
    what, (do_fail, do_rec, do_evict, node, victim, vnode). Reads only the
    committed bookkeeping."""
    kind, arg, aux = _i32(kind), _i32(arg), _i32(aux)
    is_fail = kind == EV_NODE_FAIL
    is_rec = kind == EV_NODE_RECOVER
    is_evict = kind == EV_EVICT
    node = torch.clamp(arg, 0, fc.down_at.shape[0] - 1)
    node_down = fc.down_at[node] >= 0
    do_fail = is_fail & ~node_down
    do_rec = is_rec & node_down

    # EV_EVICT's victim (pick_eviction_victim: the PCG64 draw per placed
    # count is tabulated in ops.draws)
    placed_ok = placed >= 0
    size = placed_ok.sum().to(torch.int32)
    row = torch.clamp(aux, 0, ops.draws.shape[0] - 1)
    j = ops.draws[row, torch.clamp(size, 0, ops.draws.shape[1] - 1)]
    ranks = torch.cumsum(placed_ok.to(torch.int32), 0, dtype=torch.int32) - 1
    vsel = placed_ok & (ranks == j)
    drawn = torch.argmax(vsel.to(torch.int32)).to(torch.int32)
    use_explicit = is_evict & (arg >= 0)
    exp_c = torch.clamp(arg, 0, placed.shape[0] - 1)
    victim = torch.where(use_explicit, exp_c, drawn)
    found = torch.where(use_explicit, placed_ok[exp_c], (aux >= 0) & (j >= 0))
    do_evict = is_evict & found
    vnode = torch.where(do_evict, placed[victim], -1).to(torch.int32)
    return do_fail, do_rec, do_evict, node, victim, vnode


def _fault_bookkeep(fc: FaultCarry, placed, node, victim, do_fail, do_rec,
                    do_evict, pos, ops: FaultOps):
    """The FaultCarry half of one fault step (the victims' requeue, the down
    clock, the counters). `placed` is the bookkeeping before the step.
    Returns (fc', vm victim mask, newly_dead mask)."""
    pos = _i32(pos)
    # a failure evicts every pod on its node, an eviction one pod; both
    # requeue in ascending pod order
    vm = (do_fail & (placed == node)) | (
        do_evict & (torch.arange(placed.shape[0], device=placed.device)
                    == victim)
    )
    fc, newly_dead = _evict_into_queue(fc, vm, pos, 0, ops.params)

    # down clock and recover accounting
    dctr = fc.dctr.clone()
    dctr[D_FAILURES] += do_fail.to(torch.int32)
    dctr[D_RECOVERIES] += do_rec.to(torch.int32)
    dctr[D_FN_GPU_EVENTS] += torch.where(
        do_rec, ops.gcnt[node] * (pos - fc.down_at[node]), 0
    ).to(torch.int32)
    fc = fc._replace(
        down_at=_set(fc.down_at, node, torch.where(
            do_fail, pos, torch.where(do_rec, -1, fc.down_at[node]))),
        dctr=dctr,
    )
    return fc, vm, newly_dead


def apply_fault_step(state, placed, masks, failed, fc: FaultCarry, specs,
                     kind, arg, aux, pos, ops: FaultOps, tp, node_ids,
                     frag_delta: bool):
    """Apply one EV_NODE_FAIL / EV_NODE_RECOVER / EV_EVICT step as masked
    whole-array updates (at most one kind fires; any other step is an exact
    no-op). Returns (state, placed, masks, failed, fc, the touched node
    (-1 none), FaultY without the retry fields)."""
    do_fail, do_rec, do_evict, node, victim, vnode = _fault_decisions(
        placed, fc, kind, arg, aux, ops
    )
    zero = torch.zeros((), dtype=torch.float32, device=placed.device)
    fb = _frag_scalar(state, tp) if frag_delta and bool(do_rec) else zero

    # node row reset (fail -> the down marker, recover -> empty)
    do_reset = do_fail | do_rec
    rowm = (node_ids == node) & do_reset
    gpu_full = (
        torch.arange(MAX_GPUS_PER_NODE, dtype=torch.int32,
                     device=placed.device)[None, :]
        < state.gpu_cnt[:, None]
    ).to(torch.int32) * MILLI
    new_mem = torch.where(do_fail, torch.full_like(state.mem_cap, -1),
                          state.mem_cap)
    state = state._replace(
        cpu_left=torch.where(rowm, state.cpu_cap, state.cpu_left),
        mem_left=torch.where(rowm, new_mem, state.mem_left),
        gpu_left=torch.where(rowm[:, None], gpu_full, state.gpu_left),
        aff_cnt=torch.where(rowm[:, None], 0, state.aff_cnt),
    )

    # EV_EVICT's resources return to the victim's node (deschedule.evict)
    vcpu, vmem = specs.cpu[victim], specs.mem[victim]
    vmilli, vnum = specs.gpu_milli[victim], specs.gpu_num[victim]
    cls = _affinity_class(vmilli, vnum)
    vrow = (node_ids == vnode) & do_evict
    colm = (
        torch.arange(state.aff_cnt.shape[1], dtype=torch.int32,
                     device=placed.device) == torch.clamp(cls, min=0)
    ) & (cls >= 0)
    state = state._replace(
        cpu_left=state.cpu_left + torch.where(vrow, vcpu, 0),
        mem_left=state.mem_left + torch.where(vrow, vmem, 0),
        gpu_left=state.gpu_left + torch.where(
            vrow[:, None], masks[victim].to(torch.int32) * vmilli, 0),
        aff_cnt=state.aff_cnt - torch.where(
            vrow[:, None] & colm[None, :], 1, 0),
    )
    state = state._replace(**{f: getattr(state, f).to(torch.int32) for f in
                              ("cpu_left", "mem_left", "gpu_left",
                               "aff_cnt")})
    fa = _frag_scalar(state, tp) if frag_delta and bool(do_rec) else zero

    fc, vm, newly_dead = _fault_bookkeep(
        fc, placed, node, victim, do_fail, do_rec, do_evict, pos, ops
    )
    placed = torch.where(vm, -1, placed).to(torch.int32)
    masks = torch.where(vm[:, None], False, masks)
    # a pod out of retries at its eviction is ever-failed (the host's
    # evict_bookkeep; a failed retry marks it through the create)
    failed = failed | newly_dead

    touched = torch.where(
        do_reset, node, torch.where(do_evict, vnode, -1)
    ).to(torch.int32)
    y = FaultY(
        rpod=_i32(-1, placed.device),
        lat=_i32(-1, placed.device),
        vpod=torch.where(do_evict, victim, -1).to(torch.int32),
        vnode=torch.where(do_evict, vnode, -1).to(torch.int32),
        nvict=vm.sum().to(torch.int32),
        rec=do_rec.to(torch.int32),
        fb=fb,
        fa=fa,
    )
    return state, placed, masks, failed, fc, touched, y


def commit_retry(fc: FaultCarry, has, pod, node, pos, era, params):
    """The bookkeeping of one popped retry after its create: success resets
    the run of failed attempts and records the reschedule latency; failure
    burns an attempt and re-enqueues (or goes dead). Returns (fc', lat —
    the latency on success, -1 otherwise, dead mask)."""
    has, pod, node, pos = (torch.as_tensor(has, dtype=torch.bool),
                           _i32(pod), _i32(node), _i32(pos))
    success = has & (node >= 0)
    failn = has & (node < 0)
    p = fc.attempts.shape[0]
    v = torch.clamp(pod, 0, p - 1)
    lat = torch.where(success, pos - fc.evicted_at[v], -1).to(torch.int32)
    att_v = fc.attempts[v] + 1
    iota = torch.arange(p, device=fc.attempts.device)
    vm = failn & (iota == v)
    att_vec = torch.where(vm, att_v, 0).to(torch.int32)
    fc, pushed, dead_now = _queue_push_mask(fc, vm, att_vec, pos, era,
                                            params)
    nd = vm & dead_now
    dctr = fc.dctr.clone()
    dctr[D_RESCHEDULED] += success.to(torch.int32)
    dctr[D_RETRIES_ENQ] += pushed.sum().to(torch.int32)
    dctr[D_DEAD] += nd.sum().to(torch.int32)
    fc = fc._replace(
        attempts=torch.where(
            vm, att_v, torch.where(success & (iota == v), 0, fc.attempts),
        ).to(torch.int32),
        evicted_at=torch.where(success & (iota == v), -1, fc.evicted_at),
        dead=fc.dead | nd,
        dctr=dctr,
    )
    return fc, lat, nd


# ---------------------------------------------------------------------------
# Host-side result assembly
# ---------------------------------------------------------------------------


def assemble_disruption(plan: FaultPlan, ys: FaultY, final_fc,
                        gpu_cnt: np.ndarray, frag_delta: bool = True):
    """(DisruptionMetrics, dead_pods bool[P], retry attempts run) from the
    replay's fault outputs on the host: the numbers the segmented host
    loop accumulates, including the dark-capacity clock of the nodes still
    down when the trace ends."""
    from tpusim_torch.sim.metrics import DisruptionMetrics

    dctr = np.asarray(final_fc.dctr, np.int64)
    dm = DisruptionMetrics(
        node_failures=int(dctr[D_FAILURES]),
        node_recoveries=int(dctr[D_RECOVERIES]),
        evicted_pods=int(dctr[D_EVICTED]),
        retries_enqueued=int(dctr[D_RETRIES_ENQ]),
        rescheduled_pods=int(dctr[D_RESCHEDULED]),
        unscheduled_after_retries=int(dctr[D_DEAD]),
        failed_node_gpu_events=int(dctr[D_FN_GPU_EVENTS]),
    )
    down = np.asarray(final_fc.down_at, np.int64)
    gpu_cnt = np.asarray(gpu_cnt, np.int64)
    n = min(down.shape[0], gpu_cnt.shape[0])
    down = down[:n]
    still = down >= 0
    dm.failed_node_gpu_events += int(
        (gpu_cnt[:n][still]
         * np.maximum(plan.num_events - down[still], 0)).sum()
    )
    lat = np.asarray(ys.lat, np.int64)
    dm.reschedule_latency_events = [int(x) for x in lat[lat >= 0]]
    if frag_delta:
        rec = np.asarray(ys.rec) > 0
        fb = np.asarray(ys.fb, np.float64)
        fa = np.asarray(ys.fa, np.float64)
        dm.post_recovery_frag_delta = [
            float(fa[i]) - float(fb[i]) for i in np.flatnonzero(rec)
        ]
    else:
        dm.post_recovery_frag_delta = []
    dead = np.asarray(final_fc.dead, bool)
    attempts_run = int((np.asarray(ys.rpod) >= 0).sum())
    return dm, dead, attempts_run


def fault_creation_rank(plan: FaultPlan, ys: FaultY,
                        num_pods: int) -> np.ndarray:
    """Per-pod creation rank over the merged stream: base creations and the
    retry attempts that ran rank in replay order, a later attempt
    overwriting (the segmented loop's rank bookkeeping)."""
    kind = plan.kind
    rpod = np.asarray(ys.rpod)[: kind.shape[0]]
    cand = np.where(
        kind == EV_CREATE, plan.idx,
        np.where((kind == EV_RETRY) & (rpod >= 0), rpod, -1),
    )
    rank = np.full(num_pods, -1, np.int64)
    hits = np.flatnonzero(cand >= 0)
    for r, i in enumerate(hits):
        rank[cand[i]] = r
    return rank
