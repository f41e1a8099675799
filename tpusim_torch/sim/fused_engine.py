"""Fused whole-replay engine (counterpart of tpusim/sim/pallas_engine.py's
VMEM-resident kernel, `make_pallas_replay(residency="vmem")`).

The replay keeps int32 tables over the K distinct pod types and the N
nodes: each table policy's raw score ([num_tables * K, N], policy-major),
the selector policy's share-device pick and the Filter bit ([K, N] each). One
event mutates one node, so each event first refreshes the column of the
node the previous event touched, then runs

    Filter (table row & pin mask)
    -> Score (per policy: its row, min-max or PWR normalised over the
       feasible nodes where the policy asks for it; the i32 weighted sum)
    -> selectHost (max total, then min tie-break rank, then min node id)
    -> Reserve (share-GPU pods: best fit, worst fit, or the selector
       policy's own pick; two-pointer for whole GPUs) -> Bind

or, on a delete, returns the pod's resources to the devices it held.

A randomized configuration (RandomScore, or gpu_sel random) draws per
event from JAX's event key chain (tpusim_torch.ops.prng.event_keys, from
the replay's root key): RandomScore's row is the event's draw over the
feasible nodes (policies/random_policy.py) and has no table row, and the
share-GPU device is drawn from k_sel (ops.resource.allocate_share_random).

Two implementations of the same function live here. On CUDA tensors the
wrappers `init_tables` and `replay` launch the hand-written kernels of
tpusim_torch/kernels/replay.cu; on CPU tensors they run the plain PyTorch
versions `plain_init_tables` and `plain_replay`, which the tests hold
against the JAX package. The plain versions use the policies' column
functions (tpusim_torch.policies) and `feas_column`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tpusim_torch.constants import (
    CPU_FULL_W,
    CPU_IDLE_W,
    CPU_NCORES,
    GPU_FULL_W,
    GPU_IDLE_W,
    MAX_GPUS_PER_NODE,
    MILLI,
    NUM_AFF_CLASSES,
)
from tpusim_torch.kernels import (
    MAX_FAMILY,
    MAX_POLICIES,
    scratch_bytes,
    staged,
)
from tpusim_torch.ops.prng import advance_key, event_keys
from tpusim_torch.ops.resource import (
    allocate_share_best,
    allocate_share_random,
    allocate_share_worst,
    allocate_two_pointer,
    is_accessible,
    request_units,
)
from tpusim_torch.policies import (
    DIM_EXT_METHODS,
    LEARNED_NODE,
    NORM_METHODS,
    NORMALIZE_IDS,
    SELF_SELECT_POLICIES,
    Policy,
    make_policy,
)
from tpusim_torch.policies.base import normalize, wrap_i32
from tpusim_torch.policies.random_policy import random_row
from tpusim_torch.sim.engine import (
    EV_CREATE,
    EV_DELETE,
    EV_EVICT,
    EV_NODE_FAIL,
    EV_NODE_RECOVER,
    EV_RETRY,
    EV_SKIP,
    ReplayResult,
)
from tpusim_torch.sim.table_engine import PodTypes
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

_INT_MAX = torch.iinfo(torch.int32).max

# the kernel's gpu_sel modes (replay.cu kSel*)
GPU_SEL_IDS = {"best": 0, "worst": 1, "self": 2, "random": 3}

# nodes per chunk when the plain table build sweeps the cluster: bounds the
# [K, nodes, 8, T] intermediates to a few million elements
_INIT_CHUNK = 64


class ReplayConfig(NamedTuple):
    """A policy configuration the fused replay covers: the policies (those
    with table rows first, then the per-event one), their integer weights,
    the gpuSelMethod, and the index of the policy whose device picks
    Reserve takes (-1 for best, worst and random)."""

    policies: Tuple[Policy, ...]
    weights: Tuple[int, ...]
    gpu_sel: str
    sel_idx: int
    dim_ext: str = "share"  # DotProductScore's, where enabled
    norm: str = "max"
    # fam[j] is the order[j]-th of the [(name, weight)] list given to
    # make_config
    order: Tuple[int, ...] = ()
    # A learned family (learn/policy.py) as the caller named it, and its
    # weights, in the order above; `policies` and `weights` are then its
    # fold (`fold`): the node-only features become one node column
    # (LEARNED_NODE, weight 1) of ln_features (learn.policy.NODE_FEATURES
    # ids) weighted by ln_theta, and fam_src[j] says where family policy j
    # scores: its row of the tables (>= 0), or node feature -1 - id.
    # Empty for a configuration without learned features.
    family: Tuple[Policy, ...] = ()
    family_weights: Tuple[int, ...] = ()
    ln_features: Tuple[int, ...] = ()
    ln_theta: Tuple[int, ...] = ()
    fam_src: Tuple[int, ...] = ()

    @property
    def fam(self) -> Tuple[Policy, ...]:
        """The caller's policies in this configuration's order: the record
        rows' score columns."""
        return self.family or self.policies

    @property
    def fam_weights(self) -> Tuple[int, ...]:
        return self.family_weights or self.weights

    @property
    def learned(self) -> bool:
        """Whether a learned column runs (fit_dev_pct's or the node
        column): the kernels' kLearned instantiations."""
        return any(p.name in LEARNED_COLUMNS for p in self.policies)

    @property
    def gpu_sel_mode(self) -> str:
        return "self" if self.sel_idx >= 0 else self.gpu_sel

    @property
    def randomized(self) -> bool:
        """Whether the replay draws per event (RandomScore, gpu_sel
        random): it then needs a root key, and runs the flat replay."""
        return self.gpu_sel == "random" or any(p.per_event
                                               for p in self.policies)

    @property
    def num_tables(self) -> int:
        """The policies with score-table rows: all but RandomScore, whose
        score is drawn per event and which make_config puts last."""
        return sum(not p.per_event for p in self.policies)


def policy_order(policies: Sequence[Policy]):
    """The order make_config puts policies in: a per-event policy last, the
    others as given (a stable sort)."""
    return sorted(range(len(policies)), key=lambda i: policies[i].per_event)


def lane_weights(cfg: ReplayConfig, row) -> Tuple[int, ...]:
    """A weight row given in the order of the [(name, weight)] list `cfg`
    was made from, in `cfg`'s policy order (make_config moves a per-event
    policy last): the weights a lane of a sweep over `cfg`'s family
    carries (ReplayConfig.fam's; `with_weights` folds them)."""
    row = [int(w) for w in row]
    if len(row) != len(cfg.fam):
        raise ValueError(f"a weight row of {len(row)} for "
                         f"{len(cfg.fam)} policies")
    if any(not -2**31 <= w < 2**31 for w in row):
        raise ValueError(f"weights must be int32: {row}")
    return tuple(row[i] for i in cfg.order)


# the policies whose columns only the learned instantiations compute
LEARNED_COLUMNS = ("LearnedScore[fit_dev_pct]", LEARNED_NODE)
# the node column's policy: its rows are learned_node_column's
_LEARNED_NODE_POLICY = None


def _node_policy() -> Policy:
    global _LEARNED_NODE_POLICY
    if _LEARNED_NODE_POLICY is None:
        _LEARNED_NODE_POLICY = Policy(LEARNED_NODE, None, "none", False, None)
    return _LEARNED_NODE_POLICY


def fold(family: Sequence[Policy], weights: Sequence[int]):
    """The fold of a policy family (sum_f theta_f x feature_f over its
    node-only features is one i32 term: the weighted sum wraps modulo 2^32,
    so the order of adding leaves its bits as they are): (policies,
    weights, ln_features, ln_theta, fam_src) as ReplayConfig holds them.
    The node column sits where the first node-only feature was."""
    from tpusim_torch.learn.policy import NODE_FEATURES

    pols, ws, feats, theta, src = [], [], [], [], []
    at = -1
    for pol, w in zip(family, weights):
        feat = pol.node_feature
        if feat is None:
            src.append(len(pols))
            pols.append(pol)
            ws.append(int(w))
            continue
        if at < 0:
            at = len(pols)
            pols.append(_node_policy())
            ws.append(1)
        fid = NODE_FEATURES.index(feat)
        src.append(-1 - fid)
        feats.append(fid)
        theta.append(int(w))
    return (tuple(pols), tuple(ws), tuple(feats), tuple(theta), tuple(src))


def with_weights(cfg: ReplayConfig, row) -> ReplayConfig:
    """`cfg` with the weight row `row` of its family (ReplayConfig.fam's
    order; lane_weights), folded where the family has node-only
    features."""
    row = tuple(int(w) for w in row)
    if not cfg.family:
        return cfg._replace(weights=row)
    _, ws, _, theta, _ = fold(cfg.family, row)
    return cfg._replace(weights=ws, ln_theta=theta, family_weights=row)


def make_config(policies: Sequence[Tuple[str, int]], gpu_sel: str,
                dim_ext: str = "share", norm: str = "max") -> ReplayConfig:
    """The ReplayConfig of [(policy name, weight)] and a gpuSelMethod:
    every configuration tpusim's Simulator runs, through its Pallas kernel
    or its table engine (Simon and the randomized ones). gpu_sel is best,
    worst, random or an enabled self-select policy; anything else, as a
    self-select gpu_sel that names no enabled policy, raises ValueError, as
    make_pallas_replay does (tpusim's table engine would quietly pick best
    fit where the reference's plugin lookup fails). A per-event policy is
    moved last: the i32 weighted sum wraps the same in any order, and the
    score table's rows are then those of the policies before it. A learned
    family's node-only features fold into one node column (`fold`), so at
    most MAX_POLICIES columns remain of up to MAX_FAMILY policies; where
    a learned family's gpu_sel names no enabled selector, Reserve takes
    best fit, as tpusim's engines do (its gpuSelMethod then has no device
    pick to delegate to)."""
    if not policies:
        raise ValueError("the fused replay needs at least one policy")
    if len(policies) > MAX_FAMILY:
        raise ValueError(f"at most {MAX_FAMILY} policies, got {len(policies)}")
    if dim_ext not in DIM_EXT_METHODS or norm not in NORM_METHODS:
        raise ValueError(f"dim_ext {dim_ext!r} / norm {norm!r} not in "
                         f"{DIM_EXT_METHODS} / {NORM_METHODS}")
    if any(not -2**31 <= int(w) < 2**31 for _, w in policies):
        raise ValueError(f"weights must be int32: {list(policies)}")
    resolved = [(make_policy(name, dim_ext, norm), w) for name, w in policies]
    order = tuple(policy_order([p for p, _ in resolved]))
    resolved = [resolved[i] for i in order]
    fam = tuple(p for p, _ in resolved)
    fam_w = tuple(int(w) for _, w in resolved)
    names = [p.name for p in fam]
    selectors = [p.name for p in fam if p.self_select]
    learned = any(n.startswith("LearnedScore[") for n in names)
    if gpu_sel in selectors:
        sel_fam = names.index(gpu_sel)
    elif gpu_sel in ("best", "worst", "random"):
        sel_fam = -1
    elif learned:
        gpu_sel, sel_fam = "best", -1
    else:
        raise ValueError(
            f"gpu_sel must be best, worst, random or an enabled policy of "
            f"{sorted(SELF_SELECT_POLICIES)}; got {gpu_sel!r} with {names}")
    pols, ws, feats, theta, src = fold(fam, fam_w)
    if len(pols) > MAX_POLICIES:
        raise ValueError(f"at most {MAX_POLICIES} policies once a learned "
                         f"family's node-only features fold into one, got "
                         f"{len(pols)}")
    sel_idx = src[sel_fam] if sel_fam >= 0 else -1
    if not learned:
        return ReplayConfig(pols, ws, gpu_sel, sel_idx, dim_ext, norm, order)
    return ReplayConfig(pols, ws, gpu_sel, sel_idx, dim_ext, norm, order,
                        fam, fam_w, feats, theta, src)


# ---------------------------------------------------------------------------
# Plain column functions: one batch of nodes against every pod type
# ---------------------------------------------------------------------------


def feas_column(nodes: NodeState, types: PodSpec) -> torch.Tensor:
    """Filter-phase feasibility i32[K, B] (0/1) of every type on a batch of
    nodes, without the per-event pin mask. The counterpart of
    pallas_engine._feas_column."""
    tc = types.cpu[:, None]
    fit = (nodes.cpu_left >= tc) & (nodes.mem_left >= types.mem[:, None])
    milli, num = types.gpu_milli[:, None], types.gpu_num[:, None]
    can_alloc = request_units(nodes.gpu_left[None], milli).sum(-1) >= num
    acc = is_accessible(nodes.gpu_type, types.gpu_mask[:, None])
    gpu_ok = (nodes.gpu_cnt > 0) & acc & can_alloc
    needs_gpu = (milli * num) > 0
    return (fit & (~needs_gpu | gpu_ok)).to(torch.int32)


def _node_slice(state: NodeState, lo: int, hi: int) -> NodeState:
    return NodeState(*(a[lo:hi] for a in state))


def config_columns(nodes: NodeState, specs: PodSpec, ks: int,
                   tp: TypicalPods, cfg: ReplayConfig):
    """(score i32[num_tables * K, B], sdev i32[K, B], feas i32[K, B]) of a
    batch of nodes: every table policy's column, the selector's device picks
    (-1 without a selector) and the Filter bits."""
    feas = feas_column(nodes, specs)
    scores, sdev = [feas[:0]], torch.full_like(feas, -1)
    for i, pol in enumerate(cfg.policies[:cfg.num_tables]):
        if pol.name == LEARNED_NODE:
            raw = learned_node_column(nodes, specs.cpu.shape[0], tp, cfg)
        else:
            raw, dev = pol.column(nodes, specs, ks, tp)
            if i == cfg.sel_idx:
                sdev = dev
        scores.append(raw)
    return torch.cat(scores), sdev, feas


def learned_node_column(nodes: NodeState, k: int, tp: TypicalPods,
                        cfg: ReplayConfig) -> torch.Tensor:
    """The node column i32[K, B] of a batch of nodes: sum over cfg's
    node-only features of theta x feature (wrapping int32), the same for
    every type. The plain version of replay.cu learned_node_value."""
    from tpusim_torch.learn.policy import NODE_FEATURES, node_features

    ids = sorted(set(cfg.ln_features))
    rows = node_features(nodes, tp, [NODE_FEATURES[i] for i in ids])
    at = {fid: j for j, fid in enumerate(ids)}
    acc = torch.zeros(nodes.cpu_left.shape[0], dtype=torch.int64,
                      device=nodes.cpu_left.device)
    for fid, w in zip(cfg.ln_features, cfg.ln_theta):
        acc = acc + int(w) * rows[at[fid]].to(torch.int64)
    row = wrap_i32(acc)
    return row.expand(k, row.shape[0]).contiguous()


def learned_rows(tables, state: NodeState, tp: TypicalPods,
                 cfg: ReplayConfig) -> None:
    """Rewrite the node column's rows of `tables` (in place) for every node
    of `state` under cfg's weights: the plain version of replay.cu
    learned_rows, which every learned replay runs at its start (a lane of a
    sweep carries its own weights; the shared tables were built with
    another's)."""
    score, k = tables[0], tables[1].shape[0]
    for j, pol in enumerate(cfg.policies):
        if pol.name == LEARNED_NODE:
            score[j * k:(j + 1) * k] = learned_node_column(state, k, tp, cfg)


def plain_init_tables(state: NodeState, types: PodTypes, tp: TypicalPods,
                      cfg: ReplayConfig):
    """(score, sdev, feas) tables of the initial state: the plain version
    of the `init_tables` kernel."""
    specs, ks = types.stacked(), types.num_share
    cols = [config_columns(_node_slice(state, lo, lo + _INIT_CHUNK), specs,
                           ks, tp, cfg)
            for lo in range(0, state.num_nodes, _INIT_CHUNK)]
    return tuple(torch.cat(parts, dim=1).contiguous() for parts in zip(*cols))


def _affinity_class(milli: int, num: int) -> int:
    """share-GPU pod -> 0, N whole GPUs -> N, no GPU -> -1 (pod.go:111-123)."""
    if num == 0:
        return -1
    return 0 if (num == 1 and milli < MILLI) else num


def _bits_to_mask(bits: torch.Tensor) -> torch.Tensor:
    lane = torch.arange(MAX_GPUS_PER_NODE, device=bits.device,
                        dtype=torch.int32)
    return ((bits[:, None] >> lane) & 1) != 0


def root_key(key, cfg: ReplayConfig):
    """The root key of a replay as two ints, or None where `cfg` draws
    nothing; a randomized configuration without a key raises ValueError."""
    if key is None:
        if cfg.randomized:
            raise ValueError(
                "a randomized configuration (RandomScore, gpu_sel random) "
                "needs the replay's root key (tpusim_torch.ops.prng.prng_key)")
        return None
    words = [int(w) & 0xFFFFFFFF for w in
             (key.tolist() if hasattr(key, "tolist") else key)]
    if len(words) != 2:
        raise ValueError(f"a key is two 32-bit words, got {key!r}")
    return tuple(words)


def key_tensor(words, device) -> torch.Tensor:
    """A key's two uint32 words as an int32 [2] tensor of the same bits
    (the layout of the kernels' key_out)."""
    return torch.from_numpy(np.asarray(
        [int(w) & 0xFFFFFFFF for w in words], np.uint32).view(np.int32)
    ).to(device)


def mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """Device masks bool [P, 8] as the kernels' int32 bits a pod."""
    lane = torch.arange(MAX_GPUS_PER_NODE, device=masks.device,
                        dtype=torch.int32)
    return (masks.to(torch.int32) << lane).sum(1, dtype=torch.int32)


def plain_event_loop(state: NodeState, pods: PodSpec, types: PodTypes,
                     ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                     tp: TypicalPods, tables, cfg: ReplayConfig,
                     select, keep: dict = None, key=None, faults=None,
                     start=None, record=None):
    """The event loop of the plain replays. Before each event the column of
    the node the previous event touched is refreshed in copies of the
    (score, sdev, feas) `tables`; then `select(tables, dirty, kind, type,
    pin, k_rand)` runs, for every event, and on a create returns the chosen
    node (-1 = none), which Reserve and Bind take. A delete returns the
    pod's resources to the devices it held. A randomized `cfg` draws from
    the event key chain of root `key` (k_rand, k_sel of each event; None
    otherwise). `start`, where given, is (placed, mask bits, failed), int32
    [P] each: the pods' placements so far, which a delete reads (a chunk
    of a longer stream); none placed otherwise. Inputs are left unchanged;
    with `keep`, the final tables are stored in keep["tables"] and, where
    `key` is given, the chain's key after the last event in keep["key"]
    (key_tensor).

    With `faults` (a fault_lane.FaultLane) the events are a merged stream
    of fault_lane.compile_fault_plan, run as tpusim's table engine runs its
    fault lane: a retry slot pops the retry queue (pop_retry) and creates
    the popped pod, its rejection ORed into the pod's ever-failed flag, or
    skips; a node failure, recovery or eviction is a skip for the select,
    then apply_fault_step, whose touched node is the step's node and the
    next refresh's; a popped retry ends with commit_retry. Returns
    (ReplayResult, fault_lane.FaultOut) then.

    `record` (a records.PlainRecords), where given, takes each event's
    series sample after the column refresh, its decision after the select
    and its counters (and heartbeat tick) after the commit."""
    tables = tuple(t.clone() for t in tables)
    if keep is not None:
        keep["tables"] = tables
    score, sdev, feas = tables
    live = state._replace(
        cpu_left=state.cpu_left.clone(), mem_left=state.mem_left.clone(),
        gpu_left=state.gpu_left.clone(), aff_cnt=state.aff_cnt.clone(),
    )
    if cfg.family:
        learned_rows(tables, live, tp, cfg)
    cpu_left, mem_left = live.cpu_left, live.mem_left
    gpu_left, aff = live.gpu_left, live.aff_cnt
    specs, ks = types.stacked(), types.num_share
    dev = cpu_left.device
    p, e = pods.cpu.shape[0], ev_kind.shape[0]

    host = {f: pods._asdict()[f].tolist() for f in PodSpec._fields}
    type_id = types.type_id.tolist()
    kinds, ev_pods = ev_kind.tolist(), ev_pod.tolist()
    placed, maskb, failed = [-1] * p, [0] * p, [0] * p
    if start is not None:
        placed, maskb, failed = (t.tolist() for t in start)
    evnode, evdevb = [-1] * e, [0] * e
    key = root_key(key, cfg)
    if keep is not None and key is not None:
        keep["key"] = key_tensor(advance_key(key, e), dev)
    k_rand = k_sel = [None] * e
    if cfg.randomized:
        k_rand, k_sel = (k.tolist() for k in event_keys(key, e))
    steps = _FaultSteps(faults, live, pods, tp, e) if faults else None
    dirty = -1
    for i in range(e):
        if dirty >= 0:
            col = config_columns(_node_slice(live, dirty, dirty + 1), specs,
                                 ks, tp, cfg)
            for table, c in zip(tables, col):
                table[:, dirty] = c[:, 0]
        kind, idx = kinds[i], ev_pods[i]
        popped = -1
        if steps is not None:
            kind, idx, popped = steps.pop(i, kind, idx)
        tid, pin = type_id[idx], host["pinned"][idx]
        if record is not None:
            record.sample(live, tables, tid)
        node = select(tables, dirty, kind, tid, pin, k_rand[i])
        if record is not None:
            record.decide(kind, tables, tid, pin, k_rand[i], node, live)
        pcpu, pmem = host["cpu"][idx], host["mem"][idx]
        pmilli, pnum = host["gpu_milli"][idx], host["gpu_num"][idx]
        cls = _affinity_class(pmilli, pnum)
        if kind == EV_CREATE:
            ok = node >= 0
            bits = 0
            if ok and pmilli * pnum > 0:
                g8 = gpu_left[node]
                if pnum == 1 and pmilli < MILLI:  # share-GPU pod
                    if cfg.gpu_sel == "random":
                        d = int(allocate_share_random(g8, pmilli, k_sel[i]))
                    elif cfg.gpu_sel == "worst":
                        d = int(allocate_share_worst(g8, pmilli))
                    else:
                        d = int(allocate_share_best(g8, pmilli))
                    if cfg.sel_idx >= 0 and int(sdev[tid, node]) >= 0:
                        d = int(sdev[tid, node])
                    bits = (1 << d) if d >= 0 else 0
                else:
                    units = allocate_two_pointer(g8, pmilli, pnum)
                    bits = sum(1 << d for d in range(MAX_GPUS_PER_NODE)
                               if int(units[d]) > 0)
            if ok:
                cpu_left[node] -= pcpu
                mem_left[node] -= pmem
                for d in range(MAX_GPUS_PER_NODE):
                    if bits >> d & 1:
                        gpu_left[node, d] -= pmilli
                if 0 <= cls < NUM_AFF_CLASSES:
                    aff[node, cls] += 1
            placed[idx] = node
            maskb[idx] = bits
            # a popped retry ORs its rejection into the ever-failed flag
            failed[idx] = (failed[idx] if popped >= 0 else 0) if ok else 1
            evnode[i], evdevb[i] = node, bits
            dirty = max(node, 0)
        elif kind == EV_DELETE:
            node, bits = placed[idx], maskb[idx]
            if node >= 0:
                cpu_left[node] += pcpu
                mem_left[node] += pmem
                for d in range(MAX_GPUS_PER_NODE):
                    if bits >> d & 1:
                        gpu_left[node, d] += pmilli
                if 0 <= cls < NUM_AFF_CLASSES:
                    aff[node, cls] -= 1
            placed[idx], maskb[idx] = -1, 0
            evnode[i], evdevb[i] = node, bits
            dirty = max(node, 0)
        if steps is not None:
            touched = steps.end(i, kinds[i], popped, node, placed, maskb,
                                failed)
            if touched >= 0:
                evnode[i], evdevb[i] = touched, 0
                dirty = touched
        if record is not None:
            record.count(kind, evnode[i])

    def t(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    result = ReplayResult(live, t(placed), _bits_to_mask(t(maskb)),
                          t(failed) != 0, None, t(evnode),
                          _bits_to_mask(t(evdevb)))
    if steps is None:
        return result
    return result, steps.out()


class _FaultSteps:
    """plain_event_loop's fault lane: the carry, and the steps' FaultY, of
    one merged stream (fault_lane's step functions on the loop's state)."""

    def __init__(self, faults, live: NodeState, pods: PodSpec,
                 tp: TypicalPods, e: int):
        from tpusim_torch.sim import fault_lane as fl

        self.fl, self.live, self.pods, self.tp = fl, live, pods, tp
        self.ops, self.fc = faults.ops, faults.carry
        self.frag = faults.n_recover > 0
        self.pos, self.arg, self.aux = (x.tolist() for x in
                                        (self.ops.pos, self.ops.arg,
                                         self.ops.aux))
        self.node_ids = torch.arange(live.num_nodes, dtype=torch.int32,
                                     device=live.cpu_left.device)
        self.ys = {name: [-1] * e for name in ("rpod", "lat", "vpod",
                                               "vnode")}
        self.ys.update(nvict=[0] * e, rec=[0] * e, fb=[0.0] * e,
                       fa=[0.0] * e)

    def pop(self, i: int, kind: int, idx: int):
        """(kind, pod, popped pod or -1) of step i for the select: a retry
        slot's pop, a fault step's skip."""
        if kind == EV_RETRY:
            self.fc, has, pod = self.fl.pop_retry(self.fc, True, self.pos[i],
                                                  self.arg[i])
            if bool(has):
                return EV_CREATE, int(pod), int(pod)
            return EV_SKIP, idx, -1
        return (EV_SKIP if kind > EV_SKIP else kind), idx, -1

    def end(self, i: int, kind: int, popped: int, node: int, placed,
            maskb, failed) -> int:
        """The fault half of step i after its own outcome, on the loop's
        host lists; returns the node the step touched (-1 none)."""
        fl, dev = self.fl, self.node_ids.device
        touched = -1
        if kind in (EV_NODE_FAIL, EV_NODE_RECOVER, EV_EVICT):
            def t(values):
                return torch.tensor(values, dtype=torch.int32, device=dev)

            state, pl, masks, fd, self.fc, tch, y = fl.apply_fault_step(
                self.live, t(placed), _bits_to_mask(t(maskb)),
                t(failed) != 0, self.fc, self.pods, kind, self.arg[i],
                self.aux[i], self.pos[i], self.ops, self.tp, self.node_ids,
                self.frag)
            for name in ("cpu_left", "mem_left", "gpu_left", "aff_cnt"):
                getattr(self.live, name).copy_(getattr(state, name))
            placed[:] = pl.tolist()
            maskb[:] = mask_bits(masks).tolist()
            failed[:] = fd.to(torch.int32).tolist()
            for name in ("vpod", "vnode", "nvict", "rec", "fb", "fa"):
                self.ys[name][i] = getattr(y, name).item()
            touched = int(tch)
        if popped >= 0:
            self.fc, lat, _ = fl.commit_retry(self.fc, True, popped, node,
                                              self.pos[i], self.arg[i],
                                              self.ops.params)
            self.ys["rpod"][i], self.ys["lat"][i] = popped, int(lat)
        return touched

    def out(self):
        dev = self.node_ids.device
        ys = self.fl.FaultY(**{
            name: torch.tensor(v, dtype=torch.float32 if name in ("fb", "fa")
                               else torch.int32, device=dev)
            for name, v in self.ys.items()})
        return self.fl.FaultOut(self.fc, ys)


def plain_replay(state: NodeState, pods: PodSpec, types: PodTypes,
                 ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                 tp: TypicalPods, rank: torch.Tensor, tables,
                 cfg: ReplayConfig, keep: dict = None,
                 key=None, faults=None, start=None, record=None):
    """The plain version of the `replay` kernel: an event loop over tensor
    ops. `tables` are the (score, sdev, feas) tables of the initial state.
    selectHost scans the event type's row over all N nodes; RandomScore's
    row is the event's draw from `key`'s chain. `start` and `keep` are
    plain_event_loop's (the final tables, and the chain's key after the
    last event). With `faults` (a
    fault_lane.FaultLane over a merged stream) it is the plain version of
    `replay_faults` and returns (ReplayResult, fault_lane.FaultOut). With
    `record` (a records.RecordSpec) it is the plain version of
    `replay_record`: keep["records"] (keep is then required) gets the
    records.Records."""
    k, n = types.num_types, state.num_nodes
    node_ids = torch.arange(n, device=rank.device, dtype=torch.int32)

    def select(tables, dirty, kind, tid, pin, k_rand) -> int:
        if kind != EV_CREATE:
            return -1
        score, _, feas = tables
        feasible = feas[tid] != 0
        if pin >= 0:
            feasible = feasible & (node_ids == pin)

        def row(j, pol):
            if pol.per_event:
                return random_row(k_rand, feasible)
            return normalize(pol.normalize, score[j * k + tid], feasible)

        # the i32 weighted sum, wrapping as XLA's int32 does
        total = wrap_i32(sum(
            w * row(j, pol).to(torch.int64)
            for j, (pol, w) in enumerate(zip(cfg.policies, cfg.weights))))
        best = torch.where(feasible, total, -_INT_MAX).max()
        key = torch.where(feasible & (total == best), -rank, -_INT_MAX)
        m = key.max()
        if bool(m == -_INT_MAX):
            return -1
        return int(torch.where(key == m, node_ids, n).min())

    rec = None
    if record is not None:
        from tpusim_torch.sim.records import PlainRecords

        rec = PlainRecords(record, cfg, tp, rank, n)
    out = plain_event_loop(state, pods, types, ev_kind, ev_pod, tp, tables,
                           cfg, select, keep, key, faults, start, rec)
    if rec is not None:
        keep["records"] = rec.result()
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers: the CUDA kernel on CUDA tensors, the plain version on CPU
# ---------------------------------------------------------------------------


def _i32(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {x.dtype}")
    return x.contiguous()


def _args(state, types_k, ks, tp, tables, cfg: ReplayConfig, **extra):
    """ReplayArgs over CUDA tensors; returns (args, tensors kept alive)."""
    from tpusim_torch.kernels import ReplayArgs

    if tp.freq.dtype != torch.float32:
        raise TypeError(f"typical freq: expected float32, got {tp.freq.dtype}")
    named = {
        "cpu_left": state.cpu_left, "mem_left": state.mem_left,
        "gpu_left": state.gpu_left, "aff_cnt": state.aff_cnt,
        "cpu_cap": state.cpu_cap, "cpu_type": state.cpu_type,
        "mem_cap": state.mem_cap,
        "gpu_cnt": state.gpu_cnt, "gpu_type": state.gpu_type,
        "t_cpu": types_k.cpu, "t_mem": types_k.mem,
        "t_milli": types_k.gpu_milli, "t_num": types_k.gpu_num,
        "t_mask": types_k.gpu_mask,
        "tp_cpu": tp.cpu, "tp_milli": tp.gpu_milli, "tp_num": tp.gpu_num,
        "tp_mask": tp.gpu_mask,
        "score": tables[0], "sdev": tables[1], "feas": tables[2],
        **{k: v for k, v in extra.items() if isinstance(v, torch.Tensor)},
    }
    dev = state.cpu_left.device
    keep = {}
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the state on {dev}")
        keep[name] = _i32(x, name)
    keep["tp_freq"] = tp.freq.contiguous()
    for name, values in (("gpu_idle_w", GPU_IDLE_W), ("gpu_full_w", GPU_FULL_W),
                         ("cpu_idle_w", CPU_IDLE_W), ("cpu_full_w", CPU_FULL_W),
                         ("cpu_ncores", CPU_NCORES)):
        keep[name] = torch.as_tensor(values, device=dev)
    n, k = state.num_nodes, types_k.cpu.shape[0]
    rows = cfg.num_tables * k
    if state.gpu_left.shape != (n, MAX_GPUS_PER_NODE) or \
            state.aff_cnt.shape != (n, NUM_AFF_CLASSES):
        raise ValueError("gpu_left must be [N, 8] and aff_cnt [N, 9]")
    if tables[0].shape != (rows, n) or \
            any(t.shape != (k, n) for t in tables[1:]):
        raise ValueError(f"tables must be [num_tables*K, N] = [{rows}, {n}] "
                         f"and [K, N] = [{k}, {n}]")
    args = ReplayArgs(**{name: x.data_ptr() for name, x in keep.items()})
    args.n, args.k, args.ks, args.t = n, k, ks, tp.size
    args.n_pol = len(cfg.policies)
    for i, (pol, w) in enumerate(zip(cfg.policies, cfg.weights)):
        args.pol_column[i] = pol.column_id
        args.pol_norm[i] = NORMALIZE_IDS[pol.normalize]
        args.pol_weight[i] = w
    args.sel = cfg.sel_idx
    args.gpu_sel = GPU_SEL_IDS[cfg.gpu_sel_mode]
    args.dim_ext = DIM_EXT_METHODS.index(cfg.dim_ext)
    args.norm = NORM_METHODS.index(cfg.norm)
    args.ln_n = len(cfg.ln_features)
    for j, (fid, w) in enumerate(zip(cfg.ln_features, cfg.ln_theta)):
        args.ln_feat[j], args.ln_theta[j] = fid, w
    args.fam_n = len(cfg.fam_src)
    for j, src in enumerate(cfg.fam_src):
        args.fam_src[j] = src
    for name, v in extra.items():
        if name == "key":
            if v is not None:
                args.key[0], args.key[1] = v
        elif not isinstance(v, torch.Tensor):
            setattr(args, name, int(v))
    return args, keep


class Launch(NamedTuple):
    """One kernel launch made ready: the kernel's name, its ReplayArgs, the
    tensors the args point into by field name (kept alive with them), and
    `finish()`, which returns the launch's result once queued."""

    name: str
    args: object
    tensors: dict
    finish: Callable[[], object]


def launch(ready: Launch) -> None:
    """Queue a prepared launch on the current stream of its device. A
    record launch with a heartbeat ring (tensors["ring"]) is drained by an
    obs.heartbeat.RingTicker while it runs: this call then returns once the
    launch has completed, every tick delivered (the ring lives as long as
    the launch's tensors)."""
    from tpusim_torch.kernels import LANE_KERNELS, launch_lanes
    from tpusim_torch.kernels import launch as launch_kernel

    dev = ready.tensors["cpu_left"].device
    stream = torch.cuda.current_stream(dev)
    if ready.name in LANE_KERNELS:
        launch_lanes(ready.name, ready.args,
                     ready.tensors["lanes_dev"].data_ptr(), stream.cuda_stream)
        return
    ring = ready.tensors.get("ring")
    if ring is None:
        launch_kernel(ready.name, ready.args, stream.cuda_stream)
        return
    from tpusim_torch.obs.heartbeat import RingTicker
    from tpusim_torch.sim.records import processed

    ticker = RingTicker(ring, ready.args.hb_every,
                        processed(ready.tensors["ctr"].cpu()))
    ticker.start()
    done = None
    try:
        launch_kernel(ready.name, ready.args, stream.cuda_stream)
        done = torch.cuda.Event()
        done.record(stream)
    finally:
        ticker.stop(done)


def _cuda_only(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")


def type_order(types: PodTypes) -> torch.Tensor:
    """The order in which the init_tables kernel batches FGD's
    hypotheticals: the type indices by FGD's key (share types first, then
    milli, then GPU count; FGD's sum depends on a type only through these
    and, per typical pod, whether the pod's CPU fits after the type's), ties
    by index. int32 [K], on the types' device."""
    specs = types.stacked()
    whole = (torch.arange(specs.cpu.shape[0], device=specs.cpu.device)
             >= types.num_share).long()
    key = (whole << 42) | (specs.gpu_milli.long() << 21) | specs.gpu_num.long()
    return torch.argsort(key, stable=True).int()


def prepare_init_tables(state: NodeState, types: PodTypes, tp: TypicalPods,
                        cfg: ReplayConfig) -> Launch:
    """The `init_tables` launch over CUDA tensors: its outputs are new
    (score [num_tables * K, N], sdev [K, N], feas [K, N]) tables."""
    dev = state.cpu_left.device
    _cuda_only(dev, "init_tables")
    specs = types.stacked()
    k = specs.cpu.shape[0]
    tables = tuple(torch.empty((rows, state.num_nodes), dtype=torch.int32,
                               device=dev)
                   for rows in (cfg.num_tables * k, k, k))
    args, keep = _args(state, specs, types.num_share, tp, tables, cfg,
                       t_order=type_order(types))
    return Launch("init_tables", args, keep, lambda: tables)


def init_tables(state: NodeState, types: PodTypes, tp: TypicalPods,
                cfg: ReplayConfig):
    """(score, sdev, feas) tables of `state` under `cfg`: the `init_tables`
    CUDA kernel on CUDA tensors, plain_init_tables on CPU tensors."""
    if state.cpu_left.device.type == "cpu":
        return plain_init_tables(state, types, tp, cfg)
    ready = prepare_init_tables(state, types, tp, cfg)
    launch(ready)
    (init_tables_learned if cfg.learned else init_tables).launches += 1
    return ready.finish()


def validate_events(ev_kind, ev_pod, num_pods: int) -> None:
    """A malformed event stream fails here, before anything runs: the
    kernel indexes pods by these values without bounds checks."""
    ev_kind, ev_pod = np.asarray(ev_kind), np.asarray(ev_pod)
    if ev_kind.ndim != 1 or ev_pod.shape != ev_kind.shape:
        raise ValueError(
            f"event stream shape mismatch: ev_kind {ev_kind.shape} vs "
            f"ev_pod {ev_pod.shape} (want matching 1-D arrays)"
        )
    bad = (ev_kind < EV_CREATE) | (ev_kind > EV_SKIP)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"event {i}: unknown kind {int(ev_kind[i])}")
    oob = (ev_pod < 0) | (ev_pod >= num_pods)
    if oob.any():
        i = int(np.flatnonzero(oob)[0])
        raise ValueError(
            f"event {i}: pod index {int(ev_pod[i])} out of range for "
            f"{num_pods} pods"
        )


def prepare_replay(state: NodeState, pods: PodSpec, types: PodTypes,
                   ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                   tp: TypicalPods, rank: torch.Tensor, tables,
                   cfg: ReplayConfig, name: str = "replay", key=None,
                   start=None, key_out: bool = False, record=None,
                   n_real: int = None, **extra) -> Launch:
    """The `replay` launch over CUDA tensors (or that of kernel `name`,
    which takes the same arguments and the `extra` tensors), from the root
    `key` where `cfg` is randomized. It mutates copies of the state
    (tensors "cpu_left", "mem_left", "gpu_left", "aff_cnt") and of the
    tables ("score", "sdev", "feas"), and writes "placed", "maskb" and
    "failed" (copies of `start`'s (placed, mask bits, failed), int32 [P]
    each, where given; else -1, 0 and 0) and the per-event outputs. With
    `key_out` (and a `key`), the kernel writes the chain's key after the
    last event into "key_out" (key_tensor; the root key if there is no
    event). A shape past the staged limits (kernels.staged) gets the global
    form: a "scratch" buffer in device memory. With `record` (a
    records.RecordSpec) the launch runs the record form; finish() then
    returns (its result, records.Records), and the tensors hold "ring",
    the heartbeat's kernels.MappedBuffer, where it ticks (`n_real`: the
    nodes before any padding, records.launch_fields)."""
    dev = state.cpu_left.device
    _cuda_only(dev, name)
    key = root_key(key, cfg)
    finish_records = ring = None
    if record is not None:
        from tpusim_torch.sim.records import launch_fields

        fields, finish_records = launch_fields(
            record, ev_kind.shape[0], len(cfg.fam), dev,
            state.num_nodes if n_real is None else n_real)
        ring = fields.pop("ring", None)
        extra.update(fields)
    if key_out:
        if key is None:
            raise ValueError("key_out needs the replay's root key")
        extra["key_out"] = key_tensor(key, dev)
    if not staged(types.num_types, tp.size):
        nbytes = scratch_bytes(types.num_types, tp.size, len(cfg.policies),
                               name.startswith("replay_blocked"))
        extra["scratch"] = torch.empty(-(-nbytes // 4), dtype=torch.int32,
                                       device=dev)
    live = state._replace(
        cpu_left=state.cpu_left.clone(), mem_left=state.mem_left.clone(),
        gpu_left=state.gpu_left.clone(), aff_cnt=state.aff_cnt.clone(),
    )
    tables = tuple(t.clone() for t in tables)
    p, e = pods.cpu.shape[0], ev_kind.shape[0]
    if ev_pod.shape != (e,) or rank.shape != (state.num_nodes,) or \
            types.type_id.shape != (p,):
        raise ValueError("ev_pod [E], rank [N] and type_id [P] must match")

    def out(size):
        return torch.empty(size, dtype=torch.int32, device=dev)

    if start is None:
        placed, maskb, failed = (torch.full((p,), -1, dtype=torch.int32,
                                            device=dev), out(p).zero_(),
                                 out(p).zero_())
    else:
        placed, maskb, failed = (_i32(t, "start").clone() for t in start)
        if any(t.shape != (p,) for t in (placed, maskb, failed)):
            raise ValueError("start must be three int32 [P] tensors")
    ev_node, ev_devb = out(e), out(e)
    args, keep = _args(
        live, types.stacked(), types.num_share, tp, tables, cfg,
        rank=rank, p_cpu=pods.cpu, p_mem=pods.mem, p_milli=pods.gpu_milli,
        p_num=pods.gpu_num, p_pinned=pods.pinned, p_type=types.type_id,
        ev_kind=ev_kind, ev_pod=ev_pod, placed=placed, maskb=maskb,
        failed=failed, ev_node=ev_node, ev_devb=ev_devb, p=p, e=e, key=key,
        **extra,
    )
    if ring is not None:
        keep["ring"] = ring

    def finish():
        out = ReplayResult(live, placed, _bits_to_mask(maskb), failed != 0,
                           None, ev_node, _bits_to_mask(ev_devb))
        return out if finish_records is None else (out, finish_records())

    return Launch(name, args, keep, finish)


def replay(state: NodeState, pods: PodSpec, types: PodTypes,
           ev_kind: torch.Tensor, ev_pod: torch.Tensor, tp: TypicalPods,
           rank: torch.Tensor, tables, cfg: ReplayConfig,
           key=None, start=None, keep: dict = None,
           record=None) -> ReplayResult:
    """Replay every event from `state` with the (score, sdev, feas) tables
    of `state` under `cfg`, drawing from root `key` where `cfg` is
    randomized: the `replay` CUDA kernel on CUDA tensors, plain_replay on
    CPU tensors. `start` (placed, mask bits, failed; int32 [P]) continues
    a stream whose earlier events placed pods. With `keep`, the final
    tables land in keep["tables"] and, where `key` is given, the chain's
    key after the last event in keep["key"] (an int32 [2] tensor of its
    bits). Inputs are left unchanged. The kernel trusts the event kinds,
    the pod indices and `types.type_id`: the replayer of make_fused_replay
    checks the events on the host first, and build_pod_types makes type ids
    in range. With `record` (a records.RecordSpec) the record form runs
    (`replay_record`, its plain version on the CPU): keep (then required)
    gets "records", the records.Records."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay(state, pods, types, ev_kind, ev_pod, tp, rank,
                            tables, cfg, keep=keep, key=key, start=start,
                            record=record)
    ready = prepare_replay(state, pods, types, ev_kind, ev_pod, tp, rank,
                           tables, cfg, key=key, start=start,
                           key_out=keep is not None and key is not None,
                           record=record)
    launch(ready)
    if record is None:
        (replay_learned if cfg.learned else replay).launches += 1
        return kept(ready, keep)
    (replay_learned_record if cfg.learned else replay_record).launches += 1
    out, keep["records"] = kept(ready, keep)
    return out


def kept(ready: Launch, keep: dict):
    """A replay launch's result; with `keep`, its final tables and (where
    it wrote one) its key_out stored as the plain versions store them."""
    if keep is not None:
        keep["tables"] = tuple(ready.tensors[name]
                               for name in ("score", "sdev", "feas"))
        if "key_out" in ready.tensors:
            keep["key"] = ready.tensors["key_out"]
    return ready.finish()


def fault_args(faults, e: int, state: NodeState, tp: TypicalPods):
    """A fault form's ReplayArgs fields for a fault_lane.FaultLane over a
    merged stream of `e` steps, on the state's device: the operands, copies
    of the carry (the kernel updates them in place), the steps' outputs at
    their defaults and the recover snapshots. Returns (fields, finish),
    finish() giving the fault_lane.FaultOut once the launch is queued: the
    carry, and the FaultY with the recover frag before and after each
    applied recover (fault_lane.recover_frags, from the snapshots, on the
    device)."""
    from tpusim_torch.sim import fault_lane as fl

    dev = state.cpu_left.device
    ops, c, s = faults.ops, faults.carry, int(faults.n_recover)
    if state.num_nodes != c.down_at.shape[0]:
        raise ValueError(f"the carry has {c.down_at.shape[0]} nodes, the "
                         f"state {state.num_nodes}")
    n = state.num_nodes
    params = ops.params.tolist()

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    carry = {name: getattr(c, name).to(torch.int32).clone() for name in
             ("q_ready", "q_seq", "q_pod", "q_att", "q_era", "attempts",
              "evicted_at", "dead", "down_at", "dctr")}
    carry["seq"] = c.seq.to(torch.int32).reshape(1).clone()
    ys = {name: full((e,), -1) for name in ("rpod", "lat", "vpod", "vnode")}
    ys.update(nvict=full((e,), 0), rec=full((e,), 0))
    snaps = dict(snap_cpu=full((max(s, 1), n), 0),
                 snap_gpu=full((max(s, 1), n, MAX_GPUS_PER_NODE), 0),
                 snap_node=full((max(s, 1),), -1))
    fields = dict(
        f_pos=ops.pos, f_arg=ops.arg, f_aux=ops.aux, f_draws=ops.draws,
        f_seq=carry["seq"], f_attempts=carry["attempts"],
        f_evicted_at=carry["evicted_at"], f_dead=carry["dead"],
        f_down_at=carry["down_at"], f_dctr=carry["dctr"],
        **{k: carry[k] for k in ("q_ready", "q_seq", "q_pod", "q_att",
                                 "q_era")},
        **{f"y_{k}": v for k, v in ys.items()}, **snaps,
        f_rows=ops.draws.shape[0], f_cols=ops.draws.shape[1],
        f_cap_r=c.q_pod.shape[0], f_base=params[0], f_cap=params[1],
        f_maxr=params[2], f_nrec=s)

    def finish():
        fb = fa = torch.zeros(e, dtype=torch.float32, device=dev)
        if s > 0:
            fbs, fas = fl.recover_frags(
                (snaps["snap_cpu"], snaps["snap_gpu"]),
                snaps["snap_node"].clamp(min=0), state, tp)
            rec = ys["rec"] > 0
            slot = (torch.cumsum(ys["rec"], 0) - 1).clamp(0, s - 1)
            fb = torch.where(rec, fbs[slot], 0.0)
            fa = torch.where(rec, fas[slot], 0.0)
        fc = fl.FaultCarry(
            seq=carry["seq"][0], dead=carry["dead"] != 0,
            **{k: v for k, v in carry.items() if k not in ("seq", "dead")})
        return fl.FaultOut(fc, fl.FaultY(fb=fb, fa=fa, **ys))

    return fields, finish


def prepare_replay_faults(state: NodeState, pods: PodSpec, types: PodTypes,
                          ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                          tp: TypicalPods, rank: torch.Tensor, tables,
                          cfg: ReplayConfig, faults, key=None,
                          name: str = "replay_faults", **extra) -> Launch:
    """The `replay_faults` launch (or that of the fault form `name`) over
    CUDA tensors: prepare_replay's, over the merged stream (ev_kind, ev_pod)
    of the fault_lane.FaultLane `faults`. finish() returns (its result,
    fault_lane.FaultOut)."""
    fields, finish_faults = fault_args(faults, ev_kind.shape[0], state, tp)
    ready = prepare_replay(state, pods, types, ev_kind, ev_pod, tp, rank,
                           tables, cfg, name=name, key=key, **fields,
                           **extra)
    return ready._replace(finish=lambda: (ready.finish(), finish_faults()))


def replay_faults(state: NodeState, pods: PodSpec, types: PodTypes,
                  ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                  tp: TypicalPods, rank: torch.Tensor, tables,
                  cfg: ReplayConfig, faults, key=None):
    """replay over a merged stream of fault_lane.compile_fault_plan (kinds
    0-6) with the fault_lane.FaultLane `faults`: the `replay_faults` CUDA
    kernel on CUDA tensors, plain_replay(faults=) on CPU tensors. Returns
    (ReplayResult, fault_lane.FaultOut); the inputs are left unchanged."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay(state, pods, types, ev_kind, ev_pod, tp, rank,
                            tables, cfg, key=key, faults=faults)
    ready = prepare_replay_faults(state, pods, types, ev_kind, ev_pod, tp,
                                  rank, tables, cfg, faults, key=key)
    launch(ready)
    (replay_learned_faults if cfg.learned else replay_faults).launches += 1
    return ready.finish()


# ---------------------------------------------------------------------------
# Lanes: B independent replays of one configuration family in one launch
# ---------------------------------------------------------------------------


class Lane(NamedTuple):
    """One lane of a lanes replay: its pods and their ids into the shared
    pod types, its event stream, its tie-break rank, its weights in the
    configuration's policy order (lane_weights) and its root key (None
    where the configuration draws nothing). The tables, the initial state
    and the typical pods are shared by every lane."""

    pods: PodSpec
    type_id: torch.Tensor
    ev_kind: torch.Tensor
    ev_pod: torch.Tensor
    rank: torch.Tensor
    weights: Tuple[int, ...]
    key: object = None
    # the lane's fault_lane.FaultLane in the lanes' fault forms (its events
    # are then a merged stream)
    faults: object = None


def _lane_types(types: PodTypes, lane: Lane) -> PodTypes:
    return types._replace(type_id=lane.type_id)


def _lane_config(cfg: ReplayConfig, lane: Lane) -> ReplayConfig:
    return with_weights(cfg, lane.weights)


def plain_replay_lanes(state: NodeState, types: PodTypes, tp: TypicalPods,
                       tables, cfg: ReplayConfig, lanes: Sequence[Lane],
                       keep: dict = None):
    """The plain version of the `replay_lanes` kernel: plain_replay lane by
    lane, each from `state` and the shared (score, sdev, feas) `tables`.
    Returns a ReplayResult a lane ((ReplayResult, fault_lane.FaultOut) for
    lanes with faults: the plain version of `replay_lanes_faults`); with
    `keep`, keep["tables"] holds each lane's final tables."""
    outs, finals = [], []
    for lane in lanes:
        kept = {}
        outs.append(plain_replay(
            state, lane.pods, _lane_types(types, lane), lane.ev_kind,
            lane.ev_pod, tp, lane.rank, tables, _lane_config(cfg, lane),
            keep=kept, key=lane.key, faults=lane.faults))
        finals.append(kept["tables"])
    if keep is not None:
        keep["tables"] = finals
    return outs


# the state fields a replay mutates
_LIVE = ("cpu_left", "mem_left", "gpu_left", "aff_cnt")


def lane_copies(x: torch.Tensor, b: int) -> torch.Tensor:
    """b copies of `x` as one [b, ...] tensor."""
    return x.unsqueeze(0).expand(b, *x.shape).clone()


def prepare_replay_lanes(state: NodeState, types: PodTypes, tp: TypicalPods,
                         tables, cfg: ReplayConfig, lanes: Sequence[Lane],
                         name: str = "replay_lanes",
                         lane_extra: dict = None,
                         per_lane: Sequence[dict] = None) -> Launch:
    """The `replay_lanes` launch over CUDA tensors (or that of lanes kernel
    `name`): lane b replays its events from its own copy of `state` and of
    the (score, sdev, feas) `tables` of `state`. Each field's lane copies
    are one [B, ...] tensor ("cpu_left", ..., "score", ...), as are the
    outputs ("placed", "maskb", "failed" [B, max P]; "ev_node", "ev_devb"
    [B, max E]) and `lane_extra`'s tensors, whose lane b is passed as lane
    b's argument of that name, as are `per_lane[b]`'s fields. "lanes" holds
    each lane's tensors by field name, "lanes_dev" the device copy of the
    lanes' arguments. finish() returns a ReplayResult a lane, sliced to its
    pods and events."""
    from tpusim_torch.kernels import ReplayArgs

    dev = state.cpu_left.device
    _cuda_only(dev, name)
    b = len(lanes)
    if b < 1:
        raise ValueError("a lanes replay needs at least one lane")
    n = state.num_nodes
    keys = [root_key(lane.key, cfg) for lane in lanes]
    live = {f: lane_copies(getattr(state, f), b) for f in _LIVE}
    copies = tuple(lane_copies(t, b) for t in tables)
    sizes = [(lane.pods.cpu.shape[0], lane.ev_kind.shape[0])
             for lane in lanes]
    for lane, (p, e) in zip(lanes, sizes):
        if lane.ev_pod.shape != (e,) or lane.rank.shape != (n,) or \
                lane.type_id.shape != (p,):
            raise ValueError("each lane's ev_pod [E], rank [N] and type_id "
                             "[P] must match")
    pmax, emax = max(p for p, _ in sizes), max(e for _, e in sizes)

    def out(*size):
        return torch.empty(size, dtype=torch.int32, device=dev)

    placed = torch.full((b, pmax), -1, dtype=torch.int32, device=dev)
    maskb, failed = out(b, pmax).zero_(), out(b, pmax).zero_()
    ev_node, ev_devb = out(b, emax), out(b, emax)
    extra = dict(lane_extra or {})
    if not staged(types.num_types, tp.size):
        nbytes = scratch_bytes(types.num_types, tp.size, len(cfg.policies),
                               name.startswith("replay_blocked"))
        extra["scratch"] = out(b, -(-nbytes // 4))

    def lane_state(i):
        return state._replace(**{f: x[i] for f, x in live.items()})

    specs_k = types.stacked()
    args, kept = [], []
    for i, (lane, (p, e)) in enumerate(zip(lanes, sizes)):
        a, k = _args(
            lane_state(i), specs_k, types.num_share, tp,
            tuple(t[i] for t in copies), _lane_config(cfg, lane),
            rank=lane.rank, p_cpu=lane.pods.cpu, p_mem=lane.pods.mem,
            p_milli=lane.pods.gpu_milli, p_num=lane.pods.gpu_num,
            p_pinned=lane.pods.pinned, p_type=lane.type_id,
            ev_kind=lane.ev_kind, ev_pod=lane.ev_pod, placed=placed[i, :p],
            maskb=maskb[i, :p], failed=failed[i, :p], ev_node=ev_node[i, :e],
            ev_devb=ev_devb[i, :e], p=p, e=e, key=keys[i],
            **{f: x[i] for f, x in extra.items()},
            **(per_lane[i] if per_lane else {}))
        args.append(a)
        kept.append(k)
    lanes_dev = torch.empty(b * ctypes.sizeof(ReplayArgs), dtype=torch.uint8,
                            device=dev)
    tensors = dict(live, score=copies[0], sdev=copies[1], feas=copies[2],
                   placed=placed, maskb=maskb, failed=failed, ev_node=ev_node,
                   ev_devb=ev_devb, lanes=kept, lanes_dev=lanes_dev, **extra)

    def finish():
        return [ReplayResult(
            lane_state(i), placed[i, :p], _bits_to_mask(maskb[i, :p]),
            failed[i, :p] != 0, None, ev_node[i, :e],
            _bits_to_mask(ev_devb[i, :e]))
            for i, (p, e) in enumerate(sizes)]

    return Launch(name, args, tensors, finish)


def replay_lanes(state: NodeState, types: PodTypes, tp: TypicalPods, tables,
                 cfg: ReplayConfig, lanes: Sequence[Lane]):
    """Replay B lanes of `cfg`'s family from `state` with the (score, sdev,
    feas) tables of `state`: the `replay_lanes` CUDA kernel on CUDA tensors
    (a block a lane, one launch), plain_replay_lanes on CPU tensors. Every
    lane must run the same instantiation as `cfg`: lanes differ in weights,
    keys, ranks, pods and events only. Returns a ReplayResult a lane; the
    inputs are left unchanged."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay_lanes(state, types, tp, tables, cfg, lanes)
    ready = prepare_replay_lanes(state, types, tp, tables, cfg, lanes)
    launch(ready)
    (replay_lanes_learned if cfg.learned else replay_lanes).launches += 1
    return ready.finish()


def prepare_replay_lanes_faults(state: NodeState, types: PodTypes,
                                tp: TypicalPods, tables, cfg: ReplayConfig,
                                lanes: Sequence[Lane],
                                name: str = "replay_lanes_faults",
                                lane_extra: dict = None) -> Launch:
    """The `replay_lanes_faults` launch (or that of the lanes fault form
    `name`): prepare_replay_lanes over lanes whose events are merged
    streams, each with its fault_lane.FaultLane (Lane.faults). finish()
    returns (lanes' result, fault_lane.FaultOut) a lane."""
    fields, finishes = zip(*(fault_args(lane.faults, lane.ev_kind.shape[0],
                                        state, tp) for lane in lanes))
    ready = prepare_replay_lanes(state, types, tp, tables, cfg, lanes, name,
                                 lane_extra, per_lane=fields)
    return ready._replace(finish=lambda: [
        (out, fin()) for out, fin in zip(ready.finish(), finishes)])


def replay_lanes_faults(state: NodeState, types: PodTypes, tp: TypicalPods,
                        tables, cfg: ReplayConfig, lanes: Sequence[Lane]):
    """replay_lanes over lanes whose events are merged streams of
    fault_lane.compile_fault_plan, each with its Lane.faults: the
    `replay_lanes_faults` CUDA kernel on CUDA tensors (a block a lane, one
    launch), plain_replay_lanes on CPU tensors. Returns (ReplayResult,
    fault_lane.FaultOut) a lane."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay_lanes(state, types, tp, tables, cfg, lanes)
    ready = prepare_replay_lanes_faults(state, types, tp, tables, cfg, lanes)
    launch(ready)
    (replay_lanes_learned_faults if cfg.learned
     else replay_lanes_faults).launches += 1
    return ready.finish()


class ForcedOut(NamedTuple):
    """What a teacher-forced replay writes per event (int32, on the
    replay's device): the family's feature rows at the recorded top-3 [E,
    3, F] (-1 where absent), the feasible count [E], the family's argmax
    [E] (-1 none) and its feature row [E, F]; non-create events hold pick
    -1, feasible 0 and rows of -1."""

    feats: torch.Tensor
    feasible: torch.Tensor
    pick: torch.Tensor
    pick_feats: torch.Tensor


# the gpuSelMethods whose device pick a teacher-forced replay reproduces
# at the recorded node (tpusim/learn/dataset.py DATASET_GPU_SEL); their
# columns (replay.cu fr_sel)
FORCED_SELECTORS = {"FGDScore": 0, "PWRScore": 4, "DotProductScore": 5}


def _check_forced(cfg: ReplayConfig, gpu_sel: str) -> None:
    if any(p.normalize != "none" or p.per_event for p in cfg.fam):
        raise ValueError("a teacher-forced replay takes a family of policies "
                         "normalised 'none' (a learned family)")
    if gpu_sel not in ("best", "worst") and gpu_sel not in FORCED_SELECTORS:
        raise ValueError(f"gpu_sel {gpu_sel!r}: a teacher-forced replay "
                         f"takes best, worst or {sorted(FORCED_SELECTORS)}")


def plain_replay_forced(state: NodeState, pods: PodSpec,
                        ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                        tp: TypicalPods, rank: torch.Tensor,
                        cfg: ReplayConfig, rec_node, rec_topk,
                        gpu_sel: str) -> ForcedOut:
    """The plain version of the `replay_forced` kernel: a loop over the
    sequential oracle's step functions (sim/step.py score_pod_rows,
    packed_argmax, bind_selected, unschedule) on the state's device, as
    tpusim's TeacherReplay scans: each create scores every node under
    cfg's family and weights, then binds the RECORDED node `rec_node[i]`
    with the device `gpu_sel` picks there (a selector's pick from its
    per-pod scorer on that node alone); a delete unbinds the recorded
    placement."""
    from tpusim_torch.sim.step import (
        Placement,
        bind_selected,
        host_pods,
        packed_argmax,
        score_pod_rows,
        unschedule,
    )
    from tpusim_torch.policies.base import ScoreContext

    _check_forced(cfg, gpu_sel)
    dev = state.cpu_left.device
    pols = list(zip(cfg.fam, cfg.fam_weights))
    sel_pol = (make_policy(gpu_sel, cfg.dim_ext, cfg.norm)
               if gpu_sel in FORCED_SELECTORS else None)
    hp = host_pods(pods)
    kinds, idxs = ev_kind.tolist(), ev_pod.tolist()
    rec = [int(x) for x in np.asarray(rec_node).tolist()]
    topk = np.asarray(rec_topk).tolist()
    e, f, n = len(kinds), len(pols), state.num_nodes
    feats = torch.full((e, 3, f), -1, dtype=torch.int32, device=dev)
    pick_feats = torch.full((e, f), -1, dtype=torch.int32, device=dev)
    feasible_n = torch.zeros(e, dtype=torch.int32, device=dev)
    picks = torch.full((e,), -1, dtype=torch.int32, device=dev)
    p = pods.cpu.shape[0]
    placed = torch.full((p,), -1, dtype=torch.int32, device=dev)
    masks = torch.zeros((p, MAX_GPUS_PER_NODE), dtype=torch.bool, device=dev)
    live = state
    for i in range(e):
        kind, idx = kinds[i], idxs[i]
        pod = hp[idx]
        if kind == EV_CREATE:
            feasible, total, _, raws, _ = score_pod_rows(
                live, pod, None, pols, "best", tp)
            pick, _, ok = packed_argmax(total, feasible, rank)
            pk = int(pick) if bool(ok) else -1
            picks[i] = pk
            feasible_n[i] = feasible.sum()
            for j, tk in enumerate(topk[i]):
                if tk >= 0:
                    feats[i, j] = raws[:, min(int(tk), n - 1)]
            pick_feats[i] = raws[:, max(pk, 0)]
            node = torch.tensor(max(rec[i], 0), dtype=torch.int32,
                                device=dev)
            okb = torch.tensor(rec[i] >= 0, device=dev)
            pdev = torch.tensor(-1, dtype=torch.int32, device=dev)
            if sel_pol is not None and rec[i] >= 0:
                row = NodeState(*(a[rec[i]:rec[i] + 1] for a in live))
                ctx = ScoreContext(tp=tp, feasible=torch.ones(
                    1, dtype=torch.bool, device=dev), rng=None)
                pdev = sel_pol.scorer(row, pod, ctx).share_dev[0]
            live, plc = bind_selected(live, pod, node, okb, pdev, gpu_sel,
                                      None)
            if rec[i] >= 0:
                placed[idx] = plc.node
                masks[idx] = plc.dev_mask
        elif kind == EV_DELETE:
            live = unschedule(live, pod, Placement(placed[idx], masks[idx]))
            placed[idx] = -1
            masks[idx] = False
    return ForcedOut(feats, feasible_n, picks, pick_feats)


def prepare_replay_forced(state: NodeState, pods: PodSpec, types: PodTypes,
                          ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                          tp: TypicalPods, rank: torch.Tensor, tables,
                          cfg: ReplayConfig, rec_node: torch.Tensor,
                          rec_topk: torch.Tensor, gpu_sel: str) -> Launch:
    """The `replay_forced` launch over CUDA tensors: prepare_replay's, with
    the recorded nodes [E] and top-3 [E, 3] and the outputs of ForcedOut.
    `cfg` runs with gpu_sel best (or worst); a selector's pick goes in as
    its column (fr_sel). finish() returns (ReplayResult, ForcedOut)."""
    _check_forced(cfg, gpu_sel)
    dev = state.cpu_left.device
    e, f = ev_kind.shape[0], len(cfg.fam)

    def out(*size):
        return torch.empty(size, dtype=torch.int32, device=dev)

    outs = ForcedOut(out(e, 3, f), out(e), out(e), out(e, f))
    run_cfg = cfg._replace(gpu_sel="worst" if gpu_sel == "worst" else "best",
                           sel_idx=-1)
    ready = prepare_replay(
        state, pods, types, ev_kind, ev_pod, tp, rank, tables, run_cfg,
        name="replay_forced", fr_node=_i32(rec_node, "rec_node"),
        fr_topk=_i32(rec_topk, "rec_topk"), fr_feats=outs.feats,
        fr_feasible=outs.feasible, fr_pick=outs.pick,
        fr_pick_feats=outs.pick_feats,
        fr_sel=FORCED_SELECTORS.get(gpu_sel, -1))
    return ready._replace(finish=lambda: (ready.finish(), outs))


def replay_forced(state: NodeState, pods: PodSpec, types: PodTypes,
                  ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                  tp: TypicalPods, rank: torch.Tensor, tables,
                  cfg: ReplayConfig, rec_node: torch.Tensor,
                  rec_topk: torch.Tensor, gpu_sel: str) -> ForcedOut:
    """The teacher-forced replay of a learned family (`cfg`, its weights
    the parameters) from `state` with the (score, sdev, feas) tables of
    `state` under it: the `replay_forced` CUDA kernel on CUDA tensors,
    plain_replay_forced (the oracle's step functions) on CPU tensors."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay_forced(state, pods, ev_kind, ev_pod, tp, rank,
                                   cfg, rec_node, rec_topk, gpu_sel)
    ready = prepare_replay_forced(state, pods, types, ev_kind, ev_pod, tp,
                                  rank, tables, cfg, rec_node, rec_topk,
                                  gpu_sel)
    launch(ready)
    replay_forced.launches += 1
    return ready.finish()[1]


init_tables.launches = 0
replay.launches = 0
replay_lanes.launches = 0
replay_faults.launches = 0
replay_lanes_faults.launches = 0
replay_forced.launches = 0
# every kernel wrapper of the port; tpusim_torch.sim.hbm_engine adds
# replay_blocked, replay_blocked_lanes and their fault forms
def replay_record(*args, **kwargs):
    """`replay` with its `record` (a records.RecordSpec): the record form's
    launch count is this function's (chip_smoke.py reads it)."""
    return replay(*args, **kwargs)


replay_record.launches = 0


# The learned instantiations (kernels/replay_learned.cu,
# replay_learned_records.cu, replay_learned_faults.cu): `init_tables`,
# `replay`, `replay_lanes` and the fault forms launch them for a
# configuration with a learned column (ReplayConfig.learned), and count the
# launch here.
def init_tables_learned(*args, **kwargs):
    """init_tables of a learned configuration."""
    return init_tables(*args, **kwargs)


def replay_learned(*args, **kwargs):
    """replay of a learned configuration."""
    return replay(*args, **kwargs)


def replay_learned_record(*args, **kwargs):
    """replay_record of a learned configuration."""
    return replay(*args, **kwargs)


def replay_lanes_learned(*args, **kwargs):
    """replay_lanes of a learned configuration."""
    return replay_lanes(*args, **kwargs)


def replay_learned_faults(*args, **kwargs):
    """replay_faults of a learned configuration (replay_learned_faults.cu)."""
    return replay_faults(*args, **kwargs)


def replay_lanes_learned_faults(*args, **kwargs):
    """replay_lanes_faults of a learned configuration."""
    return replay_lanes_faults(*args, **kwargs)


for _fn in (init_tables_learned, replay_learned, replay_learned_record,
            replay_lanes_learned, replay_learned_faults,
            replay_lanes_learned_faults):
    _fn.launches = 0
KERNEL_WRAPPERS = [init_tables, replay, replay_record, replay_lanes,
                   replay_faults,
                   replay_lanes_faults, replay_forced, init_tables_learned,
                   replay_learned, replay_learned_record,
                   replay_lanes_learned, replay_learned_faults,
                   replay_lanes_learned_faults]


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def device_inputs(device, state, pods, types, ev_kind, ev_pod, tp,
                  tiebreak_rank=None):
    """A replayer's inputs on `device`, the event stream checked on the
    host first; the tie-break rank defaults to the node index."""
    def to(x):
        return x.to(device)

    state, pods = NodeState(*map(to, state)), PodSpec(*map(to, pods))
    types = PodTypes(PodSpec(*map(to, types.share)),
                     PodSpec(*map(to, types.whole)), to(types.type_id))
    tp = TypicalPods(*map(to, tp))
    if tiebreak_rank is None:
        tiebreak_rank = torch.arange(state.num_nodes, dtype=torch.int32)
    rank = to(torch.as_tensor(tiebreak_rank, dtype=torch.int32))
    ev_kind = torch.as_tensor(ev_kind, dtype=torch.int32).cpu()
    ev_pod = torch.as_tensor(ev_pod, dtype=torch.int32).cpu()
    validate_events(ev_kind.numpy(), ev_pod.numpy(), pods.cpu.shape[0])
    return state, pods, types, to(ev_kind), to(ev_pod), tp, rank


def make_fused_replay(policies: Sequence[Tuple[str, int]], gpu_sel: str,
                      device="cuda", dim_ext: str = "share",
                      norm: str = "max"):
    """The fused replayer for a policy config, the counterpart of
    pallas_engine.make_pallas_replay: `policies` is [(name, weight)], and
    make_config says what is covered. The replayer has make_pallas_replay's
    call signature (state, pods, types, ev_kind, ev_pod, tp, key,
    tiebreak_rank) and runs the CUDA kernels on a CUDA device, the plain
    versions on the CPU. It checks the event stream on the host before
    moving it to the device. `key` is the root of the event key chain (a
    jax.random key's two words, as tpusim_torch.ops.prng.prng_key gives
    it): a randomized configuration needs it, the others ignore it."""
    cfg = make_config(policies, gpu_sel, dim_ext, norm)
    device = torch.device(device)

    def run(state, pods, types, ev_kind, ev_pod, tp, key=None,
            tiebreak_rank=None) -> ReplayResult:
        key = root_key(key, cfg)
        state, pods, types, ev_kind, ev_pod, tp, rank = device_inputs(
            device, state, pods, types, ev_kind, ev_pod, tp, tiebreak_rank)
        tables = init_tables(state, types, tp, cfg)
        return replay(state, pods, types, ev_kind, ev_pod, tp, rank, tables,
                      cfg, key)

    run.config = cfg
    return run
