"""One scheduling cycle in plain PyTorch (counterpart of tpusim/sim/step.py):
Filter -> Score -> Normalize -> selectHost -> Reserve -> Bind
(generic_scheduler.go:143-210, plugin/open_gpu_share.go Reserve), the
sequential oracle's step (tpusim_torch.sim.engine.make_replay) and the two
halves the HTTP extender host loop splices its round-trips between
(score_pod, select_and_bind; tpusim_torch.sim.extender).

The oracle recomputes every policy's score over all N nodes from the state
at every event, through the policies' per-pod scorers, with no tables: it
is the engine the replay kernels are held against.

Tensors live on the replay's device. A pod is a PodSpec of host scalars
(Python ints, `host_pods`), so every branch on what the pod asks for runs
on the host and reads nothing from the card; the chosen node, its score,
the `ok` flag and the device mask stay on the device. Keys are pairs of
Python ints (tpusim_torch.ops.prng) and split on the host. As in tpusim,
every function returns new tensors and leaves its inputs unchanged.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from tpusim_torch.constants import MAX_GPUS_PER_NODE, NUM_AFF_CLASSES
from tpusim_torch.ops.prng import split
from tpusim_torch.ops.resource import (
    allocate_share_best,
    allocate_share_random,
    allocate_share_worst,
    allocate_two_pointer,
    can_allocate,
    is_accessible,
)
from tpusim_torch.policies import SELF_SELECT_POLICIES, ScoreContext
from tpusim_torch.policies.base import normalize, wrap_i32
from tpusim_torch.policies.clustering import pod_affinity_class
from tpusim_torch.types import NodeState, PodSpec

_INT_MAX = torch.iinfo(torch.int32).max


def host_pods(pods: PodSpec) -> List[PodSpec]:
    """Every pod of a [P] PodSpec as a PodSpec of Python ints: one copy to
    the host, then each event reads its pod there."""
    cols = [getattr(pods, f).tolist() for f in PodSpec._fields]
    return [PodSpec(*row) for row in zip(*cols)]


def resolve_weights(policies, weights=None) -> Tuple[int, ...]:
    """The per-policy weights as int32 values in the policies' order: the
    configured ones, or `weights` (a row of len(policies) ints) where
    given, as tpusim's weight operand."""
    if weights is None:
        return tuple(int(w) for _, w in policies)
    w = tuple(int(x) for x in (weights.tolist() if hasattr(weights, "tolist")
                               else weights))
    if len(w) != len(policies):
        raise ValueError(
            f"weights shape ({len(w)},) does not match the {len(policies)} "
            "configured policies"
        )
    if any(not -2**31 <= x < 2**31 for x in w):
        raise ValueError(f"weights must be int32: {list(w)}")
    return w


def filter_nodes(state: NodeState, pod: PodSpec) -> torch.Tensor:
    """Filter phase -> bool[N] feasibility: NodeResourcesFit (cpu and memory
    requests fit), the nodeSelector pin, and the Open-Gpu-Share Filter for
    GPU pods (a GPU node of an accessible model whose devices can pack the
    pod, open_gpu_share.go:81-118, gpunodeinfo.go:136-204)."""
    fit = (state.cpu_left >= pod.cpu) & (state.mem_left >= pod.mem)
    if pod.pinned >= 0:
        fit = fit & (torch.arange(state.num_nodes, dtype=torch.int32,
                                  device=fit.device) == pod.pinned)
    if pod.gpu_milli * pod.gpu_num > 0:
        fit = fit & ((state.gpu_cnt > 0)
                     & is_accessible(state.gpu_type, pod.gpu_mask)
                     & can_allocate(state.gpu_left, pod.gpu_milli,
                                    pod.gpu_num))
    return fit


class Placement(NamedTuple):
    """The result of one cycle: node -1 means unschedulable."""

    node: torch.Tensor  # i32 0-d, -1 = failed
    dev_mask: torch.Tensor  # bool[8] devices taken (none for CPU pods)


def _choose_share_device(gpu_left, pod: PodSpec, policy_dev, gpu_sel: str,
                         key):
    """The Reserve-phase device of a share-GPU pod on one node's row
    (open_gpu_share.go:252-343): best, worst or random fit, or the scoring
    policy's own pick, best fit where it has none."""
    if gpu_sel == "best":
        return allocate_share_best(gpu_left, pod.gpu_milli)
    if gpu_sel == "worst":
        return allocate_share_worst(gpu_left, pod.gpu_milli)
    if gpu_sel == "random":
        return allocate_share_random(gpu_left, pod.gpu_milli, key)
    return torch.where(policy_dev >= 0, policy_dev,
                       allocate_share_best(gpu_left, pod.gpu_milli))


def choose_devices(gpu_left, pod: PodSpec, policy_dev_scalar, gpu_sel: str,
                   key) -> torch.Tensor:
    """The Reserve-phase device mask bool[8] on one node's row: a share-GPU
    pod through the gpuSelMethod (_choose_share_device), a whole or
    multi-GPU pod through the two-pointer pack in device order
    (gpunodeinfo.go:182-201), none for a CPU pod."""
    if pod.gpu_milli * pod.gpu_num <= 0:
        return torch.zeros(MAX_GPUS_PER_NODE, dtype=torch.bool,
                           device=gpu_left.device)
    if bool(pod.is_gpu_share()):
        dev = _choose_share_device(gpu_left, pod, policy_dev_scalar, gpu_sel,
                                   key)
        lane = torch.arange(MAX_GPUS_PER_NODE, device=gpu_left.device)
        return (lane == dev) & (dev >= 0)
    return allocate_two_pointer(gpu_left, pod.gpu_milli, pod.gpu_num) > 0


def packed_argmax(total: torch.Tensor, valid: torch.Tensor,
                  rank: torch.Tensor):
    """selectHost's lexicographic (max score, min tie-break rank) argmax
    over M entries (nodes or blocks): (index i32, best score i32, ok bool),
    0-d tensors. The index is 0 and ok False where nothing is valid
    (generic_scheduler.go:187-212)."""
    best = torch.where(valid, total, -_INT_MAX).max()
    wkey = torch.where(valid & (total == best), -rank, -_INT_MAX)
    idx = wkey.argmax().to(torch.int32)
    return idx, best, wkey.max() != -_INT_MAX


def packed_topk(total: torch.Tensor, valid: torch.Tensor, rank: torch.Tensor,
                k: int):
    """The first k entries of selectHost's selection order, by k masked
    packed_argmax reductions: (pos i32[k], total i32[k], rank i32[k], ok
    bool[k]); entries past the valid ones carry pos and rank -1, total 0."""
    iota = torch.arange(total.shape[0], dtype=torch.int32,
                        device=total.device)
    pos, tot, rnk, oks = [], [], [], []
    v = valid
    for _ in range(k):
        idx, best, ok = packed_argmax(total, v, rank)
        pos.append(torch.where(ok, idx, -1).to(torch.int32))
        tot.append(torch.where(ok, best, 0).to(torch.int32))
        rnk.append(torch.where(ok, rank[idx.long()], -1).to(torch.int32))
        oks.append(ok)
        v = v & (iota != idx)
    return (torch.stack(pos), torch.stack(tot), torch.stack(rnk),
            torch.stack(oks))


def block_reduce(tot: torch.Tensor, rank: torch.Tensor):
    """Per-block (max total, min tie-break rank among the maxima, argmax)
    over the trailing axis: the in-block half of the blocked two-level
    selectHost. `tot` uses -INT_MAX as the infeasible sentinel; `rank`
    broadcasts against it."""
    m = tot.max(-1).values
    wkey = torch.where(tot == m[..., None], -rank, -_INT_MAX)
    a = wkey.argmax(-1)
    r = torch.gather(torch.broadcast_to(rank, tot.shape), -1, a[..., None])
    return m, r[..., 0], a.to(torch.int32)


def _at(x: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Row `node` (a 0-d device index) of x, read on the device."""
    return x.index_select(0, node.reshape(1).long())[0]


def _add_at(x: torch.Tensor, node: torch.Tensor, value) -> torch.Tensor:
    """A copy of x with `value` added to row `node` (a 0-d device index)."""
    v = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return x.index_add(0, node.reshape(1).long(),
                       v.expand(x.shape[1:]).unsqueeze(0))


def _class_row(cls: int, scale: torch.Tensor) -> torch.Tensor:
    """An aff_cnt row adding `scale` (an int32 0-d tensor) to class cls."""
    lane = torch.arange(NUM_AFF_CLASSES, dtype=torch.int32,
                        device=scale.device)
    return (lane == cls).to(torch.int32) * scale


def bind_selected(state: NodeState, pod: PodSpec, node: torch.Tensor,
                  ok: torch.Tensor, policy_dev_scalar: torch.Tensor,
                  gpu_sel: str, key) -> Tuple[NodeState, Placement]:
    """Reserve + Bind on an already selected node (ignored where not ok):
    the device choice on its row, then the commit of the placement."""
    dev_mask = choose_devices(_at(state.gpu_left, node), pod,
                              policy_dev_scalar, gpu_sel, key) & ok
    okc = ok.to(torch.int32)
    cls = pod_affinity_class(pod)
    new_state = state._replace(
        cpu_left=_add_at(state.cpu_left, node, -pod.cpu * okc),
        mem_left=_add_at(state.mem_left, node, -pod.mem * okc),
        gpu_left=_add_at(state.gpu_left, node,
                         -dev_mask.to(torch.int32) * pod.gpu_milli),
        aff_cnt=(_add_at(state.aff_cnt, node, _class_row(cls, okc))
                 if cls >= 0 else state.aff_cnt),
    )
    return new_state, Placement(torch.where(ok, node, -1).to(torch.int32),
                                dev_mask)


class PendingCommit(NamedTuple):
    """One event's deferred effects (tpusim's pipelined table engines apply
    them at the start of the next event). Host-known fields are Python
    ints; node, dev_mask, placed_val, mask_val and failed_val are device
    tensors. node -1 is a no-op state commit; pod_write is the bookkeeping
    row (P, a dummy, for skips), failed_write the ever-failed row (P
    unless the event was a creation attempt)."""

    node: torch.Tensor  # i32 touched node, -1 = none
    dev_mask: torch.Tensor  # bool[8]
    rs: int  # +1 delete (returns resources), -1 create
    cpu: int
    mem: int
    gpu_milli: int
    cls: int  # affinity class (-1 none)
    pod_write: int
    placed_val: torch.Tensor  # i32
    mask_val: torch.Tensor  # bool[8]
    failed_write: int
    failed_val: torch.Tensor  # bool


def no_pending_commit(num_pods: int, device=None) -> PendingCommit:
    """The inert PendingCommit before the first event."""
    z8 = torch.zeros(MAX_GPUS_PER_NODE, dtype=torch.bool, device=device)
    m1 = torch.tensor(-1, dtype=torch.int32, device=device)
    return PendingCommit(
        node=m1, dev_mask=z8, rs=-1, cpu=0, mem=0, gpu_milli=0, cls=-1,
        pod_write=num_pods, placed_val=m1, mask_val=z8,
        failed_write=num_pods,
        failed_val=torch.tensor(False, device=device),
    )


def make_pending_commit(kind: int, idx: int, node: torch.Tensor,
                        dev_mask: torch.Tensor, pod: PodSpec,
                        num_pods: int) -> PendingCommit:
    """Encode one event's effects (kind 0 create, 1 delete, 2 skip): a
    successful create consumes (node, dev_mask), a delete returns them,
    failed creates and skips change no state (node -1); placed and masks
    are written for creates and deletes, the ever-failed flag by creates
    alone (simulator.go:444-455)."""
    is_create = kind == 0
    return PendingCommit(
        node=node, dev_mask=dev_mask, rs=1 if kind == 1 else -1,
        cpu=pod.cpu, mem=pod.mem, gpu_milli=pod.gpu_milli,
        cls=pod_affinity_class(pod),
        pod_write=num_pods if kind == 2 else idx,
        placed_val=(node if is_create else torch.full_like(node, -1)),
        mask_val=dev_mask if is_create else torch.zeros_like(dev_mask),
        failed_write=idx if is_create else num_pods,
        failed_val=node < 0,
    )


def apply_commit(state: NodeState, placed, masks, failed, p: PendingCommit):
    """Apply a PendingCommit's writes: the state at p.node (where >= 0),
    then placed/masks/failed, which carry one extra dummy row ([P]) for the
    skips' writes. Returns the new (state, placed, masks, failed)."""
    owns = p.node >= 0
    sel = p.node.clamp(min=0)
    oc = owns.to(torch.int32) * p.rs
    state = state._replace(
        cpu_left=_add_at(state.cpu_left, sel, oc * p.cpu),
        mem_left=_add_at(state.mem_left, sel, oc * p.mem),
        gpu_left=_add_at(state.gpu_left, sel,
                         oc * p.dev_mask.to(torch.int32) * p.gpu_milli),
        aff_cnt=(_add_at(state.aff_cnt, sel, _class_row(p.cls, -oc))
                 if p.cls >= 0 else state.aff_cnt),
    )
    placed, masks, failed = placed.clone(), masks.clone(), failed.clone()
    placed[p.pod_write] = p.placed_val
    masks[p.pod_write] = p.mask_val
    failed[p.failed_write] = p.failed_val
    return state, placed, masks, failed


def select_and_bind(state: NodeState, pod: PodSpec, feasible: torch.Tensor,
                    total: torch.Tensor, policy_dev: torch.Tensor,
                    gpu_sel: str, key,
                    tiebreak_rank: torch.Tensor
                    ) -> Tuple[NodeState, Placement]:
    """selectHost + Reserve + Bind on computed scores (packed_argmax, then
    bind_selected at the winner)."""
    node, _, ok = packed_argmax(total, feasible, tiebreak_rank)
    return bind_selected(state, pod, node, ok, _at(policy_dev, node),
                         gpu_sel, key)


def _score(state, pod, k_rand, policies, gpu_sel, tp, weights, rows: bool):
    feasible = filter_nodes(state, pod)
    ctx = ScoreContext(tp=tp, feasible=feasible, rng=k_rand)
    wts = resolve_weights(policies, weights)
    acc = None
    policy_share_dev = torch.full((state.num_nodes,), -1, dtype=torch.int32,
                                  device=feasible.device)
    raws, norms = [], []
    for (pol, _), w in zip(policies, wts):
        res = pol.scorer(state, pod, ctx)
        nrm = normalize(pol.normalize, res.raw_scores, feasible)
        if rows:
            raws.append(res.raw_scores)
            norms.append(nrm)
        # the i32 weighted sum, wrapping as XLA's int32 does
        term = nrm.to(torch.int64) * w
        acc = term if acc is None else acc + term
        if gpu_sel == pol.name and pol.name in SELF_SELECT_POLICIES:
            policy_share_dev = res.share_dev
    total = wrap_i32(acc)
    if not rows:
        return feasible, total, policy_share_dev
    return (feasible, total, policy_share_dev, torch.stack(raws),
            torch.stack(norms))


def score_pod_rows(state: NodeState, pod: PodSpec, k_rand,
                   policies: Sequence[Tuple[object, int]],
                   gpu_sel: str = "best", tp=None, weights=None):
    """score_pod with the per-policy rows kept: (feasible bool[N], total
    i32[N], policy_share_dev i32[N], raws i32[num_pol, N], norms
    i32[num_pol, N]), norms being what the weighted sum took. `policies`
    are (tpusim_torch.policies.Policy, weight) pairs; `weights` a weight
    row that replaces their weights (resolve_weights)."""
    return _score(state, pod, k_rand, policies, gpu_sel, tp, weights, True)


def score_pod(state: NodeState, pod: PodSpec, k_rand,
              policies: Sequence[Tuple[object, int]], gpu_sel: str = "best",
              tp=None, weights=None):
    """Filter + Score + Normalize for one pod, the half of the cycle before
    selectHost: (feasible bool[N], total i32[N] weighted scores,
    policy_share_dev i32[N], the selector policy's device picks or -1)."""
    return _score(state, pod, k_rand, policies, gpu_sel, tp, weights, False)


def schedule_one(state: NodeState, pod: PodSpec, key,
                 policies: Sequence[Tuple[object, int]],
                 gpu_sel: str = "best", tp=None, tiebreak_rank=None,
                 weights=None) -> Tuple[NodeState, Placement]:
    """One full scheduling cycle of `pod`, committed: the event's key
    splits into k_rand (the scores' draws) and k_sel (Reserve's random
    device). `tiebreak_rank` i32[N] is the run's fixed node permutation
    (the reference's random node-name prefixes, simulator.go:584-588);
    identity when None."""
    k_rand, k_sel = split(key)
    if tiebreak_rank is None:
        tiebreak_rank = torch.arange(state.num_nodes, dtype=torch.int32,
                                     device=state.cpu_left.device)
    feasible, total, policy_share_dev = score_pod(
        state, pod, k_rand, policies, gpu_sel, tp, weights)
    return select_and_bind(state, pod, feasible, total, policy_share_dev,
                           gpu_sel, k_sel, tiebreak_rank)


def unschedule(state: NodeState, pod: PodSpec,
               placement: Placement) -> NodeState:
    """Return a placed pod's resources to its node and recorded devices
    (deletePod, simulator.go:334-357; NodeResource.Add, resource.go:
    482-531); a no-op where placement.node is -1."""
    node = placement.node.clamp(min=0)
    pc = (placement.node >= 0).to(torch.int32)
    cls = pod_affinity_class(pod)
    return state._replace(
        cpu_left=_add_at(state.cpu_left, node, pod.cpu * pc),
        mem_left=_add_at(state.mem_left, node, pod.mem * pc),
        gpu_left=_add_at(state.gpu_left, node,
                         placement.dev_mask.to(torch.int32) * pc
                         * pod.gpu_milli),
        aff_cnt=(_add_at(state.aff_cnt, node, _class_row(cls, -pc))
                 if cls >= 0 else state.aff_cnt),
    )
