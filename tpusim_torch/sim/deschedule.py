"""Descheduling: evict pods to reduce fragmentation, then reschedule them
(counterpart of tpusim/sim/deschedule.py; ref: pkg/simulator/deschedule.go
and deschedule_utils.go).

Three policies (deschedule.go:14-18):
- cosSim:       on congested nodes (cpu_left < 2000, some device with more
                than 500 milli free), evict the pod whose removal leaves the
                node's free vector least similar to the pod's request
                (deschedule_utils.go:15-45).
- fragOnePod:   walk the nodes in descending frag order and evict the one
                pod whose removal lowers the node's frag the most, if it
                lowers it (deschedule.go:94-119).
- fragMultiPod: the same victim rule over a max-heap of node frags, so a
                node comes back with its victim's frag as its new priority
                (deschedule.go:121-178).

Every candidate score (the node's frag and the cosine similarity after
evicting each placed pod) is computed once, for all pods at once, on the
state's device (`eviction_scores`): the reference scores against the state
at entry and never refreshes it during the eviction loop (deschedule.go:24
against :111, :160), so the scores are functions of that state. The host
walk over them (`select_victims`) is a copy of the reference's.

The victims are picked with strict comparisons and an integer truncation
of float32 scores, so the scores follow the float32 order of the JAX
package's compiled CPU code bit for bit (`eviction_scores` says how).
"""

from __future__ import annotations

import heapq
import math
from typing import List, Sequence

import numpy as np
import torch

from tpusim_torch.constants import NUM_AFF_CLASSES, Q3_SATISFIED
from tpusim_torch.ops.f32 import fma_f32
from tpusim_torch.ops.frag import (
    node_frag_contrib,
    pod_stages,
    tree_sum,
    vector_sum,
)
from tpusim_torch.policies.clustering import affinity_class
from tpusim_torch.sim.fetch import device_fetch
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

COS_SIM_CPU_BAR = 2000  # deschedule.go:52-53, "temporarily hard-code"
COS_SIM_GPU_BAR = 500

# XLA's tree reduction window (tpusim_torch.ops.frag)
_WINDOW = 32


def frag_scores(cpu_left, gpu_left, gpu_type, tp: TypicalPods) -> torch.Tensor:
    """The frag score f32[B] of a batch of B nodes (every class but Q3,
    NodeGpuShareFragAmountScore) in the order of the reference's compiled
    `eviction_scores`. XLA merges the sum over the typical pods and the sum
    over the classes into one reduction over both, and subtracts Q3's row,
    a reduction of its own:

    - T <= 32: the total one (pod, class) pair after the other; Q3's row
      in 8 lanes over the first (T - 1) // 8 * 8 pods, the rest in turn
      (`pod_stages`);
    - T > 32, a multiple of 32: each window of 32 pods in 4 lanes, lane k
      adding pods k, k + 4, ... with their classes in turn, the windows in
      turn; Q3's row in the tree's windows;
    - else (the pod axis padded to windows of 32): both in the tree's
      windows (`tree_sum`).

    Read from the optimised LLVM IR and held bit for bit on T = 16 to 128
    (the typical pods are padded to a multiple of 16)."""
    c = node_frag_contrib(cpu_left, gpu_left, gpu_type, tp)  # [B, T, 7]
    t = c.shape[1]
    x = c.permute(1, 2, 0)  # [T, 7, B]
    q3 = c[:, :, Q3_SATISFIED].T  # [T, B]
    if t <= _WINDOW:
        total = vector_sum(x.reshape(t * x.shape[1], -1), [])
        q3 = vector_sum(q3, pod_stages(2, t))
    elif t % _WINDOW == 0:
        total = None
        for w in range(0, t, _WINDOW):
            part = vector_sum(x[w:w + _WINDOW], [(4, 1, _WINDOW)], rows=True)
            total = part if total is None else total + part
        q3 = tree_sum(q3, 1)
    else:
        total = tree_sum(x, 2)
        q3 = tree_sum(q3, 1)
    return total - q3


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _norm2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.norm of the 2-vectors (a, b) as compiled: the squares
    summed with the second contracted into an FMA, then a correctly
    rounded square root (taken in float64, whose rounding to float32 is
    the float32 root's)."""
    return _f32(torch.sqrt(fma_f32(b, b, a * a).double()))


def eviction_scores(state: NodeState, pods: PodSpec, placed, dev_mask,
                    tp: TypicalPods):
    """The candidate scores of every placed pod, on the state's device.

    Returns (new_frag f32[P], cos_sim f32[P], old_frag f32[N]):
    - new_frag[p]: the frag score of pod p's node after evicting p
      (nodeRes.Add(podRes) then NodeGpuShareFragAmount,
      deschedule_utils.go:86-92);
    - cos_sim[p]: the cosine similarity of the node's free vector after the
      eviction, [cpu_left, total gpu_left], with p's request
      (GetResourceSimilarity, utils.go:1181-1212), clipped to [0, 1]
      within 1e-3 of it, else -1, and -1 where undefined;
    - old_frag[n]: every node's frag score now (the heap's priorities).

    Unplaced pods are scored against node 0 and never read. The float32
    orders are those of the reference's compiled function: `frag_scores`;
    the dot product and each norm's sum of squares with the second product
    contracted into an FMA; the products, roots and quotient rounded once
    each (computed in float64, which rounds each to float32 exactly as a
    float32 operation would)."""
    dev = state.cpu_left.device
    placed = torch.as_tensor(np.asarray(placed), device=dev)
    dev_mask = torch.as_tensor(np.asarray(dev_mask), device=dev)
    n = torch.clamp(placed, min=0).long()
    cpu_left = state.cpu_left[n] + pods.cpu
    gpu_left = state.gpu_left[n] + dev_mask.to(torch.int32) * pods.gpu_milli[:, None]
    new_frag = frag_scores(cpu_left, gpu_left, state.gpu_type[n], tp)
    old_frag = frag_scores(state.cpu_left, state.gpu_left, state.gpu_type, tp)

    f0, f1 = _f32(cpu_left), _f32(gpu_left.sum(-1))
    r0, r1 = _f32(pods.cpu), _f32(pods.gpu_milli * pods.gpu_num)
    denom = _f32(_norm2(f0, f1).double() * _norm2(r0, r1).double())
    dot = fma_f32(f1, r1, f0 * r0)
    minus_one = torch.full_like(denom, -1.0)
    sim = torch.where(denom > 0, _f32(dot.double() / denom.double()),
                      minus_one)
    lo = torch.tensor(np.float32(-1e-3), device=dev)
    hi = torch.tensor(np.float32(1 + 1e-3), device=dev)
    sim = torch.where((sim >= lo) & (sim <= hi), sim.clamp(0.0, 1.0),
                      minus_one)
    return new_frag, sim, old_frag


def _pods_by_node(placed: np.ndarray, num_nodes: int) -> List[List[int]]:
    by_node: List[List[int]] = [[] for _ in range(num_nodes)]
    for i, n in enumerate(placed):
        if n >= 0:
            by_node[n].append(i)
    return by_node


def select_victims(state: NodeState, pods: PodSpec, placed: np.ndarray,
                   dev_mask: np.ndarray, tp: TypicalPods, policy: str,
                   ratio: float, node_names: Sequence[str] = None) -> List[int]:
    """The pods to deschedule, in eviction order (DescheduleCluster,
    deschedule.go:20-47; budget = ceil(ratio x pods placed),
    deschedule.go:27). The scores are computed on the state's device and
    fetched once; the walk over them runs on the host."""
    placed = np.asarray(placed)
    dev_mask = np.asarray(dev_mask)
    n_pods_placed = int((placed >= 0).sum())
    budget = math.ceil(ratio * n_pods_placed)
    if budget <= 0 or n_pods_placed == 0:
        return []
    scores = device_fetch(eviction_scores(state, pods, placed, dev_mask, tp))
    new_frag, cos_sim, old_frag = (x.numpy() for x in scores)
    num_nodes = state.num_nodes
    by_node = _pods_by_node(placed, num_nodes)
    names = node_names or [f"node-{i:05d}" for i in range(num_nodes)]

    if policy == "cosSim":
        s = device_fetch(state)
        return _victims_cos_sim(s.cpu_left.numpy(), s.gpu_left.numpy(),
                                by_node, cos_sim, names, budget)
    if policy == "fragOnePod":
        return _victims_frag_one(by_node, new_frag, old_frag, budget)
    if policy == "fragMultiPod":
        return _victims_frag_multi(by_node, new_frag, old_frag, names, budget)
    raise ValueError(f"DeschedulePolicy not found: {policy!r}")


def _victims_cos_sim(cpu_left, gpu_left, by_node, cos_sim, names,
                     budget) -> List[int]:
    """deschedule.go:49-92: the congested-node walk, the least similar
    victim a node."""
    total_gpu_left = gpu_left.sum(-1)
    below = cpu_left < COS_SIM_CPU_BAR
    # stable partition: below-bar nodes first, each group by total GPU left
    # descending then name (sortNodeStatusByResource,
    # deschedule_utils.go:47-71)
    order = sorted(
        range(len(names)),
        key=lambda i: (~below[i], -total_gpu_left[i], names[i]))
    victims: List[int] = []
    for n in order:
        if len(victims) >= budget:
            break
        if cpu_left[n] >= COS_SIM_CPU_BAR:
            continue
        if not (gpu_left[n] > COS_SIM_GPU_BAR).any():
            continue
        best, best_sim = -1, 1.0  # strictly below 1 (deschedule_utils.go:17,34)
        for p in by_node[n]:
            if 0 <= cos_sim[p] < best_sim:
                best, best_sim = p, cos_sim[p]
        if best >= 0:
            victims.append(best)
    return victims


def _victims_frag_one(by_node, new_frag, old_frag, budget) -> List[int]:
    """deschedule.go:94-119: one victim a node, descending frag order."""
    order = np.argsort(-old_frag, kind="stable")
    victims: List[int] = []
    for n in order:
        if len(victims) >= budget:
            break
        best, best_score = -1, 0  # strictly positive (deschedule_utils.go:75,93)
        for p in by_node[n]:
            score = int(old_frag[n] - new_frag[p])  # int64 truncation, :92
            if score > best_score:
                best, best_score = p, score
        if best >= 0:
            victims.append(best)
    return victims


def _victims_frag_multi(by_node, new_frag, old_frag, names,
                        budget) -> List[int]:
    """deschedule.go:121-178: a max-heap over node frag; a node re-enters
    the heap with its victim's frag after the eviction as its priority.
    Scores stay those of the entry state (the reference's stale
    nodeResMap)."""
    heap = [(-old_frag[n], names[n], n) for n in range(len(by_node))]
    heapq.heapify(heap)
    remaining = [list(ps) for ps in by_node]
    victims: List[int] = []
    while len(victims) < budget and heap:
        neg_pri, name, n = heapq.heappop(heap)
        pri = -neg_pri
        best, best_score = -1, 0
        for p in remaining[n]:
            score = int(pri - new_frag[p])
            if score > best_score:
                best, best_score = p, score
        if best >= 0:
            victims.append(best)
            remaining[n].remove(best)
            heapq.heappush(heap, (-float(new_frag[best]), name, n))
    return victims


def evict(state: NodeState, pods: PodSpec, placed, dev_mask,
          victims: Sequence[int]) -> NodeState:
    """Return every victim's resources at once (deletePod per victim,
    simulator.go:334-357): one scatter-add a field on the state's device.
    `state` is left as it was."""
    if len(victims) == 0:
        return state
    dev = state.cpu_left.device
    v = torch.as_tensor(np.asarray(victims, np.int64), device=dev)
    placed = torch.as_tensor(np.asarray(placed), device=dev)
    dev_mask = torch.as_tensor(np.asarray(dev_mask), device=dev)
    nodes = placed[v].long()
    vp = PodSpec(*(a[v] for a in pods))
    cls = affinity_class(vp)
    # a class past the 9 counted ones (more than 8 GPUs) has no counter
    has = (cls >= 0) & (cls < NUM_AFF_CLASSES)
    return state._replace(
        cpu_left=state.cpu_left.index_add(0, nodes, vp.cpu),
        mem_left=state.mem_left.index_add(0, nodes, vp.mem),
        gpu_left=state.gpu_left.index_add(
            0, nodes, dev_mask[v].to(torch.int32) * vp.gpu_milli[:, None]),
        aff_cnt=state.aff_cnt.index_put(
            (nodes[has], cls[has].long()),
            torch.full_like(cls[has], -1), accumulate=True),
    )
