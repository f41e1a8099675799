"""Fragmentation math: the per-(node, typical pod) class, the per-node
frag amounts, the cluster report and the Bellman value function
(counterpart of tpusim/ops/frag.py; ref: pkg/utils/frag.go:148-283,
:411-425, :460-493).

The amounts are float32 sums over the typical pods (and, for the cluster,
over the nodes), and the printed reports show enough digits for the order
of those sums to matter. Every sum here names its order. The reference's
CPU build sums in XLA's tree order (`tree_sum`): `node_frag_rows` and
`tree_sum` follow it on any device, and `cluster_frag_report` follows it
on the host, whatever device the state lives on. Where no reduced axis is
longer than 32, XLA keeps a reduction whole and LLVM vectorises its loop;
`vector_sum` follows such a loop, `row_stages`, `pod_stages` and
`node_stages` say which loops the report's sums become.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusim_torch.constants import (
    NO_ACCESS,
    NUM_FRAG_CLASSES,
    Q1_LACK_BOTH,
    Q2_LACK_GPU,
    Q3_SATISFIED,
    Q4_LACK_CPU,
    XL_SATISFIED,
    XR_LACK_CPU,
)
from tpusim_torch.ops.resource import (
    can_host_on_gpu,
    gpu_frag_milli,
    is_accessible,
)
from tpusim_torch.types import NodeState, TypicalPods

# window of the tree sum along each reduced axis
_TREE_WINDOW = 32


def frag_class(cpu_left, gpu_left, gpu_type, tp: TypicalPods):
    """How each typical pod sees each node: i32[N, T] class ids
    (GetNodePodFrag). The decision order is the reference's: a pod without
    GPUs is XL/XR, a node of a model the pod cannot use is NA, a node that
    can host the pod's GPUs is Q3/Q4 by CPU, else Q2/Q1 by CPU."""
    cpu_ok = cpu_left[:, None] >= tp.cpu  # [N, T]
    acc = is_accessible(gpu_type[:, None], tp.gpu_mask)
    can_host = can_host_on_gpu(gpu_left[:, None, :], tp.gpu_milli,
                               tp.gpu_num)
    return torch.where(
        tp.gpu_milli == 0,
        torch.where(cpu_ok, XL_SATISFIED, XR_LACK_CPU),
        torch.where(
            ~acc, NO_ACCESS,
            torch.where(
                can_host,
                torch.where(cpu_ok, Q3_SATISFIED, Q4_LACK_CPU),
                torch.where(cpu_ok, Q2_LACK_GPU, Q1_LACK_BOTH),
            ),
        ),
    ).to(torch.int32)


def node_frag_contrib(cpu_left, gpu_left, gpu_type,
                      tp: TypicalPods) -> torch.Tensor:
    """Per-(node, typical pod, class) frag contributions f32[N, T, 7]
    (GetNodePodFrag + NodeGpuShareFragAmount). A typical pod the node
    satisfies (Q3) splits the node's idle milli: devices individually too
    small for it count as Q2, the rest stays Q3; every other class takes
    freq x idle milli."""
    freq = tp.freq[:, None]  # [T, 1]
    total = gpu_left.sum(-1).to(torch.float32)[:, None, None]  # [N, 1, 1]
    cls = frag_class(cpu_left, gpu_left, gpu_type, tp)
    small = gpu_frag_milli(gpu_left[:, None, :], tp.gpu_milli)
    small = small.to(torch.float32)[..., None]  # [N, T, 1]
    classes = torch.arange(NUM_FRAG_CLASSES, device=cpu_left.device)
    base = torch.where(cls[..., None] == classes, freq * total, 0.0)
    q3 = torch.where(classes == Q2_LACK_GPU, freq * small,
                     torch.where(classes == Q3_SATISFIED,
                                 freq * (total - small), 0.0))
    return torch.where((cls == Q3_SATISFIED)[..., None], q3, base)


def node_frag_amounts(cpu_left, gpu_left, gpu_type,
                      tp: TypicalPods) -> torch.Tensor:
    """Per-class frag amounts f32[N, 7] of a batch of nodes, summed over the
    typical pods in index order: the order of the CUDA kernels' FGD sums,
    not the reference's report order (`node_frag_rows` is that)."""
    contrib = node_frag_contrib(cpu_left, gpu_left, gpu_type, tp)
    out = torch.zeros_like(contrib[:, 0])
    for t in range(tp.size):
        out = out + contrib[:, t]
    return out


def tree_sum(x: torch.Tensor, axes: int, lanes: bool = False) -> torch.Tensor:
    """float32 sum over the leading `axes` axes of `x`, in the order of
    the reference's CPU build (XLA's tree reduction), on x's device: the
    order of `_tree_sum` below, with the same padding, windows of 32 and
    row-major order, each step an explicit elementwise add (a torch
    reduction picks its own order on each device). With `lanes`, a sum
    over one axis at most 32 long follows `row_stages` instead: XLA then
    keeps the reduction whole and, where it is fused into the loop that
    computes `x`, LLVM vectorises it."""
    x = x.to(torch.float32)
    rest = list(x.shape[axes:])
    if lanes and axes == 1 and x.shape[0] <= _TREE_WINDOW:
        return vector_sum(x, row_stages(x.shape[0]))
    while any(x.shape[a] > _TREE_WINDOW for a in range(axes)):
        win = [min(x.shape[a], _TREE_WINDOW) for a in range(axes)]
        for a, w in enumerate(win):
            pad = -x.shape[a] % w
            if pad:
                shape = list(x.shape)
                lo, hi = list(shape), list(shape)
                lo[a], hi[a] = pad // 2, pad - pad // 2
                x = torch.cat([x.new_zeros(lo), x, x.new_zeros(hi)], a)
        outs = [x.shape[a] // w for a, w in enumerate(win)]
        split = [d for o, w in zip(outs, win) for d in (o, w)]
        order = ([2 * a for a in range(axes)] + [2 * a + 1 for a in range(axes)]
                 + list(range(2 * axes, 2 * axes + len(rest))))
        y = x.reshape(split + rest).permute(order)
        y = y.reshape(outs + [int(np.prod(win))] + rest)
        acc = x.new_zeros(outs + rest)
        for i in range(y.shape[axes]):
            acc = acc + y[(slice(None),) * axes + (i,)]
        x = acc
    acc = x.new_zeros(rest)
    for row in x.reshape([-1] + rest):
        acc = acc + row
    return acc


def vector_sum(x: torch.Tensor, stages, seed=None,
               rows: bool = False) -> torch.Tensor:
    """float32 sum over dim 0 in the order of a reduction loop that LLVM
    vectorised for XLA's CPU build. Each stage (vf, uf, m) is one vector
    loop over the next m elements (zeros past the end of `x`: the loop's
    masked lanes): uf accumulators of vf lanes, the running sum (`seed`,
    else 0) in lane 0 of the first; part p's lane k adds the elements
    k + p vf, k + p vf + uf vf, ... of the stage in turn. The parts are
    added in order, the lanes folded in halves (lanes k and k + vf/2, then
    k and k + vf/4, ...), and lane 0 carries the sum into the next stage.
    The elements left after the last stage are added one by one. With
    `rows`, each element is a row x[i] whose entries along dim 1 are added
    one by one (a loop vectorised over the rows of a two-axis sum)."""
    x = x.to(torch.float32)
    rest = tuple(x.shape[2:] if rows else x.shape[1:])

    def add(acc, elem):
        if not rows:
            return acc + elem
        axis = elem.dim() - len(rest) - 1  # the entries of a row
        for j in range(elem.shape[axis]):
            acc = acc + elem.select(axis, j)
        return acc

    acc = x.new_zeros(rest) if seed is None else seed
    off = 0
    for vf, uf, m in stages:
        seg = x[off:off + m]
        if seg.shape[0] < m:
            seg = torch.cat([seg, seg.new_zeros((m - seg.shape[0],)
                                                + tuple(seg.shape[1:]))])
        parts = []
        for p in range(uf):
            lanes = x.new_zeros((vf,) + rest)
            if p == 0:
                lanes[0] = acc
            for j in range(m // (vf * uf)):
                b = (j * uf + p) * vf
                lanes = add(lanes, seg[b:b + vf])
            parts.append(lanes)
        lanes = parts[0]
        for part in parts[1:]:
            lanes = part + lanes
        while lanes.shape[0] > 1:
            h = lanes.shape[0] // 2
            lanes = lanes[:h] + lanes[h:]
        acc = lanes[0]
        off += m
    for i in range(off, x.shape[0]):
        acc = add(acc, x[i])
    return acc


def row_stages(t: int):
    """The vector loops of XLA's CPU build for a sum over `t` <= 32 typical
    pods fused into the loop that computes them (a frag row of the per-event
    report), read from its optimised LLVM IR: none up to 9 (the loop is
    unrolled, each pod added in turn); 8 lanes in 2 parts over 16 pods
    (masked when fewer) from 10; then a 4-lane epilogue over 4 more from 20;
    8 lanes in 1 part over 24 from 24; 8 lanes in 2 parts over all 32 at
    32. Pods past the stages are added one by one."""
    if t <= 9:
        return []
    if t <= 19:
        return [(8, 2, 16)]
    if t <= 23:
        return [(8, 2, 16), (4, 1, 4)]
    if t <= 31:
        return [(8, 1, 24)]
    return [(8, 2, 32)]


def pod_stages(n: int, t: int):
    """The vector loops of XLA's CPU build over one node's t <= 32 typical
    pods, in the report's sums over a cluster of n <= 32 nodes (its initial
    per-node rows, and its initial total node by node): `row_stages` at
    n = 1, where the node's row is the only one; each pod in turn up to
    t = 15; else 8 lanes over the first 8 (t - 1) // 8 pods, the rest in
    turn."""
    if n == 1:
        return row_stages(t)
    if t <= 15:
        return []
    return [(8, 1, (t - 1) // 8 * 8)]


def node_stages(n: int, t: int):
    """How XLA's CPU build sums the initial [n, t, 7] contributions of
    n <= 32 nodes and 2 <= t <= 32 typical pods into the cluster's frag
    amounts, read from the optimised LLVM IR of the fused reduction (the
    classes outermost, then the nodes, then the typical pods) and
    confirmed bit for bit on every such shape. ("nodes", stages): the loop
    is vectorised over the nodes (t at most 10 and n 4, 8 or 16 and more),
    each lane adding its nodes' pods in turn: 8 lanes, or 4 at n = 4, at
    n = 20-23, and at n = 28-31 when t is 7 or 8. ("pods", stages): node by
    node, the running total seeded into `pod_stages`."""
    if n > 1 and t <= 10 and (n in (4, 8) or n >= 16):
        vf = 4 if (n == 4 or 20 <= n <= 23
                   or (t in (7, 8) and 28 <= n <= 31)) else 8
        return "nodes", [(vf, 1, n // vf * vf)]
    return "pods", pod_stages(n, t)


def initial_rows(contrib: torch.Tensor) -> torch.Tensor:
    """The per-node frag amounts f32[N, 7] of the initial [N, T, 7]
    contributions in the reference's order: `tree_sum` once an axis is
    longer than 32, else `pod_stages`."""
    n, t = contrib.shape[:2]
    x = contrib.movedim(1, 0)
    if n > _TREE_WINDOW or t > _TREE_WINDOW:
        return tree_sum(x, 1)
    return vector_sum(x, pod_stages(n, t))


def initial_total(contrib: torch.Tensor) -> torch.Tensor:
    """The cluster's frag amounts f32[7] of the [N, T, 7] contributions in
    the reference's order: one tree sum over nodes and typical pods
    (`tree_sum`) once an axis is longer than 32, else the vectorised order
    `node_stages` names. A single typical pod (t = 1) is summed node by
    node, as XLA does up to 15 nodes; from 16 nodes XLA's loop for it
    branches on the pod's fields. Such a distribution has frequency 1, so
    its contributions are whole milli values, whose float32 sum is exact
    in any order."""
    n, t = contrib.shape[:2]
    if n > _TREE_WINDOW or t > _TREE_WINDOW:
        return tree_sum(contrib, 2)
    if t == 1 and n > 1:
        return vector_sum(contrib[:, 0], [])
    kind, stages = node_stages(n, t)
    if kind == "nodes":
        return vector_sum(contrib, stages, rows=True)
    acc = None
    for row in contrib.to(torch.float32):
        acc = vector_sum(row, stages, seed=acc)
    return acc


def node_frag_rows(cpu_left, gpu_left, gpu_type,
                   tp: TypicalPods) -> torch.Tensor:
    """Per-class frag amounts f32[N, 7] of a batch of nodes, summed over the
    typical pods in the reference's order (`tree_sum`): the rows of its
    per-event report (node_frag_amounts under jax.vmap)."""
    contrib = node_frag_contrib(cpu_left, gpu_left, gpu_type, tp)
    return tree_sum(contrib.movedim(1, 0), 1)


def frag_sum_except_q3(amounts: torch.Tensor) -> torch.Tensor:
    """Sum of every class but Q3 over the last axis (FragAmountSumExceptQ3,
    frag.go:411-418): the seven in class order, then minus Q3."""
    return tree_sum(amounts.movedim(-1, 0), 1) - amounts[..., Q3_SATISFIED]


def frag_sum_q1q2q4(amounts: torch.Tensor) -> torch.Tensor:
    """FragAmountSumQ1Q2Q4 (frag.go:420-425)."""
    return (amounts[..., Q1_LACK_BOTH] + amounts[..., Q2_LACK_GPU]
            + amounts[..., Q4_LACK_CPU])


def node_frag_score(cpu_left, gpu_left, gpu_type,
                    tp: TypicalPods) -> torch.Tensor:
    """Scalar frag score per node, every class but Q3
    (NodeGpuShareFragAmountScore, frag.go:200-203)."""
    return frag_sum_except_q3(node_frag_rows(cpu_left, gpu_left, gpu_type,
                                             tp))


def _tree_sum(x: np.ndarray, axes: int) -> np.ndarray:
    """float32 sum over the leading `axes` axes of `x`, in the order of the
    reference's CPU build (XLA's tree reduction): while a reduced axis is
    longer than 32, pad it with zeros to a multiple of 32 (half the padding
    before, the rest after) and sum windows of 32 along it (a shorter axis
    is one window), each window in row-major order; then sum what is left in
    row-major order. Zero padding changes no float32 sum."""
    x = np.asarray(x, np.float32)
    while any(x.shape[a] > _TREE_WINDOW for a in range(axes)):
        win = [min(x.shape[a], _TREE_WINDOW) for a in range(axes)]
        pads = [(p // 2, p - p // 2) for p in
                (-x.shape[a] % w for a, w in enumerate(win))]
        x = np.pad(x, pads + [(0, 0)] * (x.ndim - axes))
        outs = [x.shape[a] // w for a, w in enumerate(win)]
        rest = list(x.shape[axes:])
        split = [d for o, w in zip(outs, win) for d in (o, w)]
        order = ([2 * a for a in range(axes)] + [2 * a + 1 for a in range(axes)]
                 + list(range(2 * axes, 2 * axes + len(rest))))
        y = x.reshape(split + rest).transpose(order)
        y = y.reshape(outs + [int(np.prod(win))] + rest)
        acc = np.zeros(outs + rest, np.float32)
        for i in range(y.shape[axes]):
            acc += y[(slice(None),) * axes + (i,)]
        x = acc
    acc = np.zeros(x.shape[axes:], np.float32)
    for row in x.reshape((-1,) + x.shape[axes:]):
        acc += row
    return acc


def cluster_frag_report(state: NodeState, tp: TypicalPods):
    """Cluster-level frag aggregate (ClusterGpuFragReport): returns
    (amounts f32[7] as numpy, frag_gpu_milli, frag_ratio_pct,
    q124_ratio_pct). The amounts are bit-equal to the reference's; the idle
    total behind the other three is the sum of the seven amounts in class
    order, as the Cluster Analysis block takes it, where the reference sums
    all N x T x 7 contributions at once, so those three may differ from its
    in the last float32 bits."""
    contrib = node_frag_contrib(state.cpu_left, state.gpu_left,
                                state.gpu_type, tp).cpu().numpy()
    amounts = _tree_sum(contrib, 2)
    idle = np.float32(0.0)
    for v in amounts:
        idle += v
    frag = idle - amounts[Q3_SATISFIED]
    q124 = amounts[Q1_LACK_BOTH] + amounts[Q2_LACK_GPU] + amounts[Q4_LACK_CPU]
    with np.errstate(divide="ignore", invalid="ignore"):  # no idle GPU: nan
        return amounts, frag, 100.0 * frag / idle, 100.0 * q124 / idle


def node_frag_bellman(node, typical, max_depth: int = 64, memo=None,
                      stats=None) -> float:
    """Bellman expected-frag value of one node, on the host
    (NodeGpuFragBellman, frag.go:231-283). The port's C++ evaluator
    (tpusim_torch/native) computes the same recursion; this is its oracle.

    `node` is (cpu_left, gpu_left sequence, gpu_type); `typical` a list of
    (cpu, gpu_milli, gpu_num, gpu_mask, freq) tuples. Pass a dict as `memo`
    to share the cache of flattened states across calls (the reference's
    per-run fragMemo), and one as `stats` to collect {"truncations",
    "max_depth_seen"}: the reference has no depth limit, so `max_depth` is
    a guard that real traces must never reach. The device vector is kept
    sorted descending (the value does not depend on device order, as the
    reference's Flatten key says), fit counts per distinct milli are taken
    once a state, and Sub takes the least free fitting devices.
    """
    memo = {} if memo is None else memo
    t_arr = list(typical)
    millis = sorted({t[1] for t in t_arr if t[1] > 0})

    def rec(cpu_left, g, gpu_type, cum_prob, depth):
        # a memo hit comes before the cum_prob cutoff (frag.go:233-239)
        key = (cpu_left, g, gpu_type)
        v = memo.get(key)
        if v is not None:
            return v
        total = sum(g)
        if total == 0 or total * cum_prob < 1:
            return 0.0
        # g is sorted descending: the devices >= m are a prefix
        nfit = {}
        i = len(g)
        for m in millis:
            while i > 0 and g[i - 1] < m:
                i -= 1
            nfit[m] = i
        node_bit = (1 << gpu_type) if gpu_type >= 0 else 0

        ratio_except_q3 = 0.0
        for cpu, milli, num, mask, p in t_arr:
            if (milli == 0 or (mask != 0 and not (mask & node_bit))
                    or nfit[milli] < num or cpu_left < cpu):
                ratio_except_q3 += p
        if stats is not None and depth > stats.get("max_depth_seen", 0):
            stats["max_depth_seen"] = depth
        if depth >= max_depth:
            # not memoised: the cut value would stand for shallower visits
            if stats is not None:
                stats["truncations"] = stats.get("truncations", 0) + 1
            return float(total)
        if ratio_except_q3 < 0.999:
            pv = 0.0
            for cpu, milli, num, mask, p in t_arr:
                if p == 0.0:  # padding rows of frequency 0 add nothing
                    continue
                if cpu_left < cpu or len(g) < num:
                    pv += total * p
                    continue
                if num == 0 or milli == 0:
                    pv += p * rec(cpu_left - cpu, g, gpu_type, cum_prob * p,
                                  depth + 1)
                    continue
                j = nfit[milli]  # the fitting devices are g[0..j)
                if j < num:
                    pv += total * p
                    continue
                taken = [x - milli for x in g[j - num:j]]
                rest = list(g[:j - num]) + list(g[j:])
                g2 = tuple(sorted(rest + taken, reverse=True))
                pv += p * rec(cpu_left - cpu, g2, gpu_type, cum_prob * p,
                              depth + 1)
            frag = pv
        else:
            frag = float(total)
        memo[key] = frag
        return frag

    cpu_left, gpu_left, gpu_type = node
    return rec(int(cpu_left),
               tuple(sorted((int(x) for x in gpu_left), reverse=True)),
               int(gpu_type), 1.0, 0)
