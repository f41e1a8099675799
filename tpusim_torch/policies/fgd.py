"""FGD, Fragmentation Gradient Descent (counterpart of
tpusim/policies/fgd.py; ref: plugin/fgd_score.go).

score(node) = trunc(sigmoid((frag(node) - frag(node - pod)) / 1000) x 100)

For a share-GPU pod the hypothetical placement is tried on every fitting
device and the best per-device score wins, first device on ties
(fgd_score.go:111-134); for whole-GPU and CPU-only pods the placement is
NodeResource.Sub (fgd_score.go:137-148). The frag score decomposes as

    frag = sum_t freq_t x (isQ3_t ? total_left - fitsum_t : total_left)

so a per-device hypothetical perturbs only that device's fit terms.

`fgd_column` scores a batch of nodes against all pod types (the replays'
tables); `fgd_score`, the per-pod scorer of the sequential oracle, is the
column on the pod as the only type, held against the JAX package's per-pod
`fgd_score`.

Float order: every term inside the sum is an integer held exactly in
float32, so only the products freq_t x term_t round; the sum over t is
taken in index order (`tsum`), and the score applies the division by 1000
as a multiplication by float32(0.001), as XLA compiles the JAX package's
`/ 1000.0`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpusim_torch.constants import MAX_GPUS_PER_NODE, MAX_NODE_SCORE
from tpusim_torch.ops.resource import is_accessible, select_devices_packed
from tpusim_torch.policies.base import column_scorer
from tpusim_torch.types import NodeState, PodSpec, TypicalPods


def tsum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the last axis, one term at a time in index order."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for t in range(x.shape[-1]):
        acc = acc + x[..., t]
    return acc


def sigmoid_score(cur: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """trunc(sigmoid((cur - new) / 1000) x MaxNodeScore) -> int32
    (fgd_score.go:124), in float32."""
    milli = torch.tensor(0.001, dtype=torch.float32, device=cur.device)
    x = (cur - new) * milli
    s = torch.reciprocal(1.0 + torch.exp(-x))
    return torch.floor(s * float(MAX_NODE_SCORE)).to(torch.int32)


def frag_terms(cpu_left, gpu_left, gpu_type, tp: TypicalPods):
    """Per-(node, typical pod) terms [..., T] of the decomposition: fit
    [..., 8, T], fit count, fit sum (float32, exact), total, accessibility.
    """
    m = tp.gpu_milli
    fit = (gpu_left[..., None] >= m) & (m > 0)
    gf = gpu_left.to(torch.float32)
    fitcnt = fit.sum(-2, dtype=torch.int32)
    fitsum = torch.where(fit, gf[..., None], 0.0).sum(-2)
    total = gf.sum(-1)
    acc = is_accessible(gpu_type[..., None], tp.gpu_mask)
    return fit, fitcnt, fitsum, total, acc


def frag_score(cpu_left, gpu_left, gpu_type, tp: TypicalPods) -> torch.Tensor:
    """Node frag score (NodeGpuShareFragAmountScore) via the decomposition,
    float32 [...]."""
    _, fitcnt, fitsum, total, acc = frag_terms(cpu_left, gpu_left, gpu_type, tp)
    isq3 = ((tp.gpu_milli > 0) & acc & (fitcnt >= tp.gpu_num)
            & (cpu_left[..., None] >= tp.cpu))
    t = total[..., None]
    return tsum(tp.freq * torch.where(isq3, t - fitsum, t))


def fgd_column(nodes: NodeState, types: PodSpec, ks: int,
               tp: TypicalPods) -> Tuple[torch.Tensor, torch.Tensor]:
    """FGD raw score and FGD's share-device pick, i32[K, B] each, for a
    batch of B nodes against all K types (share types first, `ks` of them).
    The counterpart of pallas_engine._fgd_column, held against
    fgd_score."""
    g = nodes.gpu_left  # [B, 8]
    gf = g.to(torch.float32)
    cpu = nodes.cpu_left
    fit, fitcnt, fitsum, total, acc = frag_terms(cpu, g, nodes.gpu_type, tp)
    m, num = tp.gpu_milli, tp.gpu_num
    gpu_pod = m > 0
    isq3 = gpu_pod & acc & (fitcnt >= num) & (cpu[:, None] >= tp.cpu)
    # the current frag score's terms [B, T]; each branch sums them in index
    # order beside its hypotheticals', in one pass over the typical pods
    cur_t = tp.freq * torch.where(isq3, total[:, None] - fitsum,
                                  total[:, None])
    k = types.cpu.shape[0]
    score = torch.empty((k, g.shape[0]), dtype=torch.int32, device=g.device)
    sdev = torch.full_like(score, -1)

    if ks:  # share branch: best per-device hypothetical
        p = types.gpu_milli[:ks, None, None]  # [Ks, 1, 1]
        fitp = ((g - p)[..., None] >= m) & gpu_pod  # [Ks, B, 8, T]
        fitcnt_h = (fitcnt[:, None, :] - fit.to(torch.int32)
                    + fitp.to(torch.int32))
        fitsum_h = (fitsum[:, None, :] - torch.where(fit, gf[..., None], 0.0)
                    + torch.where(fitp, (gf - p)[..., None], 0.0))
        cpu_ok = (cpu - types.cpu[:ks, None])[..., None] >= tp.cpu  # [Ks,B,T]
        isq3_h = (gpu_pod & acc[:, None, :] & (fitcnt_h >= num)
                  & cpu_ok[:, :, None, :])
        total_h = (total - types.gpu_milli[:ks, None])[:, :, None, None]
        new_t = tp.freq * torch.where(isq3_h, total_h - fitsum_h, total_h)
        sums = tsum(torch.cat([cur_t.expand(ks, *cur_t.shape)[:, :, None],
                               new_t], 2))  # [Ks, B, 9]: current, devices
        dev_scores = torch.where(g >= p, sigmoid_score(sums[..., :1],
                                                       sums[..., 1:]), -1)
        best = dev_scores.max(-1).values  # [Ks, B]
        lane = torch.arange(MAX_GPUS_PER_NODE, device=g.device,
                            dtype=torch.int32)
        best_dev = torch.where(dev_scores == best[..., None], lane,
                               MAX_GPUS_PER_NODE).min(-1).values
        ok = best >= 0
        score[:ks] = torch.where(ok, best, 0)
        sdev[:ks] = torch.where(ok, best_dev, -1)

    if k - ks:  # whole-GPU / CPU-only branch: Sub hypothetical
        wm = types.gpu_milli[ks:, None]
        wn = types.gpu_num[ks:, None]
        take, _ = select_devices_packed(g[None], wm, wn)  # [Kw, B, 8]
        g2 = torch.where(wn[..., None] > 0,
                         g - take.to(torch.int32) * wm[..., None], g)
        g2f = g2.to(torch.float32)
        fit2 = (g2[..., None] >= m) & gpu_pod  # [Kw, B, 8, T]
        fitcnt2 = fit2.sum(-2, dtype=torch.int32)
        fitsum2 = torch.where(fit2, g2f[..., None], 0.0).sum(-2)
        total2 = g2f.sum(-1)[..., None]  # [Kw, B, 1]
        cpu_ok2 = (cpu - types.cpu[ks:, None])[..., None] >= tp.cpu
        isq3_2 = gpu_pod & acc & (fitcnt2 >= num) & cpu_ok2
        new_t = tp.freq * torch.where(isq3_2, total2 - fitsum2, total2)
        sums = tsum(torch.stack([cur_t.expand(k - ks, *cur_t.shape), new_t],
                                2))  # [Kw, B, 2]: current, after Sub
        score[ks:] = sigmoid_score(sums[..., 0], sums[..., 1])
    return score, sdev


# FGD raw scores i32[N] and FGD's own Reserve device pick i32[N] (-1 = none)
# of one pod on every node: (state, pod, ctx) -> PolicyResult
fgd_score = column_scorer(fgd_column)
