"""DotProduct, Tetris-style scoring (counterpart of tpusim/policies/dotprod.py
and the Pallas column _make_dotprod_column; ref: plugin/dot_product_score.go,
the virtual-resource expansion of pkg/type/resource.go:246-381).

score = trunc(100 x max over match slots of (1 - normalised dot product)).

Each dim-ext method is a fixed set of 9 slots per node, 8 devices and the
pool of idle GPUs:

  merge   one [cpu_left, total GPU left] vector per node
  share   one slot per partly used fitting device, plus the idle pool, for
          share-GPU pods; the node's CPU is shared by every slot
  divide  as share, with the CPU prorated by the slot's share of GPU left
  extend  partly used devices one by one plus the merged idle pool as
          groups; the dot averages over 1 + the number of groups

Norm methods divide both vectors by the node's capacity, the pod's request
or the largest machine (a divisor <= 0 zeroes the element); `pod`
squashes the dot with tanh(x / 10). A share pod that wins a device slot
takes that device; one that wins the pool takes the first idle device.

Float order follows the JAX package's compiled table build (`_dot`):
divisions by data stay IEEE divisions, `/ 10` is a multiplication by
float32(0.1), and tanh is XLA's float32 rational approximation
(`xla_tanh_f32`), not libm's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusim_torch.constants import (
    MAX_GPUS_PER_NODE,
    MAX_NODE_SCORE,
    MAX_SPEC_CPU,
    MAX_SPEC_GPU,
    MILLI,
)
from tpusim_torch.ops.f32 import fma_f32, recip_f32
from tpusim_torch.policies.base import column_scorer
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

DIM_EXT_METHODS = ("merge", "share", "divide", "extend")
NORM_METHODS = ("node", "pod", "max")

_NEG = float("-inf")
_R_TEN = recip_f32(10.0)
# norm=max folds both divisions of a product into one constant, r x r
_RR_CPU = float(np.float32(recip_f32(MAX_SPEC_CPU)) ** 2)
_RR_GPU = float(np.float32(recip_f32(MAX_SPEC_GPU)) ** 2)

# XLA's float32 tanh: x clamped to +-TANH_CLAMP, then x * P(x^2) / Q(x^2),
# each Horner step of P and Q one fused multiply-add; x itself where
# |x| < TANH_SMALL
TANH_CLAMP = 7.99881172180175781
TANH_SMALL = 0.0004
TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
            -8.60467152213735e-11, 5.12229709037114e-08,
            1.48572235717979e-05, 6.37261928875436e-04,
            4.89352455891786e-03)
TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
            2.26843463243900e-03, 4.89352518554385e-03)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """float32 a * b + c with one rounding: the product of two float32 is
    exact in float64, and the sum is rounded to float32 once."""
    c32 = float(np.float32(c))
    return (a.double() * b.double() + c32).float()


def xla_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """tanh of a float32 tensor, bit for bit as XLA computes it on the
    CPU."""
    xc = x.clamp(-TANH_CLAMP, TANH_CLAMP)
    x2 = xc * xc
    p = torch.full_like(xc, float(np.float32(TANH_NUM[0])))
    for c in TANH_NUM[1:]:
        p = _fma_f32(x2, p, c)
    q = torch.full_like(xc, float(np.float32(TANH_DEN[0])))
    for c in TANH_DEN[1:]:
        q = _fma_f32(x2, q, c)
    return torch.where(x.abs() < TANH_SMALL, x, (xc * p) / q)


def _safe_div(v, n):
    """v / n, 0 where n <= 0 (NormalizeVector, utils.go:1221-1244)."""
    return torch.where(n > 0, v / torch.where(n > 0, n, 1.0), 0.0)


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, a true division: the divisor is a tensor on x's device, since
    torch on the card multiplies by the reciprocal of a host scalar
    divisor."""
    return x / x.new_full((), c)


def _dot(dim_ext, norm, nodes, slot_cpu, slot_gpu, tcpu, treq):
    """slot_cpu x tcpu + slot_gpu x treq, each side normalised, with the
    roundings of the JAX package's compiled table build (XLA on the CPU,
    JAX 0.9): under norm=max the two divisions of a product fold into one
    constant, r x r, except under merge, which divides; one product of the
    sum is fused into it (which one, per method, follows the compiled
    code); under norm=pod both pod factors are exactly 1 or 0, so nothing
    rounds there."""
    if norm == "max":
        if dim_ext == "merge":
            return fma_f32(_div_const(slot_gpu, MAX_SPEC_GPU),
                           _div_const(treq, MAX_SPEC_GPU),
                           _div_const(slot_cpu, MAX_SPEC_CPU)
                           * _div_const(tcpu, MAX_SPEC_CPU))
        kc, kg = tcpu * _RR_CPU, treq * _RR_GPU
        if dim_ext == "divide":
            return fma_f32(slot_cpu, kc, slot_gpu * kg)
        return fma_f32(slot_gpu, kg, slot_cpu * kc)
    if norm == "node":
        div_cpu = nodes.cpu_cap.to(torch.float32)[None, :, None]
        div_gpu = (nodes.gpu_cnt * MILLI).to(torch.float32)[None, :, None]
    else:
        div_cpu, div_gpu = tcpu, treq
    a, b = _safe_div(slot_cpu, div_cpu), _safe_div(tcpu, div_cpu)
    c, d = _safe_div(slot_gpu, div_gpu), _safe_div(treq, div_gpu)
    if dim_ext in ("share", "divide"):
        return fma_f32(a, b, c * d)
    return fma_f32(c, d, a * b)


def make_dotprod_column(dim_ext: str, norm: str):
    """The DotProduct column function of one (dim_ext, norm) config:
    (nodes [B], types [K], ks, tp) -> (raw i32[K, B], share device
    i32[K, B]). Every slot quantity broadcasts to [K, B, S], S = 9 slots
    (1 under merge)."""
    if dim_ext not in DIM_EXT_METHODS:
        raise ValueError(f"dim_ext {dim_ext!r} not in {DIM_EXT_METHODS}")
    if norm not in NORM_METHODS:
        raise ValueError(f"norm {norm!r} not in {NORM_METHODS}")

    def column(nodes: NodeState, types: PodSpec, ks: int, tp: TypicalPods):
        g = nodes.gpu_left  # [B, 8]
        idle_cnt = (g == MILLI).sum(-1)  # [B]
        cpu_f = nodes.cpu_left.to(torch.float32)[None, :, None]  # [1, B, 1]
        tcpu = types.cpu.to(torch.float32)[:, None, None]  # [K, 1, 1]
        treq_i = (types.gpu_milli * types.gpu_num)[:, None, None]
        treq = treq_i.to(torch.float32)
        lane8 = torch.arange(MAX_GPUS_PER_NODE, device=g.device)
        if dim_ext == "merge":
            slot_cpu = cpu_f
            slot_gpu = g.sum(-1).to(torch.float32)[None, :, None]
            active = torch.ones((1, 1, 1), dtype=torch.bool, device=g.device)
        else:
            slot_real = lane8 < nodes.gpu_cnt[:, None]  # [B, 8]
            pool_gpu = (idle_cnt * MILLI).to(torch.float32)[:, None]
            slot_gpu = torch.cat([g.to(torch.float32), pool_gpu], -1)[None]
            if dim_ext == "extend":  # formalized groups (resource.go:217-287)
                dev_group = slot_real & (g > 0) & (g < MILLI)
                group = torch.cat([dev_group, (idle_cnt > 0)[:, None]], -1)
                n_groups = group.sum(-1).to(torch.float32)[None, :, None]
                active = group & (slot_gpu >= treq)
                slot_cpu = cpu_f
            else:  # partly used fitting devices (share pods only) + the pool
                dev_active = ((treq_i < MILLI) & slot_real & (g < MILLI)
                              & (g >= treq_i))  # [K, B, 8]
                pool_active = treq_i <= (idle_cnt * MILLI)[:, None]
                active = torch.cat([dev_active, pool_active], -1)
                slot_cpu = cpu_f
                if dim_ext == "divide":
                    gtot = g.sum(-1).to(torch.float32)[None, :, None]
                    slot_cpu = _safe_div(cpu_f * slot_gpu, gtot)
        dots = _dot(dim_ext, norm, nodes, slot_cpu, slot_gpu, tcpu, treq)
        if dim_ext == "extend":
            dots = dots / torch.clamp(1.0 + n_groups, min=1.0)
        else:
            dots = dots * 0.5
        if norm == "pod":
            dots = xla_tanh_f32(dots * _R_TEN)
        cpu_fits = (nodes.cpu_left >= types.cpu[:, None])[..., None]
        s = torch.where(cpu_fits & active, 1.0 - dots, _NEG)  # [K, B, S]
        best = s.max(-1).values
        if dim_ext == "merge":
            dev = torch.full(best.shape, -1, dtype=torch.int32,
                             device=g.device)
        else:
            lane9 = torch.arange(MAX_GPUS_PER_NODE + 1, device=g.device)
            slot = torch.where(s == best[..., None], lane9,
                               MAX_GPUS_PER_NODE + 1).min(-1).values
            first_free = torch.where(g == MILLI, lane8,
                                     MAX_GPUS_PER_NODE).min(-1).values
            first_free = torch.where(idle_cnt > 0, first_free, -1)
            dev = torch.where(slot < MAX_GPUS_PER_NODE, slot, first_free)
            dev = torch.where(best == _NEG, -1, dev).to(torch.int32)
        # trunc toward zero, as Go's int64() and XLA's convert
        none = best == _NEG
        raw = (float(MAX_NODE_SCORE) * torch.where(none, 0.0, best))
        return torch.where(none, 0, raw.to(torch.int32)).to(torch.int32), dev

    return column


def make_dotprod_score(dim_ext: str, norm: str):
    """The DotProduct per-pod scorer of one (dim_ext, norm) config:
    (state, pod, ctx) -> PolicyResult over every node."""
    return column_scorer(make_dotprod_column(dim_ext, norm))
