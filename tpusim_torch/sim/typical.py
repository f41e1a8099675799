"""Typical-pod extraction (counterpart of tpusim/sim/typical.py; ref:
pkg/utils/frag.go:285-380 GetTypicalPods).

Host-side; the result is a fixed [T] TypicalPods consumed by every frag
computation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from tpusim_torch.constants import (
    DEFAULT_TYPICAL_POD_INCREASE_STEP,
    DEFAULT_TYPICAL_POD_POPULARITY,
    MILLI,
    gpu_spec_to_mask,
)
from tpusim_torch.io.trace import PodRow
from tpusim_torch.types import TypicalPods, make_typical_pods


@dataclass
class TypicalPodsConfig:
    """ref: pkg/api/v1alpha1/types.go:104-109."""

    is_involved_cpu_pods: bool = True
    pod_popularity_threshold: int = 0  # 0 -> default 60
    pod_increase_step: int = 0  # 0 -> default 10
    gpu_res_weight: float = 0.0


class _neg_str(str):
    """Reverses string comparison for the descending GpuType tie-break."""

    def __lt__(self, other):  # noqa: D105
        return str.__gt__(self, other)


def get_typical_pods(
    pods: Sequence[PodRow], cfg: TypicalPodsConfig = TypicalPodsConfig(),
    device="cuda",
) -> Tuple[TypicalPods, List[Tuple[tuple, float]]]:
    """Histogram pod specs, keep the top specs covering the popularity
    threshold in increase-step batches, renormalize to sum(freq) = 1.

    Returns (TypicalPods, [(spec_key, freq)])."""
    counts: dict = {}
    total = 0.0
    for p in pods:
        if not cfg.is_involved_cpu_pods and p.num_gpu == 0:
            continue
        w = 1.0
        if cfg.gpu_res_weight > 0 and p.gpu_milli == MILLI:
            w = 1.0 + p.num_gpu * cfg.gpu_res_weight
        key = p.spec_key()
        counts[key] = counts.get(key, 0.0) + w
        total += w
    if not counts:
        return make_typical_pods([], device), []

    # descending count, ties by descending (cpu, milli, gpu_num, gpu_type)
    # (resource.go:18-42)
    def order(kv):
        cpu, milli, num, spec = kv[0]
        return (-kv[1], -cpu, -milli, -num, _neg_str(spec))

    ordered = sorted(counts.items(), key=order)
    threshold = cfg.pod_popularity_threshold or DEFAULT_TYPICAL_POD_POPULARITY
    step = cfg.pod_increase_step or DEFAULT_TYPICAL_POD_INCREASE_STEP
    expected = threshold * total / 100.0
    i, pod_res_num, cum = 0, 0, 0.0
    while cum < expected:
        pod_res_num += step
        while i < pod_res_num and i < len(ordered):
            cum += ordered[i][1]
            i += 1
        if pod_res_num >= len(ordered):
            break

    denom = cum if i < len(ordered) else total
    rows, info = [], []
    for key, cnt in ordered[:i]:
        cpu, milli, num, spec = key
        freq = cnt / denom
        rows.append((cpu, milli, num, gpu_spec_to_mask(spec), freq))
        info.append((key, freq))
    return make_typical_pods(rows, device), info


def get_skyline_pods(pods: Sequence[PodRow]) -> List[Tuple[int, int]]:
    """The Pareto skyline over (MilliCpu, MilliGpu) (frag.go:382-409):
    sort ascending by (cpu, milli), stable, then keep each point with
    strictly more CPU and strictly less GPU than the last one kept."""
    res = sorted(pods, key=lambda p: (p.cpu_milli, p.gpu_milli))
    skyline: List[Tuple[int, int]] = []
    for p in res:
        if not skyline or (
            p.cpu_milli > skyline[-1][0] and p.gpu_milli < skyline[-1][1]
        ):
            skyline.append((p.cpu_milli, p.gpu_milli))
    return skyline


def pad_typical_pods(tp: TypicalPods, multiple: int = 16) -> TypicalPods:
    """Pad the typical-pod axis with zero-frequency rows to a multiple of
    `multiple`. Such rows add nothing to any frag amount or score."""
    t = tp.size
    t2 = -(-max(t, 1) // multiple) * multiple
    if t2 == t:
        return tp
    pad = t2 - t
    return TypicalPods(*(
        torch.cat([a, a.new_zeros(pad)]) for a in tp
    ))
