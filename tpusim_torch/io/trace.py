"""openb trace ingestion: CSV -> tensors (counterpart of tpusim/io/trace.py).

Node CSV schema: sn, cpu_milli, memory_mib, gpu, model.
Pod CSV schema: name, cpu_milli, memory_mib, num_gpu, gpu_milli, gpu_spec,
qos, pod_phase, creation_time, deletion_time, scheduled_time.

gpu_milli is clamped to (0, 1000] and only kept when num_gpu > 0.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusim_torch.constants import (
    CPU_MODEL_IDS,
    MAX_GPUS_PER_NODE,
    NO_GPU,
    gpu_spec_to_mask,
    register_gpu_model,
)
from tpusim_torch.sim.engine import EV_CREATE, EV_DELETE, EV_SKIP
from tpusim_torch.types import NodeState, PodSpec, make_node_state


@dataclass
class PodRow:
    """One trace pod, host-side."""

    name: str
    cpu_milli: int
    memory_mib: int
    num_gpu: int
    gpu_milli: int
    gpu_spec: str = ""
    qos: str = ""
    pod_phase: str = ""
    creation_time: int = 0
    deletion_time: int = 0
    scheduled_time: int = 0
    # nodeSelector pinning and the simon/pod-unscheduled annotation
    pinned_node: Optional[str] = None
    unscheduled: bool = False
    # k8s-manifest fields (tpusim_torch.io.k8s_yaml): the app queues' sort
    # inputs (pkg/algo) and the workload the pod came from
    node_selector: Optional[dict] = None
    tolerations: bool = False
    workload_kind: str = ""
    workload_name: str = ""
    # open-local volume request (tpusim_torch.io.storage; the
    # simon/pod-local-storage annotation, pkg/utils/utils.go:606-618)
    local_storage: Optional[dict] = None

    @property
    def total_gpu_milli(self) -> int:
        return self.gpu_milli * self.num_gpu

    def spec_key(self) -> tuple:
        """Identity for typical-pod histogramming (frag.go:292-310)."""
        return (self.cpu_milli, self.gpu_milli, self.num_gpu, self.gpu_spec)


@dataclass
class NodeRow:
    name: str
    cpu_milli: int
    memory_mib: int
    gpu: int
    model: str = ""
    cpu_model: str = ""
    # open-local storage inventory (tpusim_torch.io.storage; the
    # simon/node-local-storage annotation, pkg/utils/utils.go:572-585)
    local_storage: Optional[dict] = None


def _sanitize_gpu_milli(num_gpu: int, gpu_milli) -> int:
    if num_gpu == 0:
        return 0
    try:
        m = int(float(gpu_milli))
    except (TypeError, ValueError):
        m = 1000
    if m > 1000:
        return 1000
    if m <= 0:
        return 0
    return m


def load_node_csv(path: str) -> List[NodeRow]:
    rows = []
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            model = (r.get("model") or "").strip()
            if model.lower() == "nan":
                model = ""
            rows.append(
                NodeRow(
                    name=r["sn"],
                    cpu_milli=int(float(r["cpu_milli"])),
                    memory_mib=int(float(r["memory_mib"])),
                    gpu=int(float(r["gpu"])),
                    model=model,
                    cpu_model=(r.get("cpu_model") or "").strip(),
                )
            )
    return rows


def load_pod_csv(path: str) -> List[PodRow]:
    rows = []
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            num_gpu = int(float(r["num_gpu"]))
            spec = (r.get("gpu_spec") or "").strip()
            if spec.lower() == "nan":
                spec = ""
            rows.append(
                PodRow(
                    name=r["name"],
                    cpu_milli=int(float(r["cpu_milli"])),
                    memory_mib=int(float(r.get("memory_mib") or 0)),
                    num_gpu=num_gpu,
                    gpu_milli=_sanitize_gpu_milli(num_gpu, r.get("gpu_milli")),
                    gpu_spec=spec if num_gpu > 0 else "",
                    qos=r.get("qos", ""),
                    pod_phase=r.get("pod_phase", ""),
                    creation_time=int(float(r.get("creation_time") or 0)),
                    deletion_time=int(float(r.get("deletion_time") or 0)),
                    scheduled_time=int(float(r.get("scheduled_time") or 0)),
                )
            )
    return rows


def nodes_to_state(nodes: Sequence[NodeRow], device="cuda") -> NodeState:
    """NodeRow list -> all-idle NodeState."""
    for n in nodes:
        if n.gpu > MAX_GPUS_PER_NODE:
            raise ValueError(f"node {n.name}: {n.gpu} GPUs > {MAX_GPUS_PER_NODE}")
    return make_node_state(
        cpu_cap=[n.cpu_milli for n in nodes],
        mem_cap=[n.memory_mib for n in nodes],
        gpu_cnt=[n.gpu for n in nodes],
        gpu_type=[register_gpu_model(n.model) if n.model else NO_GPU
                  for n in nodes],
        cpu_type=[CPU_MODEL_IDS.get(n.cpu_model, 0) for n in nodes],
        device=device,
    )


def pods_to_specs(pods: Sequence[PodRow], node_index: dict = None,
                  device="cuda") -> PodSpec:
    """PodRow list -> PodSpec tensors. node_index maps node names to row
    indices for pinned pods; a pod pinned to an unknown node is pinned to
    len(node_index), which no node matches (-1 means unconstrained)."""

    def pin(p: PodRow) -> int:
        if p.pinned_node is None or node_index is None:
            return -1
        return node_index.get(p.pinned_node, len(node_index))

    def col(values):
        return torch.as_tensor(np.array(values, np.int32), device=device)

    return PodSpec(
        cpu=col([p.cpu_milli for p in pods]),
        mem=col([p.memory_mib for p in pods]),
        gpu_milli=col([p.gpu_milli for p in pods]),
        gpu_num=col([p.num_gpu for p in pods]),
        gpu_mask=col([gpu_spec_to_mask(p.gpu_spec) for p in pods]),
        pinned=col([pin(p) for p in pods]),
    )


def build_events(
    pods: Sequence[PodRow], use_timestamps: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Pod list -> (ev_kind i32[E], ev_pod i32[E]).

    use_timestamps=False: one creation event per pod in list order, as the
    experiment pipeline runs. True: creation and deletion events
    stable-sorted by timestamp. Pods carrying the pod-unscheduled
    annotation get EV_SKIP events."""

    def kind_of(p: PodRow) -> int:
        return EV_SKIP if p.unscheduled else EV_CREATE

    if not use_timestamps:
        kind = np.array([kind_of(p) for p in pods], np.int32)
        return kind, np.arange(len(pods), dtype=np.int32)
    events = []
    for i, p in enumerate(pods):
        events.append((p.creation_time, kind_of(p), i))
        if p.deletion_time and not p.unscheduled:
            events.append((p.deletion_time, EV_DELETE, i))
    events.sort(key=lambda e: e[0])  # python sort is stable
    kind = np.array([e[1] for e in events], np.int32)
    idx = np.array([e[2] for e in events], np.int32)
    return kind, idx


def tiebreak_rank(num_nodes: int, seed: int = 42) -> np.ndarray:
    """Random permutation standing in for the reference's random node-name
    prefixes and lexicographic selectHost tie-break: rank[i] = position of
    node i in that order."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    rank = np.empty(num_nodes, np.int32)
    rank[perm] = np.arange(num_nodes, dtype=np.int32)
    return rank
