"""Cluster snapshot export/import (counterpart of tpusim/io/export.py;
ref: pkg/simulator/export.go +
scripts/inject_origin_workload_into_snapshot.py).

Three snapshot surfaces, schema-compatible with the reference so its
analysis/plotting/resume tooling works unchanged:
- pod snapshot YAML (export.go:20-77): every pod re-emitted as a k8s Pod doc
  whose binding is moved into a `kubernetes.io/hostname` nodeSelector so a
  future run re-binds identically; unscheduled pods carry the
  `simon/pod-unscheduled` annotation.
- pod snapshot CSV (export.go:82-200): 14-column schema incl. gpu_index and
  per-model memory derates.
- node snapshot CSV (export.go:202-312): fixed 8-GPU columns
  gpu_milli_left_0..7 (+ per-device mem-left), same as the input trace.

The YAML loader ingests both our exports and reference-style workload YAML
(data/pod_csv_to_yaml.py output), which is also the Applier's pod-ingestion
path. inject_snapshot_workload implements the warm-start trick of
scripts/inject_origin_workload_into_snapshot.py:27-40: rename snapshot pods
with an -ss<id> suffix and pin creation-time to the epoch so they sort before
any new workload.
"""

from __future__ import annotations

import csv
from dataclasses import replace
from typing import List, Optional, Sequence

import numpy as np
import yaml

from tpusim_torch.constants import GPU_MEMORY_MIB, MILLI
from tpusim_torch.io.k8s_yaml import SAFE_LOADER
from tpusim_torch.io.trace import NodeRow, PodRow

# annotation keys (ref: open-gpu-share/utils/const.go:4-14)
ANNO_GPU_MILLI = "alibabacloud.com/gpu-milli"
ANNO_GPU_COUNT = "alibabacloud.com/gpu-count"
ANNO_GPU_INDEX = "alibabacloud.com/gpu-index"
ANNO_GPU_MODEL = "alibabacloud.com/gpu-card-model"
ANNO_CPU_MODEL = "alibabacloud.com/cpu-model"
ANNO_CREATION_TIME = "alibabacloud.com/creation-time"
ANNO_DELETION_TIME = "alibabacloud.com/deletion-time"
ANNO_UNSCHEDULED = "simon/pod-unscheduled"  # ref: pkg/type/const.go
ANNO_ASSUME_TIME = "alibabacloud.com/assume-time"  # scheduling latency
HOSTNAME_LABEL = "kubernetes.io/hostname"
SCHEDULER_NAME = "simon-scheduler"
# libyaml's emitter when PyYAML was built with it: the same text as the
# pure-Python SafeDumper, several times faster on a cluster's snapshot
SAFE_DUMPER = getattr(yaml, "CSafeDumper", yaml.SafeDumper)


def _gpu_index_str(dev_mask) -> str:
    """Device ids joined by '-' (ref: DevIdSep, utils/pod.go)."""
    return "-".join(str(i) for i in np.flatnonzero(np.asarray(dev_mask)))


def pod_to_yaml_obj(
    pod: PodRow,
    node_name: Optional[str] = None,
    dev_mask=None,
    unscheduled: bool = False,
    assume_time_ns: Optional[int] = None,
) -> dict:
    """One trace pod → k8s Pod object (dict), reference-schema annotations.

    assume_time_ns stamps `alibabacloud.com/assume-time` alongside the
    gpu-index annotation, like the reference's Reserve step
    (UpdatePodDeviceAnnoSpec, open-gpu-share/utils/pod.go:164-174 writes
    time.Now().UnixNano()). The replay runs as one batch, so per-pod wall times
    do not exist; callers pass a deterministic nanotime series that
    preserves scheduling order (the annotation's purpose is latency/order
    tracing, utils/const.go:9)."""
    annotations = {}
    if pod.num_gpu > 0:
        annotations[ANNO_GPU_MILLI] = str(pod.gpu_milli)
        annotations[ANNO_GPU_COUNT] = str(pod.num_gpu)
        if pod.gpu_spec:
            annotations[ANNO_GPU_MODEL] = pod.gpu_spec
        if dev_mask is not None and node_name is not None:
            idx = _gpu_index_str(dev_mask)
            if idx:
                annotations[ANNO_GPU_INDEX] = idx
                if assume_time_ns is not None:
                    annotations[ANNO_ASSUME_TIME] = str(int(assume_time_ns))
    if pod.creation_time:
        annotations[ANNO_CREATION_TIME] = str(pod.creation_time)
    if pod.deletion_time:
        annotations[ANNO_DELETION_TIME] = str(pod.deletion_time)
    if unscheduled:
        annotations[ANNO_UNSCHEDULED] = "true"

    requests = {"cpu": f"{pod.cpu_milli}m"}
    if pod.memory_mib:
        requests["memory"] = f"{pod.memory_mib}Mi"
    spec = {
        "containers": [
            {
                "name": "main",
                "image": "tensorflow:latest",
                "resources": {"requests": requests, "limits": dict(requests)},
            }
        ],
        "restartPolicy": "OnFailure",
        "schedulerName": SCHEDULER_NAME,
    }
    if node_name is not None and not unscheduled:
        spec["nodeSelector"] = {HOSTNAME_LABEL: node_name}
    meta = {"name": pod.name, "namespace": "default"}
    if annotations:
        meta["annotations"] = annotations
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec}


def export_pod_snapshot_yaml(
    pods: Sequence[PodRow],
    placed_node: np.ndarray,
    dev_mask: np.ndarray,
    node_names: Sequence[str],
    path: str,
    creation_rank: Optional[np.ndarray] = None,
):
    """ref: ExportPodSnapshotInYaml (export.go:20-77): scheduled pods pinned
    via nodeSelector, unscheduled ones annotated. Placed GPU pods carry the
    assume-time annotation: a fixed epoch base + the pod's creation-event
    position (`creation_rank`, falling back to list order), standing in for
    the reference's per-Reserve time.Now() stamps — fixed (not wall clock)
    so identical runs export byte-identical snapshots, like the pinned
    LogSink timestamps, while sorting by assume-time still recovers
    scheduling order."""
    base_ns = 946684800_000_000_000  # 2000-01-01T00:00:00Z in unix nanos
    docs = []
    for i, p in enumerate(pods):
        n = int(placed_node[i])
        order = i if creation_rank is None else int(creation_rank[i])
        if n >= 0:
            docs.append(
                pod_to_yaml_obj(
                    p, node_names[n], dev_mask[i],
                    assume_time_ns=base_ns + max(order, 0),
                )
            )
        else:
            docs.append(pod_to_yaml_obj(p, unscheduled=True))
    with open(path, "w") as f:
        yaml.dump_all(docs, f, Dumper=SAFE_DUMPER, sort_keys=False)


def export_pod_snapshot_csv(
    pods: Sequence[PodRow],
    placed_node: np.ndarray,
    dev_mask: np.ndarray,
    nodes: Sequence[NodeRow],
    path: str,
):
    """ref: ExportPodSnapshotInCSV (export.go:82-200)."""
    header = [
        "pod", "namespace", "ip", "cpu_milli", "memory_mib",
        "num_gpu", "gpu_index", "gpu_mem_ratio", "gpu_milli",
        "model", "gpu_mem_mib_each", "gpu_mem_mib", "gpu_type_req",
        "creation_time",
    ]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i, p in enumerate(pods):
            n = int(placed_node[i])
            model = nodes[n].model if n >= 0 and nodes[n].model else "CPU"
            mem_each = GPU_MEMORY_MIB.get(model, 0)
            w.writerow(
                [
                    p.name,
                    "default",
                    nodes[n].name if n >= 0 else "",
                    p.cpu_milli,
                    "",  # memory_mib: skipped by the reference too
                    p.num_gpu,
                    _gpu_index_str(dev_mask[i]) if n >= 0 else "",
                    p.gpu_milli // 10,
                    p.gpu_milli,
                    model,
                    mem_each,
                    p.gpu_milli * mem_each // MILLI,
                    p.gpu_spec if p.gpu_spec else "<none>",
                    p.creation_time or "",
                ]
            )


def export_node_snapshot_csv(state, nodes: Sequence[NodeRow], num_pods, path: str):
    """ref: ExportNodeSnapshotInCSV (export.go:202-312); `state` is the final
    NodeState (host numpy), num_pods the per-node pod count i32[N]."""
    header = (
        ["name", "ip", "model", "cpu", "gpu", "memory_mib", "gpu_mem_mib_each",
         "num_pod", "cpu_milli_left", "memory_mib_left"]
        + [c for i in range(8) for c in (f"gpu_milli_left_{i}", f"gpu_mem_mib_left_{i}")]
        + ["gpu_milli_left", "gpu_mem_mib_left"]
    )
    cpu_left = np.asarray(state.cpu_left)
    gpu_left = np.asarray(state.gpu_left)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i, n in enumerate(nodes):
            model = n.model if n.model else "CPU"
            mem_each = GPU_MEMORY_MIB.get(model, 0)
            row = [
                n.name, "", model, n.cpu_milli // MILLI, n.gpu, n.memory_mib,
                mem_each, int(num_pods[i]), int(cpu_left[i]), n.memory_mib,
            ]
            total_milli = total_mem = 0
            for d in range(8):
                left = int(gpu_left[i][d]) if d < n.gpu else 0
                mem_left = left * mem_each // MILLI
                total_milli += left
                total_mem += mem_left
                row += [left, mem_left]
            row += [total_milli, total_mem]
            w.writerow(row)


def _parse_quantity_milli(q) -> int:
    s = str(q)
    if s.endswith("m"):
        return int(float(s[:-1]))
    return int(float(s) * MILLI)


def _parse_quantity_mib(q) -> int:
    s = str(q)
    units = {"Mi": 1, "Gi": 1024, "Ki": 1.0 / 1024, "Ti": 1024 * 1024}
    for suffix, mult in units.items():
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(float(s)) // (1024 * 1024)  # plain bytes


def load_pod_yaml(path: str) -> List[PodRow]:
    """Ingest reference-style pod YAML (pod_csv_to_yaml.py output or our own
    snapshot) → PodRow list. The pinned node (if any) lands in
    PodRow.pinned_node for re-binding."""
    pods: List[PodRow] = []
    with open(path) as f:
        for doc in yaml.load_all(f, Loader=SAFE_LOADER):
            if not doc or doc.get("kind") != "Pod":
                continue
            meta = doc.get("metadata", {})
            anno = meta.get("annotations") or {}
            spec = doc.get("spec", {})
            containers = spec.get("containers", [])
            cpu = mem = 0
            for c in containers:
                req = (c.get("resources") or {}).get("requests") or {}
                if "cpu" in req:
                    cpu += _parse_quantity_milli(req["cpu"])
                if "memory" in req:
                    mem += _parse_quantity_mib(req["memory"])
            num_gpu = int(anno.get(ANNO_GPU_COUNT, 0))
            pods.append(
                PodRow(
                    name=meta.get("name", ""),
                    cpu_milli=cpu,
                    memory_mib=mem,
                    num_gpu=num_gpu,
                    gpu_milli=int(anno.get(ANNO_GPU_MILLI, 0)) if num_gpu else 0,
                    gpu_spec=anno.get(ANNO_GPU_MODEL, ""),
                    creation_time=int(anno.get(ANNO_CREATION_TIME, 0)),
                    deletion_time=int(anno.get(ANNO_DELETION_TIME, 0)),
                    pinned_node=(spec.get("nodeSelector") or {}).get(HOSTNAME_LABEL),
                    unscheduled=anno.get(ANNO_UNSCHEDULED) == "true",
                )
            )
    return pods


def inject_snapshot_workload(
    snapshot_pods: Sequence[PodRow], snapshot_id: int = 0
) -> List[PodRow]:
    """Warm-start injection (ref:
    scripts/inject_origin_workload_into_snapshot.py:27-40): suffix snapshot
    pod names with -ss<id> and pin creation-time to the epoch so they sort
    (and thus schedule) before any new workload pods."""
    return [
        replace(p, name=f"{p.name}-ss{snapshot_id}", creation_time=0, deletion_time=0)
        for p in snapshot_pods
    ]
