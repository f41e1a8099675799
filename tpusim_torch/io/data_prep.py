"""Trace data-prep tooling: CSV → YAML converters + experiment input trees
(counterpart of tpusim/io/data_prep.py).

Re-creates the reference's data pipeline surface (data/pod_csv_to_yaml.py,
data/prepare_input.sh, and the node side its
node_yaml/openb_node_list_gpu_node.yaml artifact implies), so that an openb
trace reaches `python -m tpusim_torch.cli apply` as a YAML cluster-config
directory (tpusim_torch.io.k8s_yaml) at its real size. The output is byte
for byte what tpusim.io.data_prep writes.

Differences from the reference converter, both deliberate:
- creation/deletion-time annotations ARE emitted (the reference comments
  them out, pod_csv_to_yaml.py:117-118, losing event ordering); with them
  the YAML round-trips losslessly back to the CSV's scheduling-relevant
  fields.
- no pandas dependency (stdlib csv; the YAML emit order matches).
"""

from __future__ import annotations

import csv
import os
import shutil
from pathlib import Path
from typing import Iterable, List, Optional

import yaml

from tpusim_torch.io.k8s_yaml import (
    ANNO_CPU_MODEL,
    ANNO_CREATION_TIME,
    ANNO_DELETION_TIME,
    ANNO_GPU_COUNT,
    ANNO_GPU_MILLI,
    ANNO_GPU_MODEL,
)

# libyaml's emitter when PyYAML was built with it: the same text as the
# pure-Python Dumper, several times faster on a whole trace
DUMPER = getattr(yaml, "CDumper", yaml.Dumper)

# the reference converter's fixed pod scaffolding (pod_csv_to_yaml.py:30-52)
POD_NAMESPACE = "paib-gpu"
CONTAINER_NAME = "main"
CONTAINER_IMAGE = "tensorflow:latest"


def _pod_obj(row: dict, namespace: str = POD_NAMESPACE) -> dict:
    """One pod CSV row → the reference's Pod manifest shape
    (pod_csv_to_yaml.py generate_pod_yaml + output_pod)."""
    requests = {"cpu": f"{int(row['cpu_milli'])}m"}
    if row.get("memory_mib"):
        requests["memory"] = f"{int(row['memory_mib'])}Mi"
    annotations = {}
    num_gpu = int(row.get("num_gpu") or 0)
    if num_gpu != 0:
        milli = int(row.get("gpu_milli") or 1000)
        # clamp exactly like the reference (pod_csv_to_yaml.py:110)
        milli = "1000" if milli > 1000 else str(milli) if milli > 0 else "0"
        annotations[ANNO_GPU_MILLI] = milli
        annotations[ANNO_GPU_COUNT] = str(num_gpu)
        spec = "|".join(x for x in (row.get("gpu_spec") or "").split("|") if x)
        if spec:
            annotations[ANNO_GPU_MODEL] = spec
    # event ordering survives the round trip (the reference drops these)
    if row.get("creation_time"):
        annotations[ANNO_CREATION_TIME] = str(int(row["creation_time"]))
    if row.get("deletion_time"):
        annotations[ANNO_DELETION_TIME] = str(int(row["deletion_time"]))
    meta = {"name": row["name"], "namespace": namespace}
    if annotations:
        meta["annotations"] = annotations
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": {
            "containers": [
                {
                    "name": CONTAINER_NAME,
                    "image": CONTAINER_IMAGE,
                    "imagePullPolicy": "Always",
                    "resources": {
                        "requests": dict(requests),
                        "limits": dict(requests),
                    },
                }
            ],
            "restartPolicy": "OnFailure",
            "dnsPolicy": "Default",
        },
    }


def _node_obj(row: dict) -> dict:
    """One node CSV row → the reference's Node manifest shape
    (data/node_yaml/openb_node_list_gpu_node.yaml; cpu-model labels are the
    `2 - Add CPU models to YAML nodes.ipynb` step)."""
    name = row.get("sn") or row["name"]
    gpu = int(row.get("gpu") or 0)
    labels = {
        "beta.kubernetes.io/os": "linux",
        "kubernetes.io/os": "linux",
        "kubernetes.io/hostname": name,
    }
    if gpu > 0 and row.get("model"):
        labels[ANNO_GPU_MODEL] = row["model"]
    if row.get("cpu_model"):
        labels[ANNO_CPU_MODEL] = row["cpu_model"]
    resources = {
        "cpu": f"{int(row['cpu_milli'])}m",
        "memory": f"{int(row['memory_mib'])}Mi",
        "pods": "1001",
        ANNO_GPU_COUNT: str(gpu),
        ANNO_GPU_MILLI: str(gpu * 1000),
    }
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels},
        "status": {
            "allocatable": dict(resources),
            "capacity": dict(resources),
        },
    }


def _write_multidoc(objs: Iterable[dict], out_path) -> int:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(out_path, "w") as f:
        for i, obj in enumerate(objs):
            if i:
                f.write("\n---\n\n")
            yaml.dump(obj, f, Dumper=DUMPER, default_flow_style=False)
            n += 1
    return n


def pod_csv_to_yaml(
    csv_path, out_path=None, namespace: str = POD_NAMESPACE
) -> Path:
    """openb pod CSV → multi-document Pod YAML (ref: pod_csv_to_yaml.py
    __main__: output lands in <stem>/<stem>.yaml next to the cwd unless
    out_path is given)."""
    csv_path = Path(csv_path)
    if out_path is None:
        out_dir = Path(csv_path.stem)
        out_path = out_dir / (csv_path.stem + ".yaml")
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    n = _write_multidoc((_pod_obj(r, namespace) for r in rows), out_path)
    print(f"OUTPUT: {out_path} (len: {n})")
    return Path(out_path)


def node_csv_to_yaml(csv_path, out_path=None) -> Path:
    """openb node CSV → multi-document Node YAML (the artifact the
    reference ships pre-generated as node_yaml/openb_node_list_gpu_node.yaml)."""
    csv_path = Path(csv_path)
    if out_path is None:
        out_path = Path(csv_path.stem) / (csv_path.stem + ".yaml")
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    n = _write_multidoc((_node_obj(r) for r in rows), out_path)
    print(f"OUTPUT: {out_path} (len: {n})")
    return Path(out_path)


def prepare_input(
    csv_dir, out_dir, node_csv: Optional[str] = None
) -> List[Path]:
    """prepare_input.sh equivalent: for every openb_pod_list*.csv under
    csv_dir, create <out_dir>/<trace>/ holding the trace's pod YAML plus the
    shared node YAML — the cluster-config directory layout `python -m
    tpusim_torch.cli apply` (and the reference's `simon apply`) consumes."""
    csv_dir = Path(csv_dir)
    out_dir = Path(out_dir)
    if node_csv is None:
        node_csv = csv_dir / "openb_node_list_gpu_node.csv"
    node_yaml_tmp = out_dir / "_node" / "openb_node_list_gpu_node.yaml"
    node_csv_to_yaml(node_csv, node_yaml_tmp)
    made = []
    for pod_csv in sorted(csv_dir.glob("openb_pod_list*.csv")):
        trace_dir = out_dir / pod_csv.stem
        trace_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(node_yaml_tmp, trace_dir / node_yaml_tmp.name)
        pod_csv_to_yaml(pod_csv, trace_dir / (pod_csv.stem + ".yaml"))
        made.append(trace_dir)
    shutil.rmtree(node_yaml_tmp.parent)
    return made
