"""Kubernetes-YAML cluster/workload ingestion (counterpart of
tpusim/io/k8s_yaml.py).

The reference feeds the simulator with plain k8s manifests: Node and Pod
YAMLs for the cluster (example/new1/test-cluster/), plus workload objects
(Deployment/ReplicaSet/ReplicationController/Job/CronJob/StatefulSet/
DaemonSet) that are expanded into pods host-side before scheduling
(ref: pkg/simulator/utils.go:142-186 GetObjectFromYamlContent +
pkg/utils/utils.go:150-421 MakeValidPodsBy*). Manifests parse straight into
the host-side NodeRow/PodRow structs that tpusim_torch.io.trace lowers to
tensors; there is no object graph or fake API server in between.

Resource conventions mirror the reference's annotation schema
(open-gpu-share/utils/const.go:4-14):
  alibabacloud.com/gpu-milli      per-GPU milli request (pods)
  alibabacloud.com/gpu-count      number of GPUs (pods + node allocatable)
  alibabacloud.com/gpu-card-model GPU model (node label / pod annotation)
  alibabacloud.com/cpu-model      CPU model (node label / pod annotation)
  alibabacloud.com/creation-time  unix seconds (event ordering)
  alibabacloud.com/deletion-time  unix seconds (deletion events)
  simon/pod-unscheduled           pod failed in the snapshot it came from
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import yaml

from tpusim_torch.io.storage import (
    ANNO_NODE_LOCAL_STORAGE,
    ANNO_POD_LOCAL_STORAGE,
    match_local_storage_files,
    maybe_json,
)
from tpusim_torch.io.trace import NodeRow, PodRow

# libyaml's parser when PyYAML was built with it: the same documents as
# the pure-Python SafeLoader, several times faster on large manifests
SAFE_LOADER = getattr(yaml, "CSafeLoader", yaml.SafeLoader)

ANNO_GPU_MILLI = "alibabacloud.com/gpu-milli"
ANNO_GPU_COUNT = "alibabacloud.com/gpu-count"
ANNO_GPU_MODEL = "alibabacloud.com/gpu-card-model"
ANNO_CPU_MODEL = "alibabacloud.com/cpu-model"
ANNO_CREATION_TIME = "alibabacloud.com/creation-time"
ANNO_DELETION_TIME = "alibabacloud.com/deletion-time"
ANNO_UNSCHEDULED = "simon/pod-unscheduled"
LABEL_HOSTNAME = "kubernetes.io/hostname"

_BINARY_SUFFIX = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4}
_DECIMAL_SUFFIX = {"k": 10**3, "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}


def parse_cpu_milli(q) -> int:
    """k8s CPU quantity → milli-cores ("4" → 4000, "250m" → 250)."""
    if q is None:
        return 0
    s = str(q).strip()
    if not s:
        return 0
    if s.endswith("m"):
        return int(float(s[:-1]))
    return int(float(s) * 1000)


def parse_mem_mib(q) -> int:
    """k8s memory quantity → MiB ("256000Mi" → 256000, "1Gi" → 1024)."""
    if q is None:
        return 0
    s = str(q).strip()
    if not s:
        return 0
    for suf, mult in _BINARY_SUFFIX.items():
        if s.endswith(suf):
            return int(float(s[: -len(suf)]) * mult) // (1024**2)
    for suf, mult in _DECIMAL_SUFFIX.items():
        if s.endswith(suf):
            return int(float(s[: -len(suf)]) * mult) // (1024**2)
    return int(float(s)) // (1024**2)


def _meta(obj: dict) -> Tuple[str, str, dict, dict]:
    meta = obj.get("metadata") or {}
    return (
        meta.get("name", ""),
        meta.get("namespace", ""),
        meta.get("annotations") or {},
        meta.get("labels") or {},
    )


def node_from_k8s(obj: dict) -> NodeRow:
    """corev1.Node manifest → NodeRow (ref: utils/node.go:6-40 getters;
    GPU count from allocatable `alibabacloud.com/gpu-count`, model from the
    gpu-card-model label)."""
    name, _, annotations, labels = _meta(obj)
    status = obj.get("status") or {}
    alloc = status.get("allocatable") or status.get("capacity") or {}
    gpu = int(float(alloc.get(ANNO_GPU_COUNT, 0) or 0))
    model = labels.get(ANNO_GPU_MODEL, "") or annotations.get(ANNO_GPU_MODEL, "")
    cpu_model = labels.get(ANNO_CPU_MODEL, "") or annotations.get(ANNO_CPU_MODEL, "")
    storage = maybe_json(annotations.get(ANNO_NODE_LOCAL_STORAGE))
    return NodeRow(
        name=name,
        cpu_milli=parse_cpu_milli(alloc.get("cpu")),
        memory_mib=parse_mem_mib(alloc.get("memory")),
        gpu=gpu,
        model=model if gpu > 0 else "",
        cpu_model=cpu_model,
        local_storage=storage,
    )


def _container_requests(spec: dict) -> Tuple[int, int]:
    """Sum of container requests, falling back to the limit PER RESOURCE
    when a request is unset (k8s defaulting semantics, as in
    resourcehelper.PodRequestsAndLimits)."""
    cpu = mem = 0
    for c in spec.get("containers") or []:
        res = c.get("resources") or {}
        req = res.get("requests") or {}
        lim = res.get("limits") or {}
        cpu += parse_cpu_milli(req.get("cpu", lim.get("cpu")))
        mem += parse_mem_mib(req.get("memory", lim.get("memory")))
    return cpu, mem


def pod_from_k8s(obj: dict) -> PodRow:
    """corev1.Pod manifest → PodRow (ref: utils.GetPodResource,
    pkg/utils/utils.go:1008-1029 + MakeValidPod sanitization :424-506 —
    sanitization here is implicit: only the scheduling-relevant fields
    survive the parse)."""
    name, namespace, annotations, _ = _meta(obj)
    spec = obj.get("spec") or {}
    cpu, mem = _container_requests(spec)
    num_gpu = int(float(annotations.get(ANNO_GPU_COUNT, 0) or 0))
    gpu_milli = int(float(annotations.get(ANNO_GPU_MILLI, 0) or 0)) if num_gpu else 0
    gpu_milli = max(0, min(gpu_milli, 1000))
    gpu_spec = annotations.get(ANNO_GPU_MODEL, "") if num_gpu else ""
    selector = spec.get("nodeSelector") or {}
    pinned = spec.get("nodeName") or selector.get(LABEL_HOSTNAME)
    meta = obj.get("metadata") or {}
    owners = meta.get("ownerReferences") or []
    owner_kind = owners[0].get("kind", "") if owners else ""
    return PodRow(
        name=f"{namespace}/{name}" if namespace else name,
        cpu_milli=cpu,
        memory_mib=mem,
        num_gpu=num_gpu,
        gpu_milli=gpu_milli,
        gpu_spec=gpu_spec,
        creation_time=int(float(annotations.get(ANNO_CREATION_TIME, 0) or 0)),
        deletion_time=int(float(annotations.get(ANNO_DELETION_TIME, 0) or 0)),
        pinned_node=pinned,
        unscheduled=str(annotations.get(ANNO_UNSCHEDULED, "")).lower() == "true",
        node_selector=dict(selector) or None,
        tolerations=bool(spec.get("tolerations")),
        local_storage=maybe_json(annotations.get(ANNO_POD_LOCAL_STORAGE)),
        # DaemonSet-owned raw pods are excluded from the schedulable
        # workload, like GetValidPodExcludeDaemonSet's ownerReference check
        workload_kind=owner_kind,
        workload_name=owners[0].get("name", "") if owners else "",
    )


def _pods_from_template(
    obj: dict, kind: str, replicas_field: str = "replicas"
) -> List[PodRow]:
    """Workload object → `replicas` PodRows named `<name>-<ordinal>`
    (ref: MakeValidPodsByReplicaSet et al., pkg/utils/utils.go:155-285;
    StatefulSet ordinal naming :279 generalized to all kinds — names only
    feed reporting, not placement)."""
    name, namespace, _, _ = _meta(obj)
    spec = obj.get("spec") or {}
    raw = spec.get(replicas_field)
    replicas = 1 if raw is None else int(raw)  # explicit 0 means zero pods
    template = spec.get("template") or {}
    pods = []
    for ordinal in range(replicas):
        t = {
            "metadata": {
                **(template.get("metadata") or {}),
                "name": f"{name}-{ordinal}",
                "namespace": namespace,
            },
            "spec": template.get("spec") or {},
        }
        p = pod_from_k8s(t)
        p.workload_kind = kind
        p.workload_name = name
        pods.append(p)
    return pods


def pods_from_workload(obj: dict) -> Optional[List[PodRow]]:
    """Expand one workload manifest into pods; None if `obj` is not a
    workload kind (ref: GetValidPodExcludeDaemonSet dispatch,
    pkg/simulator/utils.go:79-139)."""
    kind = obj.get("kind", "")
    if kind in ("Deployment", "ReplicaSet", "ReplicationController"):
        return _pods_from_template(obj, kind)
    if kind == "StatefulSet":
        return _pods_from_template(obj, kind)
    if kind == "Job":
        return _pods_from_template(obj, kind, replicas_field="completions")
    if kind == "CronJob":
        # CronJob → one manual Job instantiation (utils.go:246-260)
        name, namespace, _, _ = _meta(obj)
        job_spec = ((obj.get("spec") or {}).get("jobTemplate") or {}).get("spec") or {}
        job = {
            "kind": "Job",
            "metadata": {"name": name, "namespace": namespace},
            "spec": job_spec,
        }
        return _pods_from_template(job, "Job", replicas_field="completions")
    return None


def daemonset_pods(obj: dict, node_names: Sequence[str]) -> List[PodRow]:
    """DaemonSet → one pod per node, pinned by hostname affinity
    (ref: MakeValidPodByDaemonset + node pinning, pkg/utils/utils.go:884-929;
    driven per-node from core.go:117-123)."""
    name, namespace, _, _ = _meta(obj)
    spec = obj.get("spec") or {}
    template = spec.get("template") or {}
    pods = []
    for node in node_names:
        t = {
            "metadata": {
                **(template.get("metadata") or {}),
                "name": f"{name}-{node}",
                "namespace": namespace,
            },
            "spec": dict(template.get("spec") or {}),
        }
        p = pod_from_k8s(t)
        p.pinned_node = node
        p.workload_kind = "DaemonSet"
        p.workload_name = name
        pods.append(p)
    return pods


def yaml_files_in_dir(path: str) -> List[str]:
    """Recursive *.yaml/*.yml walk, sorted for determinism
    (ref: GetYamlContentFromDirectory, pkg/utils/utils.go)."""
    out = []
    for root, _, files in os.walk(path):
        for f in sorted(files):
            if f.endswith((".yaml", ".yml")):
                out.append(os.path.join(root, f))
    return sorted(out)


def load_objects(paths: Iterable[str]) -> List[dict]:
    objs = []
    for p in paths:
        with open(p) as f:
            for doc in yaml.load_all(f, Loader=SAFE_LOADER):
                if isinstance(doc, dict) and doc.get("kind"):
                    objs.append(doc)
    return objs


class ClusterResource:
    """Typed buckets of parsed manifests — the array-era stand-in for
    simulator.ResourceTypes (ref: pkg/simulator/core.go ResourceTypes)."""

    def __init__(self):
        self.nodes: List[NodeRow] = []
        self.pods: List[PodRow] = []
        self.daemonsets: List[dict] = []
        self.other: List[dict] = []  # PDB/Service/StorageClass/PVC/… (inert)

    @property
    def node_names(self) -> List[str]:
        return [n.name for n in self.nodes]

    def workload_pods(self) -> List[PodRow]:
        """Pods to schedule, excluding DaemonSet-owned ones
        (ref: GetValidPodExcludeDaemonSet, pkg/simulator/utils.go:79-139)."""
        return [p for p in self.pods if p.workload_kind != "DaemonSet"]

    def daemonset_pods(self) -> List[PodRow]:
        out = []
        for ds in self.daemonsets:
            out.extend(daemonset_pods(ds, self.node_names))
        return out


def load_cluster_from_dir(path: str) -> ClusterResource:
    """YAML dir → ClusterResource (ref:
    simulator.CreateClusterResourceFromClusterConfig, simulator.go:880-895;
    per-node `<name>.json` storage files attach open-local inventories like
    MatchAndSetLocalStorageAnnotationOnNode)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"cluster config directory not found: {path}")
    res = load_cluster_from_objects(load_objects(yaml_files_in_dir(path)))
    storage = match_local_storage_files(res.node_names, path)
    for n in res.nodes:
        if n.name in storage and n.local_storage is None:
            n.local_storage = storage[n.name]
    return res


ANNO_CONFIG_MIRROR = "kubernetes.io/config.mirror"
ANNO_CONFIG_SOURCE = "kubernetes.io/config.source"


def is_static_pod(obj: dict) -> bool:
    """A pod whose config source is not the API server (ref:
    kubetypes.IsStaticPod, used by CreateClusterResourceFromClient at
    simulator.go:766-771 to decide which raw pods survive ingestion)."""
    ann = (obj.get("metadata") or {}).get("annotations") or {}
    src = ann.get(ANNO_CONFIG_SOURCE, "")
    return bool(src and src != "api") or ANNO_CONFIG_MIRROR in ann


def load_cluster_from_dump(path: str) -> ClusterResource:
    """Real-cluster snapshot ingestion: a `kubectl get
    nodes,pods,deployments,... -o yaml` dump file (or a directory of such
    files) → ClusterResource.

    Preserves the capability of the reference's kubeConfig mode
    (CreateClusterResourceFromClient, simulator.go:746-830) without a live
    API server, with the same object semantics: every Node is kept; raw
    Pods are kept only when static (non-static pods are dropped because the
    workload objects re-expand into fresh pods that the simulation
    re-schedules — simulator.go:759-771); workload controllers
    (Deployment/RS/RC/Job/CronJob/StatefulSet/DaemonSet) expand as usual.

    `kind: List` envelopes (kubectl's multi-object output) are flattened.
    A kubeconfig credential file is rejected: it names a live cluster,
    whose client the port does not have yet.
    """
    paths = yaml_files_in_dir(path) if os.path.isdir(path) else [path]
    objs: List[dict] = []
    for obj in load_objects(paths):
        if obj.get("kind") == "List":
            objs.extend(
                i
                for i in obj.get("items") or []
                if isinstance(i, dict) and i.get("kind")
            )
        elif obj.get("kind") == "Config" and "clusters" in obj:
            raise ValueError(
                f"{path} is a kubeconfig credential file, not a dump; "
                "ingest a dump instead: kubectl get nodes,pods,deployments,"
                "statefulsets,daemonsets -A -o yaml > dump.yaml"
            )
        else:
            objs.append(obj)
    objs = _filter_cluster_objects(objs)
    return load_cluster_from_objects(objs)


def _filter_cluster_objects(objs: Sequence[dict]) -> List[dict]:
    """CreateClusterResourceFromClient's object-filtering rules applied to
    an already-listed object set (simulator.go:759-771, 830-836, 881-891):
    raw Pods only when static, no Deployment-owned ReplicaSets, no
    CronJob-owned Jobs — a full `kubectl get -A` dump contains both owners
    and their children, which would otherwise double-expand workload pods."""

    def owned_by(obj, kind):
        return any(
            ref.get("kind") == kind
            for ref in (obj.get("metadata") or {}).get("ownerReferences") or []
        )

    out = []
    for o in objs:
        kind = o.get("kind")
        if kind == "Pod" and not is_static_pod(o):
            continue
        if kind == "ReplicaSet" and owned_by(o, "Deployment"):
            continue
        if kind == "Job" and owned_by(o, "CronJob"):
            continue
        out.append(o)
    return out


def load_cluster_from_objects(objs: Sequence[dict]) -> ClusterResource:
    res = ClusterResource()
    for obj in objs:
        kind = obj.get("kind", "")
        if kind == "Node":
            res.nodes.append(node_from_k8s(obj))
        elif kind == "Pod":
            res.pods.append(pod_from_k8s(obj))
        elif kind == "DaemonSet":
            res.daemonsets.append(obj)
        else:
            pods = pods_from_workload(obj)
            if pods is not None:
                res.pods.extend(pods)
            else:
                res.other.append(obj)
    res.nodes.sort(key=lambda n: n.name)  # name-sort before the random
    # tie-break prefix permutation (simulator.go:584-588)
    return res
