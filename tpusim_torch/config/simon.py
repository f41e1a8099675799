"""The simulator's own CR: `apiVersion: simon/v1alpha1, kind: Config`
(counterpart of tpusim/config/simon.py).

Faithful schema + validation of the reference's config object
(ref: pkg/api/v1alpha1/types.go:13-109; validation pkg/apply/apply.go:252-286)
so existing cluster-config YAMLs drive this framework unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import yaml

from tpusim_torch.sim.typical import TypicalPodsConfig

API_VERSION = "simon/v1alpha1"
KIND = "Config"


@dataclass
class ExportConfig:
    """ref: types.go:70-73."""

    pod_snapshot_yaml_file_prefix: str = ""
    node_snapshot_csv_file_prefix: str = ""


@dataclass
class WorkloadInflationConfig:
    """ref: types.go:78-81."""

    ratio: float = 1.0
    seed: int = 233


@dataclass
class WorkloadTuningConfig:
    """ref: types.go:86-89. ratio <= 0 means no effect."""

    ratio: float = 0.0
    seed: int = 233


@dataclass
class DescheduleConfig:
    """ref: types.go:94-97."""

    ratio: float = 0.0
    policy: str = ""


@dataclass
class CustomConfig:
    """ref: types.go:57-65 + TypicalPodsConfig :104-109."""

    shuffle_pod: bool = False
    export: ExportConfig = field(default_factory=ExportConfig)
    inflation: WorkloadInflationConfig = field(
        default_factory=WorkloadInflationConfig
    )
    tuning: WorkloadTuningConfig = field(default_factory=WorkloadTuningConfig)
    new_workload_config: str = ""
    deschedule: DescheduleConfig = field(default_factory=DescheduleConfig)
    typical_pods: TypicalPodsConfig = field(default_factory=TypicalPodsConfig)
    # Annotation-driven create+delete replay (ref: simulator.go:672-717).
    # The reference has no CR knob for this — the mode is implied by
    # creation-time/deletion-time annotations being present on the pods
    # (its experiment pipeline strips them, pod_csv_to_yaml.py:119-120,
    # which degrades the stable timestamp sort to list order). Since this
    # build ingests traces that always carry timestamps, the switch is
    # explicit.
    use_timestamps: bool = False
    # Replay engine selection (no reference counterpart: the engines are
    # the JAX package's execution strategies, ENGINES.md): auto |
    # sequential | table | pallas. The port runs its CUDA kernels under
    # "auto" and "pallas"; the Applier refuses the others.
    engine: str = "auto"
    # Device-mesh width of the JAX package's sharded engine: 0 = one
    # device. The port has no mesh engine yet; the Applier refuses > 1.
    mesh: int = 0


@dataclass
class AppInfo:
    """ref: types.go AppInfo (name/path/chart)."""

    name: str
    path: str
    chart: bool = False


@dataclass
class SimonCR:
    name: str = ""
    custom_cluster: str = ""  # YAML dir with node/pod manifests
    kube_config: str = ""  # real-cluster path (gated: no cluster here)
    app_list: List[AppInfo] = field(default_factory=list)
    new_node: str = ""  # parsed for schema parity; unused by the reference
    # revision too (no consumer of SimonSpec.NewNode in pkg/)
    custom_config: CustomConfig = field(default_factory=CustomConfig)


class ConfigError(ValueError):
    pass


def _expand_tabs_outside_quotes(text: str) -> str:
    """Replace whitespace tabs with spaces, leaving tabs inside single/
    double-quoted scalars intact (those are valid YAML data)."""
    out = []
    for line in text.split("\n"):
        quote = ""
        buf = []
        for ch in line:
            if quote:
                if ch == quote:
                    quote = ""
                buf.append(ch)
            elif ch in "\"'":
                quote = ch
                buf.append(ch)
            elif ch == "\t":
                buf.append("    ")
            else:
                buf.append(ch)
        out.append("".join(buf))
    return "\n".join(out)


def load_yaml_lenient(path: str):
    """YAML load tolerating literal TABs (the reference's example configs
    use tab-indented comments, which Go's sigs.k8s.io/yaml accepts but
    strict YAML rejects). On a tab ScannerError, retry with whitespace tabs
    expanded to spaces (quoted scalars untouched) — drop-in compatibility
    with the reference's shipped files."""
    with open(path) as f:
        text = f.read()
    try:
        return yaml.safe_load(text)
    except yaml.error.YAMLError as e:
        if "\\t" not in str(e) and "'\t'" not in str(e):
            raise
        return yaml.safe_load(_expand_tabs_outside_quotes(text))


def _typical(d: dict) -> TypicalPodsConfig:
    return TypicalPodsConfig(
        is_involved_cpu_pods=bool(d.get("isInvolvedCpuPods", False)),
        pod_popularity_threshold=int(d.get("podPopularityThreshold", 0)),
        pod_increase_step=int(d.get("podIncreaseStep", 0)),
        gpu_res_weight=float(d.get("gpuResWeight", 0.0)),
    )


def parse_simon_cr(doc: dict, base_dir: str = ".") -> SimonCR:
    if doc.get("apiVersion") != API_VERSION or doc.get("kind") != KIND:
        raise ConfigError(
            f"expected apiVersion={API_VERSION} kind={KIND}, got "
            f"{doc.get('apiVersion')}/{doc.get('kind')}"
        )
    spec = doc.get("spec") or {}
    cluster = spec.get("cluster") or {}
    custom_cluster = cluster.get("customConfig", "") or ""
    kube_config = cluster.get("kubeConfig", "") or ""
    # exactly one source of cluster truth (apply.go:252-286 validate)
    if bool(custom_cluster) == bool(kube_config):
        raise ConfigError(
            "spec.cluster must set exactly one of customConfig / kubeConfig"
        )

    cc_raw = spec.get("customConfig") or {}
    exp = cc_raw.get("exportConfig") or {}
    infl = cc_raw.get("workloadInflationConfig") or {}
    tune = cc_raw.get("workloadTuningConfig") or {}
    desch = cc_raw.get("descheduleConfig") or {}
    cc = CustomConfig(
        shuffle_pod=bool(cc_raw.get("shufflePod", False)),
        export=ExportConfig(
            pod_snapshot_yaml_file_prefix=str(
                exp.get("podSnapshotYamlFilePrefix") or ""
            ),
            node_snapshot_csv_file_prefix=str(
                exp.get("nodeSnapshotCSVFilePrefix") or ""
            ),
        ),
        inflation=WorkloadInflationConfig(
            ratio=float(infl.get("ratio", 1.0) or 1.0),
            seed=int(infl.get("seed", 233) or 233),
        ),
        tuning=WorkloadTuningConfig(
            ratio=float(tune.get("ratio", 0.0) or 0.0),
            seed=int(tune.get("seed", 233) or 233),
        ),
        new_workload_config=str(cc_raw.get("newWorkloadConfig") or ""),
        deschedule=DescheduleConfig(
            ratio=float(desch.get("ratio", 0.0) or 0.0),
            policy=str(desch.get("policy") or ""),
        ),
        typical_pods=_typical(cc_raw.get("typicalPodsConfig") or {}),
        use_timestamps=bool(cc_raw.get("useTimestamps", False)),
        engine=str(cc_raw.get("engine") or "auto"),
        mesh=int(cc_raw.get("mesh") or 0),
    )

    apps = []
    for a in spec.get("appList") or []:
        path = a.get("path", "")
        if not path:
            raise ConfigError(f"appList entry {a.get('name')!r} has no path")
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        apps.append(
            AppInfo(
                name=a.get("name", ""),
                path=path,
                chart=bool(a.get("chart", False)),
            )
        )
    if custom_cluster and not os.path.isabs(custom_cluster):
        custom_cluster = os.path.join(base_dir, custom_cluster)
    if kube_config and not os.path.isabs(kube_config):
        kube_config = os.path.join(base_dir, kube_config)
    return SimonCR(
        name=(doc.get("metadata") or {}).get("name", ""),
        custom_cluster=custom_cluster,
        kube_config=kube_config,
        app_list=apps,
        new_node=str(spec.get("newNode") or ""),
        custom_config=cc,
    )


def load_simon_cr(path: str, base_dir: Optional[str] = None) -> SimonCR:
    """Read + validate a cluster-config YAML. Relative paths inside the CR
    resolve against `base_dir` (default: cwd, matching the reference's
    project-relative convention)."""
    doc = load_yaml_lenient(path)
    if not isinstance(doc, dict):
        raise ConfigError(f"{path}: not a YAML mapping")
    return parse_simon_cr(doc, base_dir or ".")
