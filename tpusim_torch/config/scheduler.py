"""KubeSchedulerConfiguration parsing + simulator defaulting (counterpart
of tpusim/config/scheduler.py).

Accepts the reference's scheduler-config YAML surface
(example/original/test-scheduler-config.yaml) and applies the same forced
defaults as the reference (ref: GetAndSetSchedulerConfig,
pkg/simulator/utils.go:217-323): percentageOfNodesToScore=100, scheduler
name `simon-scheduler`, DefaultBinder disabled in favor of the Simon bind.

Policy selection follows the reference convention: the enabled Score
plugins (with weights) pick the policy mix; per-plugin `pluginConfig` args
carry `dimExtMethod` / `normMethod` / `gpuSelMethod`
(ref: pkg/type/config.go:50-61 plugin-config structs).

k8s built-in score plugins that the simulator always disables
(ImageLocality, NodeAffinity, …) are accepted in the YAML and ignored —
they have no analogue over the array state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import yaml

SCHEDULER_NAME = "simon-scheduler"  # ref: pkg/type/const.go DefaultSchedulerName
API_VERSIONS = (
    "kubescheduler.config.k8s.io/v1beta1",
    "kubescheduler.config.k8s.io/v1beta2",
    "kubescheduler.config.k8s.io/v1",
)

# score plugins this framework implements (ref: pkg/type/const.go:4-13)
KNOWN_SCORE_PLUGINS = (
    "Simon",
    "RandomScore",
    "DotProductScore",
    "GpuClusteringScore",
    "GpuPackingScore",
    "BestFitScore",
    "FGDScore",
    "PWRScore",
)
# vendored-k8s score plugins force-disabled by the reference; silently inert
IGNORED_SCORE_PLUGINS = (
    "ImageLocality",
    "NodeAffinity",
    "PodTopologySpread",
    "TaintToleration",
    "NodeResourcesBalancedAllocation",
    "InterPodAffinity",
    "NodeResourcesLeastAllocated",
    "NodePreferAvoidPods",
)


@dataclass
class SchedulerConfig:
    policies: List[Tuple[str, int]] = field(default_factory=list)
    gpu_sel_method: str = "best"  # best|worst|random|<score-plugin name>
    dim_ext_method: str = "share"  # merge|share|divide|extend
    norm_method: str = "max"  # node|pod|max
    percentage_of_nodes_to_score: int = 100
    scheduler_name: str = SCHEDULER_NAME
    # HTTP scheduler extenders (tpusim_torch.sim.extender.ExtenderConfig
    # tuple; ref: simulator.go:196 WithExtenders pass-through), which the
    # replays honour through the extender host loop
    extenders: tuple = ()

    def policy_tuple(self) -> Tuple[Tuple[str, int], ...]:
        return tuple(self.policies)


class SchedulerConfigError(ValueError):
    pass


def default_scheduler_config() -> SchedulerConfig:
    """No-config default (ref: GetAndSetSchedulerConfig's built-in profile:
    Simon + BestFit + Random + DotProduct + FGD + PWR all enabled at weight
    1, utils.go:251-272)."""
    return SchedulerConfig(
        policies=[
            ("Simon", 1),
            ("BestFitScore", 1),
            ("RandomScore", 1),
            ("DotProductScore", 1),
            ("FGDScore", 1),
            ("PWRScore", 1),
        ]
    )


def parse_scheduler_config(doc: dict) -> SchedulerConfig:
    if doc.get("kind") != "KubeSchedulerConfiguration":
        raise SchedulerConfigError(
            f"expected kind=KubeSchedulerConfiguration, got {doc.get('kind')}"
        )
    if doc.get("apiVersion") not in API_VERSIONS:
        raise SchedulerConfigError(
            f"unsupported apiVersion {doc.get('apiVersion')}"
        )
    # The reference forces percentageOfNodesToScore=100 (utils.go:234-235)
    # and passes extenders through to the vendored scheduler
    # (simulator.go:185-197). This build always scores every node, so it
    # rejects configs that ask otherwise rather than silently computing
    # something different.
    pct = doc.get("percentageOfNodesToScore")
    if pct is not None:
        try:
            if float(pct) != int(pct):
                raise ValueError
            pct = int(pct)
        except (TypeError, ValueError, OverflowError):
            raise SchedulerConfigError(
                f"percentageOfNodesToScore={pct!r} is not an integer"
            ) from None
    if pct is not None and pct != 100:
        raise SchedulerConfigError(
            f"percentageOfNodesToScore={pct} unsupported: this simulator "
            "always scores 100% of nodes (the reference forces the same, "
            "utils.go:234)"
        )
    extenders = _parse_extenders(doc.get("extenders") or [])
    profiles = doc.get("profiles") or []
    if not profiles:
        cfg = default_scheduler_config()
        cfg.extenders = extenders
        return cfg
    profile = profiles[0]
    plugins = profile.get("plugins") or {}
    score = plugins.get("score") or {}

    # k8s profile-merge semantics (vendored defaultPlugins.Apply): the
    # `disabled` list strips plugins from the DEFAULT set only; `enabled`
    # entries are then appended and always win. The reference's own example
    # configs list a plugin in both (disable-everything boilerplate + the
    # chosen policy re-enabled), so skipping enabled-plugins-in-disabled
    # would silently fall back to the wrong profile. The k8s built-in score
    # defaults the boilerplate strips are exactly IGNORED_SCORE_PLUGINS,
    # which have no analogue over the array state — so `disabled` carries
    # no further information here.
    cfg = SchedulerConfig()
    for p in score.get("enabled") or []:
        name = p.get("name")
        if name in IGNORED_SCORE_PLUGINS:
            continue
        if name not in KNOWN_SCORE_PLUGINS:
            raise SchedulerConfigError(f"unknown score plugin: {name}")
        cfg.policies.append((name, int(p.get("weight", 1) or 1)))
    if not cfg.policies:
        cfg = default_scheduler_config()

    # pluginConfig args: last writer wins per arg, matching the reference's
    # per-plugin structs all carrying the same three knobs
    for pc in profile.get("pluginConfig") or []:
        args = pc.get("args") or {}
        if "dimExtMethod" in args:
            cfg.dim_ext_method = str(args["dimExtMethod"])
        if "normMethod" in args:
            cfg.norm_method = str(args["normMethod"])
        if "gpuSelMethod" in args:
            cfg.gpu_sel_method = str(args["gpuSelMethod"])

    # forced defaults (utils.go:234-235, 312)
    cfg.percentage_of_nodes_to_score = 100
    cfg.scheduler_name = profile.get("schedulerName") or SCHEDULER_NAME
    cfg.extenders = extenders
    _validate_methods(cfg)
    return cfg


def _parse_extenders(entries) -> tuple:
    """`extenders:` list → ExtenderConfig tuple (the v1beta1 Extender
    fields; apis/config/types.go:109). The reference hands these straight
    to the vendored scheduler (simulator.go:196). Verbs the simulator
    cannot honor are rejected loudly rather than silently dropped."""
    from tpusim_torch.sim.extender import ExtenderConfig

    out = []
    for e in entries:
        if not isinstance(e, dict) or not e.get("urlPrefix"):
            raise SchedulerConfigError(
                f"extender entry must be a mapping with urlPrefix: {e!r}"
            )
        for unsupported in ("bindVerb", "preemptVerb"):
            if e.get(unsupported):
                raise SchedulerConfigError(
                    f"extender {unsupported} is not supported: binding/"
                    "preemption are array scatter updates in this "
                    "simulator, not delegable side effects"
                )
        if e.get("enableHTTPS") and str(e["urlPrefix"]).startswith("http:"):
            raise SchedulerConfigError(
                "extender enableHTTPS=true with an http:// urlPrefix"
            )
        managed = tuple(
            str(m.get("name"))
            for m in (e.get("managedResources") or [])
            if isinstance(m, dict) and m.get("name")
        )
        # k8s validation requires a positive weight whenever prioritizeVerb
        # is set (ValidateExtender); coercing an explicit `weight: 0` to 1
        # would silently score with a weight the config never asked for
        weight = e.get("weight")
        if e.get("prioritizeVerb") and weight is not None and int(weight) < 1:
            raise SchedulerConfigError(
                f"extender weight must be a positive integer when "
                f"prioritizeVerb is set, got {weight!r}"
            )
        out.append(
            ExtenderConfig(
                url_prefix=str(e["urlPrefix"]),
                filter_verb=str(e.get("filterVerb") or ""),
                prioritize_verb=str(e.get("prioritizeVerb") or ""),
                weight=int(weight or 1),
                node_cache_capable=bool(e.get("nodeCacheCapable")),
                ignorable=bool(e.get("ignorable")),
                managed_resources=managed,
                http_timeout_s=_parse_duration_s(e.get("httpTimeout"), 30.0),
            )
        )
    return tuple(out)


_DURATION_UNITS = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3}


def _parse_duration_s(value, default: float) -> float:
    """httpTimeout is a metav1.Duration: a Go duration string ('30s',
    '1m30s', '500ms') in real configs; bare numbers are read as seconds."""
    if value is None or value == "":
        return default
    if isinstance(value, (int, float)):
        return float(value)
    import re as _re

    parts = _re.findall(r"(\d+(?:\.\d+)?)(h|ms|m|s)", str(value))
    if not parts or "".join(f"{n}{u}" for n, u in parts) != str(value):
        raise SchedulerConfigError(
            f"extender httpTimeout {value!r} is not a duration "
            "('30s', '1m30s', '500ms') or a number of seconds"
        )
    return sum(float(n) * _DURATION_UNITS[u] for n, u in parts)


def _validate_methods(cfg: SchedulerConfig) -> None:
    if cfg.dim_ext_method not in ("merge", "share", "divide", "extend"):
        raise SchedulerConfigError(f"bad dimExtMethod: {cfg.dim_ext_method}")
    if cfg.norm_method not in ("node", "pod", "max"):
        raise SchedulerConfigError(f"bad normMethod: {cfg.norm_method}")
    sel_ok = ("best", "worst", "random") + tuple(KNOWN_SCORE_PLUGINS)
    if cfg.gpu_sel_method not in sel_ok:
        raise SchedulerConfigError(f"bad gpuSelMethod: {cfg.gpu_sel_method}")


def load_scheduler_config(path: str = "") -> SchedulerConfig:
    if not path:
        return default_scheduler_config()
    from tpusim_torch.config.simon import load_yaml_lenient

    doc = load_yaml_lenient(path)
    if not isinstance(doc, dict):
        raise SchedulerConfigError(f"{path}: not a YAML mapping")
    return parse_scheduler_config(doc)
