"""Applier: the Simon-CR-driven experiment (counterpart of tpusim/apply.py;
ref: pkg/apply/apply.go Run() and pkg/simulator/core.go Simulate()).

  load the CR and the scheduler config → load the cluster's YAML directory
  (or a live cluster through a kubeconfig credential file, or an offline
  kubeConfig dump) → daemonset pods → typical pods →
  sort/tune the workload → replay (under the --fault-* schedule, if any) →
  ClusterAnalysis(InitSchedule) → snapshot export → inflation evaluation →
  new-workload swap → deschedule and reschedule (PostEviction,
  PostDeschedule, their snapshots, DescheduleInflation) → per-app
  scheduling (YAML apps and Helm charts) → the verdict → the report tables;
  or, with --sweep-weights, one sweep over a weight grid, or with
  --sweep-faults, one chaos sweep over fault schedules, in place of the
  replay and the stages after it.

Every replay runs the port's kernels (`Simulator`), or its sequential
oracle under `customConfig.engine: sequential`, or the extender host loop
when the scheduler config has `extenders:`: on the GPU unless the options
ask for the CPU. Options that need a plane the port does not have
yet raise NotImplementedError naming the ROADMAP item that brings it; none
is ignored. The env caps MaxCPU/MaxMemory/MaxVG (apply.go:550-631
satisfyResourceSetting) decide the verdict; MaxVG reads the open-local VG
totals from the node storage annotations.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from tpusim_torch.config.scheduler import SchedulerConfig, load_scheduler_config
from tpusim_torch.config.simon import SimonCR, load_simon_cr
from tpusim_torch.io.chart import chart_objects
from tpusim_torch.io.k8s_yaml import (
    daemonset_pods,
    load_cluster_from_dir,
    load_cluster_from_dump,
    load_cluster_from_objects,
    load_objects,
    yaml_files_in_dir,
)
from tpusim_torch.io.kube_client import (
    is_kubeconfig_file,
    load_cluster_from_client,
)
from tpusim_torch.io.storage import cluster_vg_totals, parse_node_storage
from tpusim_torch.sim.driver import (
    PORT_ENGINES,
    SimulateResult,
    Simulator,
    SimulatorConfig,
    enable_compile_cache,
    format_chaos_table,
    format_sweep_table,
)
from tpusim_torch.sim.faults import FaultConfig
from tpusim_torch.sim.report_tables import full_report

COLOR_RED = "\033[31m"
COLOR_GREEN = "\033[32m"
COLOR_RESET = "\033[0m"


@dataclass
class ApplyOptions:
    """The CLI surface (ref: cmd/apply/apply.go:26-40), with tpusim's
    options. `sweep_weights` (a weight-grid JSON, load_weights_payload)
    replaces the main schedule with a config sweep, `sweep_faults` (a
    faults JSON, load_faults_payload) with a chaos sweep; the `fault_*`
    options replay it under a seeded fault schedule
    (Simulator.run_with_faults).
    The others after `table_residency` are the planes the port does not
    have yet: any value but the default raises (REFUSED_OPTIONS)."""

    simon_config: str = ""
    default_scheduler_config: str = ""
    use_greed: bool = False
    interactive: bool = False
    extended_resources: List[str] = field(default_factory=lambda: ["gpu"])
    base_dir: str = "."
    report_tables: bool = False
    # where the replays run: "cuda" (the kernels) or "cpu" (their plain
    # versions)
    device: str = "cuda"
    # SimulatorConfig.table_residency: auto | vmem | hbm
    table_residency: str = "auto"
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    checkpoint_keep: int = 0
    fault_mtbf: float = 0.0
    fault_mttr: float = 0.0
    fault_evict_every: float = 0.0
    fault_seed: int = 0
    fault_max_retries: int = 3
    profile_out: str = ""
    metrics_out: str = ""
    trace_out: str = ""
    heartbeat_every: int = 0
    decisions_out: str = ""
    series_every: int = 0
    listen: str = ""
    sweep_weights: str = ""
    sweep_faults: str = ""
    compile_cache_dir: str = ""
    policy: str = ""


# option -> (its flag, the ROADMAP queue-1 item that brings its plane)
REFUSED_OPTIONS = {
    "listen": ("--listen", "14 (service plane)"),
}


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} needs a plane the PyTorch port does not have yet "
        f"(ROADMAP queue 1, item {item}); run it with `python -m tpusim "
        "apply`")


def check_port_options(options: ApplyOptions) -> None:
    """Raise NotImplementedError for any option the port cannot honour."""
    defaults = ApplyOptions()
    for name, (flag, item) in REFUSED_OPTIONS.items():
        if getattr(options, name) != getattr(defaults, name):
            _refuse(flag, item)


def _lanes_ran(sim: Simulator) -> str:
    """How a sweep's lanes ran, for the [Sweep] and [Chaos] lines: one
    launch of a lanes kernel, or the sequential oracle a lane at a time."""
    if sim.last_residency is None:
        return f"a lane at a time ({sim.last_engine} host loop)"
    return (f"in one launch ({sim.last_engine}, {sim.last_residency} "
            "residency)")


class Applier:
    def __init__(self, options: ApplyOptions):
        if not options.simon_config:
            raise ValueError("--simon-config is required")
        check_port_options(options)
        self.options = options
        self.cr: SimonCR = load_simon_cr(options.simon_config, options.base_dir)
        self.sched_cfg: SchedulerConfig = load_scheduler_config(
            options.default_scheduler_config
        )
        cc = self.cr.custom_config
        if cc.engine not in PORT_ENGINES:
            raise ValueError(
                f"customConfig.engine {cc.engine!r}: expected "
                f"{' | '.join(PORT_ENGINES)}")
        if cc.mesh > 1:
            _refuse(f"customConfig.mesh {cc.mesh}", "13 (mesh engine)")

    def _simulator_config(self) -> SimulatorConfig:
        cc = self.cr.custom_config
        policies = self.sched_cfg.policy_tuple()
        gpu_sel = self.sched_cfg.gpu_sel_method
        if self.options.policy:
            # --policy replaces the scheduler config's plugin family
            # (learn.policy.parse_policy_spec); a gpuSelMethod delegating
            # to a plugin the override removed falls back to best, loudly
            # (tpusim/apply.py:138-154)
            from tpusim_torch.learn.policy import parse_policy_spec

            policies = tuple(parse_policy_spec(self.options.policy))
            if gpu_sel not in ("best", "worst", "random") and gpu_sel not in {
                n for n, _ in policies
            }:
                print(
                    f"[policy] gpuSelMethod {gpu_sel!r} delegates to a "
                    "plugin the --policy override removed; using 'best'",
                    file=sys.stderr,
                )
                gpu_sel = "best"
        return SimulatorConfig(
            policies=policies,
            gpu_sel_method=gpu_sel,
            dim_ext_method=self.sched_cfg.dim_ext_method,
            norm_method=self.sched_cfg.norm_method,
            shuffle_pod=cc.shuffle_pod,
            tuning_ratio=cc.tuning.ratio,
            tuning_seed=cc.tuning.seed,
            inflation_ratio=cc.inflation.ratio,
            inflation_seed=cc.inflation.seed,
            typical_pods=cc.typical_pods,
            deschedule_ratio=cc.deschedule.ratio,
            deschedule_policy=cc.deschedule.policy,
            use_timestamps=cc.use_timestamps,
            table_residency=self.options.table_residency,
            engine=cc.engine,
            extenders=self.sched_cfg.extenders,
            checkpoint_every=self.options.checkpoint_every,
            checkpoint_dir=self.options.checkpoint_dir,
            checkpoint_keep=self.options.checkpoint_keep,
            compile_cache_dir=self.options.compile_cache_dir,
            profile=bool(self.options.profile_out or self.options.metrics_out
                         or self.options.trace_out),
            heartbeat_every=self.options.heartbeat_every,
            record_decisions=bool(self.options.decisions_out),
            series_every=self.options.series_every,
        )

    def _fault_config(self):
        """The FaultConfig of the --fault-* flags, or None when no failure
        or eviction rate is set."""
        o = self.options
        if o.fault_mtbf <= 0 and o.fault_evict_every <= 0:
            return None
        return FaultConfig(
            mtbf_events=o.fault_mtbf,
            mttr_events=o.fault_mttr,
            evict_every_events=o.fault_evict_every,
            seed=o.fault_seed,
            max_retries=o.fault_max_retries,
        )

    def _load_cluster(self):
        """The cluster's objects: the CR's YAML directory, or its
        kubeConfig path: a kubeconfig credential file names a live cluster,
        listed through the kube-client loader (io.kube_client), anything
        else is read as a `kubectl get ... -o yaml` dump."""
        if not self.cr.kube_config:
            return load_cluster_from_dir(self.cr.custom_cluster)
        if is_kubeconfig_file(self.cr.kube_config):
            cluster = load_cluster_from_client(self.cr.kube_config)
        else:
            cluster = load_cluster_from_dump(self.cr.kube_config)
        if not cluster.nodes:
            raise ValueError(
                f"no Node objects from kubeConfig {self.cr.kube_config}")
        return cluster

    def _load_apps(self, node_names: Sequence[str]) -> List[tuple]:
        """appList → [(name, pods)] (apply.go:118-141; Helm charts render
        through tpusim_torch.io.chart). App DaemonSets expand over the
        CLUSTER's nodes, which an app-only ClusterResource does not know
        about."""
        apps = []
        for app in self.cr.app_list:
            if app.chart:
                objs = chart_objects(app.name, app.path)
            else:
                objs = load_objects(yaml_files_in_dir(app.path))
            res = load_cluster_from_objects(objs)
            pods = list(res.workload_pods())
            for ds in res.daemonsets:
                pods.extend(daemonset_pods(ds, node_names))
            apps.append((app.name, pods))
        if self.options.interactive and apps:
            apps = _interactive_select(apps)
        return apps

    @contextlib.contextmanager
    def _timed(self, stage: str):
        """Add the block's host milliseconds to timings[stage + "_ms"]."""
        t0 = time.perf_counter()
        yield
        key = f"{stage}_ms"
        self.timings[key] = (self.timings.get(key, 0.0)
                             + (time.perf_counter() - t0) * 1e3)

    def run(self, out=None) -> SimulateResult:
        """The whole experiment, its log streamed to `out` (standard output
        by default). `timings` then holds the host milliseconds of each
        stage (ingest: the cluster's YAML; main: the Simulator and its
        run() or run_with_faults(); export; inflation; swap; deschedule;
        apps_ingest: the apps' YAML and charts; apps; tables) and of the whole run (wall); the Simulator's
        `replay_times` split each replay."""
        out = sys.stdout if out is None else out
        self.timings = {}
        t0 = time.perf_counter()
        # where the kernels' library is built (tpusim's compile cache line)
        cache_dir = enable_compile_cache(self.options.compile_cache_dir)
        if cache_dir:
            print(f"[obs] compile cache at {cache_dir}", file=out)
        with self._timed("ingest"):
            cluster = self._load_cluster()
        if not cluster.nodes:
            raise ValueError(f"no Node manifests under {self.cr.custom_cluster}")
        cc = self.cr.custom_config

        with self._timed("main"):
            sim = Simulator(cluster.nodes, self._simulator_config(),
                            device=self.options.device)
            sim.log.stream = out
            self.sim = sim
            # workload = trace pods + per-node daemonset pods
            # (core.go:103-123)
            sim.set_workload_pods(cluster.workload_pods()
                                  + cluster.daemonset_pods())
            fault_cfg = self._fault_config()
            if self.options.sweep_faults:
                # the chaos sweep replaces the main schedule: one lanes
                # launch over the fault schedules, the disruption frontier
                if self.options.sweep_weights:
                    raise ValueError(
                        "--sweep-faults and --sweep-weights are separate "
                        "sweep axes; pass per-lane weights inside the "
                        "faults JSON instead"
                    )
                if fault_cfg is not None:
                    raise ValueError(
                        "--sweep-faults replaces the --fault-* flags (each "
                        "lane carries its own schedule)"
                    )
            if self.options.sweep_weights and fault_cfg is not None:
                raise ValueError(
                    "--sweep-weights cannot combine with fault injection "
                    "(the sweep replays a single uninterrupted event "
                    "stream per config)"
                )
            if self.options.sweep_faults:
                self._run_chaos(sim, out)
            elif self.options.sweep_weights:
                # the config sweep replaces the main schedule: one lanes
                # launch over the weight grid and its table, no snapshot,
                # inflation or app stages (they describe one placement)
                self._run_sweep(sim, out)
            elif fault_cfg is not None:
                sim.run_with_faults(fault_cfg)
            else:
                sim.run()
        if self.options.sweep_weights or self.options.sweep_faults:
            self.timings["wall_ms"] = (time.perf_counter() - t0) * 1e3
            return None

        # snapshot export at InitSchedule (core.go:160-185)
        with self._timed("export"):
            self._export_snapshots(sim, "init_schedule")

        # workload inflation eval (core.go:189-192)
        if cc.inflation.ratio > 1:
            with self._timed("inflation"):
                sim.run_workload_inflation_evaluation("ScheduleInflation")

        # new-workload swap (core.go:195-209): replace the typical-pod
        # distribution with the new workload's, then schedule it on top
        if cc.new_workload_config:
            with self._timed("swap"):
                nw_dir = cc.new_workload_config
                if not os.path.isabs(nw_dir):
                    nw_dir = os.path.join(self.options.base_dir, nw_dir)
                nw_pods = load_cluster_from_dir(nw_dir).workload_pods()
                sim.set_workload_pods(nw_pods)
                sim.set_typical_pods()
                sim.schedule_additional(nw_pods)
                sim.cluster_analysis("InitSchedule")

        # deschedule and reschedule (core.go:213-246)
        if cc.deschedule.ratio > 0 and cc.deschedule.policy:
            with self._timed("deschedule"):
                sim.deschedule_cluster()
                sim.cluster_analysis("PostDeschedule")
                self._export_snapshots(sim, "post_deschedule")
                if cc.inflation.ratio > 1:
                    sim.run_workload_inflation_evaluation(
                        "DescheduleInflation")

        # per-app scheduling (core.go:255-261)
        with self._timed("apps_ingest"):
            apps = self._load_apps(cluster.node_names)
        for name, pods in apps:
            with self._timed("apps"):
                sim.schedule_app(name, pods, self.options.use_greed)

        result = sim.last_result
        sim.finish()
        self._note_compile_cache(sim)
        self._emit_telemetry(sim, out)
        self._emit_decisions(sim, out)
        self._verdict(result, out)
        if self.options.report_tables:
            with self._timed("tables"):
                print(full_report(result.pods, result.placed_node,
                                  result.dev_mask, cluster.nodes,
                                  self.options.extended_resources), file=out)
        self.timings["wall_ms"] = (time.perf_counter() - t0) * 1e3
        return result

    def _run_sweep(self, sim: Simulator, out):
        """`apply --sweep-weights`: load the weight grid, run the sweep
        (per-lane `tunes` through the multi-trace sweep) and print the
        per-config table."""
        weights, seeds, tunes = load_weights_payload(
            self.options.sweep_weights)
        lanes = sim.run_sweep(weights, seeds=seeds, tunes=tunes)
        print(f"[Sweep] {len(lanes)} configs x {lanes[0].events} events "
              f"{_lanes_ran(sim)}", file=out)
        print(format_sweep_table(lanes, sim.cfg.policies), file=out)
        self._note_compile_cache(sim)
        self._emit_telemetry(sim, out)

    def _run_chaos(self, sim: Simulator, out):
        """`apply --sweep-faults`: load the lanes' fault documents, run the
        chaos sweep (one lanes launch of the fault forms) and print the
        per-lane disruption frontier (README "Chaos sweep"; the [Chaos]
        line names the kernel, as the [Sweep] line does)."""
        specs, weights, seeds = load_faults_payload(
            self.options.sweep_faults, sim.cfg.policies)
        lanes = sim.run_sweep(weights, seeds=seeds, faults=specs)
        print(f"[Chaos] {len(lanes)} fault lanes x {lanes[0].events} events "
              f"{_lanes_ran(sim)}", file=out)
        print(format_chaos_table(lanes, sim.cfg.policies), file=out)
        self._note_compile_cache(sim)
        self._emit_telemetry(sim, out)

    def _note_compile_cache(self, sim: Simulator):
        """The build-cache note of the run's telemetry (the JSONL record's
        timing.compile_cache; obs.spans.note_compile_cache)."""
        from tpusim_torch.obs import note_compile_cache

        cache_dir = self.options.compile_cache_dir or os.environ.get(
            "TPUSIM_COMPILE_CACHE_DIR", "")
        note_compile_cache(sim.obs, enabled=bool(cache_dir),
                           cache_dir=cache_dir)

    def _series_block(self, sim: Simulator):
        """The run's series as a JSONL record block, or None when the
        series was off (no key then)."""
        res = getattr(sim, "last_result", None)
        if res is None or res.series is None:
            return None
        from tpusim_torch.obs.series import series_to_record

        return series_to_record(res.series, sim.cfg.series_every,
                                [name for name, _ in sim.cfg.policies])

    def _emit_telemetry(self, sim: Simulator, out):
        """Write --profile (the JSONL run record, appended), --metrics-out
        (the Prometheus textfile) and --trace-out (the Chrome trace, with
        the post-pass's frag/alloc counter tracks and the series' tracks)
        from the whole experiment's telemetry: every stage added its spans
        and counters to the one recorder."""
        o = self.options
        if not (o.profile_out or o.metrics_out or o.trace_out):
            return
        from tpusim_torch.obs import emitters

        telemetry = sim.run_telemetry()
        record = emitters.build_record(telemetry,
                                       series=self._series_block(sim))
        counter_series = None
        if o.trace_out:
            counter_series = sim.event_counter_series()
            last = getattr(sim, "last_result", None)
            if last is not None and last.series is not None:
                from tpusim_torch.obs.series import series_tracks

                counter_series.update(series_tracks(last.series))
        paths = emitters.emit_record(
            record, telemetry.spans, jsonl=o.profile_out,
            metrics=o.metrics_out, trace=o.trace_out,
            counter_series=counter_series)
        for p in paths:
            print(f"[obs] wrote {p}", file=out)

    def _emit_decisions(self, sim: Simulator, out):
        """Write the run's decision stream (--decisions-out), the input of
        `explain` and `diff`."""
        path = self.options.decisions_out
        if not path:
            return
        from tpusim_torch.obs import decisions as obs_decisions

        res = sim.last_result
        if res.decisions is None:
            print("[obs] no decision stream recorded (engine without "
                  "provenance support?)", file=out)
            return
        written = obs_decisions.write_decisions(
            path, res.decisions, policies=list(sim.cfg.policies),
            meta=sim._telemetry_meta(),
            pod_names=[p.name for p in res.pods])
        print(f"[obs] wrote {written}", file=out)

    def _export_snapshots(self, sim: Simulator, tag: str):
        exp = self.cr.custom_config.export
        if exp.pod_snapshot_yaml_file_prefix:
            path = f"{exp.pod_snapshot_yaml_file_prefix}_{tag}.yaml"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            sim.export_pod_snapshot_yaml(path)
        if exp.node_snapshot_csv_file_prefix:
            path = f"{exp.node_snapshot_csv_file_prefix}_{tag}.csv"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            sim.export_node_snapshot_csv(path)
            sim.export_pod_snapshot_csv(
                f"{exp.node_snapshot_csv_file_prefix}_{tag}_pod.csv")

    def _verdict(self, result: SimulateResult, out):
        """Success print + env resource caps (apply.go:219-246, 550-631)."""
        if result.unscheduled_pods:
            print(f"{COLOR_RED}there are {len(result.unscheduled_pods)} "
                  f"unscheduled pods{COLOR_RESET}", file=out)
            print(f"{COLOR_RED}Failed!{COLOR_RESET}", file=out)
            return
        ok, reason = self._satisfy_resource_setting(result)
        if not ok:
            print(f"{COLOR_RED}{reason}{COLOR_RESET}", file=out)
            print(f"{COLOR_RED}Failed!{COLOR_RESET}", file=out)
        else:
            print(f"{COLOR_GREEN}Success!{COLOR_RESET}", file=out)

    def _satisfy_resource_setting(self, result: SimulateResult):
        """Env caps MaxCPU / MaxMemory / MaxVG as PERCENT occupancy-rate
        ceilings over cluster totals (ref: satisfyResourceSetting,
        apply.go:550-631: defaults 100, out-of-range values clamp to 100;
        VG totals come from the open-local node storage annotations)."""

        def _cap(env: str) -> int:
            raw = os.environ.get(env, "")
            if not raw:
                return 100
            v = int(raw)  # non-integers are an error in the reference too
            return 100 if v > 100 or v < 0 else v

        max_cpu, max_mem, max_vg = (_cap("MaxCPU"), _cap("MaxMemory"),
                                    _cap("MaxVG"))
        s = result.state
        cpu_cap, cpu_left = s.cpu_cap.numpy(), s.cpu_left.numpy()
        mem_cap, mem_left = s.mem_cap.numpy(), s.mem_left.numpy()
        cpu_rate = int(100.0 * (cpu_cap - cpu_left).sum()
                       / max(1, cpu_cap.astype(np.int64).sum()))
        mem_rate = int(100.0 * (mem_cap - mem_left).sum()
                       / max(1, mem_cap.astype(np.int64).sum()))
        if cpu_rate > max_cpu:
            return False, (
                f"the average occupancy rate({cpu_rate}%) of cpu goes beyond "
                f"the env setting({max_cpu}%)\n"
            )
        if mem_rate > max_mem:
            return False, (
                f"the average occupancy rate({mem_rate}%) of memory goes "
                f"beyond the env setting({max_mem}%)\n"
            )
        vg_req, vg_cap = cluster_vg_totals(
            parse_node_storage(n.local_storage) for n in self.sim.nodes
        )
        if vg_cap:
            vg_rate = int(100.0 * vg_req / vg_cap)
            if vg_rate > max_vg:
                return False, (
                    f"the average occupancy rate({vg_rate}%) of vg goes "
                    f"beyond the env setting({max_vg}%)\n"
                )
        return True, ""


def save_weights_payload(path: str, weights, seeds=None, tunes=None,
                         policies=None) -> str:
    """Write a weight-grid JSON in the shape load_weights_payload reads
    (tpusim/apply.py save_weights_payload, the same bytes): `tune
    --best-out` writes its tuned vector here. Atomic (tmp + rename)."""
    import json

    doc = {"weights": [[int(w) for w in row] for row in weights]}
    if seeds is not None:
        doc["seeds"] = [int(s) for s in seeds]
    if tunes is not None:
        doc["tunes"] = [float(t) for t in tunes]
    if policies is not None:
        doc["policies"] = [[str(n), int(w)] for n, w in policies]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_weights_payload(path: str):
    """Weight-grid JSON -> (weights, seeds, tunes): a bare [[w, ...], ...]
    list of rows, or {"weights": [[...]], "seeds": [...], "tunes": [...]}
    with the optional per-row seeds and tuning ratios."""
    import json

    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        weights = payload.get("weights")
        seeds = payload.get("seeds")
        tunes = payload.get("tunes")
    else:
        weights, seeds, tunes = payload, None, None
    if not weights:
        raise ValueError(
            f"{path}: no weight rows (want [[w, ...], ...] or "
            '{"weights": [[...]], "seeds": [...], "tunes": [...]})'
        )
    return weights, seeds, tunes


# every key a chaos lane's fault document may carry: FaultConfig's field
# names exactly; an unknown key is refused (a misspelt "mtbf" must not run
# a fault-free lane)
FAULT_PAYLOAD_KEYS = frozenset((
    "mtbf_events", "mttr_events", "evict_every_events", "seed",
    "max_retries", "backoff_base", "backoff_cap", "queue_capacity",
))


def load_faults_payload(path: str, policies):
    """Chaos-sweep JSON -> (fault_specs, weights, seeds) for
    Simulator.run_sweep(faults=...): a bare [{...FaultConfig fields...},
    ...] list of the lanes' fault documents, or {"faults": [...],
    "weights": [[...]], "seeds": [...]} with optional per-lane weight rows
    and seeds (by default the scheduler config's weights and cfg.seed for
    every lane)."""
    import json

    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        docs = payload.get("faults")
        weights = payload.get("weights")
        seeds = payload.get("seeds")
        unknown = set(payload) - {"faults", "weights", "seeds"}
        if unknown:
            raise ValueError(
                f"{path}: unknown key(s) {sorted(unknown)} (known: "
                "faults, weights, seeds)"
            )
    else:
        docs, weights, seeds = payload, None, None
    if not isinstance(docs, list) or not docs:
        raise ValueError(
            f"{path}: no fault lanes (want [{{...FaultConfig fields...}}, "
            '...] or {"faults": [...], "weights": [[...]], "seeds": [...]})'
        )
    specs = []
    for i, doc in enumerate(docs):
        if not isinstance(doc, dict):
            raise ValueError(f"{path}: fault lane {i} must be an object")
        unknown = set(doc) - FAULT_PAYLOAD_KEYS
        if unknown:
            raise ValueError(
                f"{path}: fault lane {i} has unknown key(s) "
                f"{sorted(unknown)} (known: {sorted(FAULT_PAYLOAD_KEYS)})"
            )
        specs.append(FaultConfig(**doc))
    if weights is None:
        weights = [[w for _, w in policies]] * len(specs)
    if len(weights) != len(specs):
        raise ValueError(
            f"{path}: {len(weights)} weight rows for {len(specs)} fault "
            "lanes"
        )
    return specs, weights, seeds


def _interactive_select(apps):
    """Multi-select confirmation (apply.go:172-189, survey lib)."""
    print("Confirm your apps (comma-separated indices, empty = all):")
    for i, (name, pods) in enumerate(apps):
        print(f"  [{i}] {name} ({len(pods)} pods)")
    line = input("> ").strip()
    if not line:
        return apps
    picked = {int(x) for x in line.split(",") if x.strip().isdigit()}
    return [a for i, a in enumerate(apps) if i in picked]
