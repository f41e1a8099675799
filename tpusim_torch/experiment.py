"""One experiment as experiments/run.py runs it, and a seed group of them
as one lanes launch (counterpart of experiments/run.py: get_args,
_build_sim, _post_run, run_experiment and the *_experiment_batch entries).

An experiment replays a pod trace on a node trace under one scheduling
method and writes <experiment dir>/simon.log and the analysis CSVs
(analysis.csv, analysis_frag.csv, _allo, _cdol, _pwr and, if a pod failed,
_fail), byte-identical to experiments/run.py's. A seed group (the same
experiment under several tuning seeds) runs its main replays as the lanes
of one launch (tpusim_torch.sim.driver.run_batch); each experiment's files
are those of its standalone run.

    from tpusim_torch import experiment
    experiment.run_experiment(experiment.get_args(
        ["-d", "out", "-FGD", "1000", "-gpusel", "FGDScore", "-tune", "1.3",
         "-tuneseed", "42", "--shuffle-pod", "true"]))

The flags are all of run.py's, with its defaults: the trace files, the
policy weights and methods, tuning, shuffling, inflation, descheduling
(-r/-p), the snapshot prefixes (-y/-z), the typical-pod knobs, timestamps,
the per-event report switch, --emit-configs and --analysis-from-log; and
--device (cuda by default). --engine takes tpusim's four engines (auto,
table or pallas: the port's kernels, table through the chunk surface;
sequential: its sequential oracle); --mesh above 1 raises
NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import time
from hashlib import md5
from pathlib import Path

from tpusim_torch.analysis import analyze_dir, analyze_sim
from tpusim_torch.io.trace import load_node_csv, load_pod_csv
from tpusim_torch.sim.driver import (
    PORT_ENGINES,
    Simulator,
    SimulatorConfig,
    dispatch_run_batch,
    finish_run_batch,
)
from tpusim_torch.sim.typical import TypicalPodsConfig

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "csv")

# score policy -> its weight flag, in experiments/run.py's order
POLICY_FLAGS = {
    "Simon": "Simon",
    "RandomScore": "Random",
    "DotProductScore": "DotProd",
    "GpuClusteringScore": "GpuClustering",
    "GpuPackingScore": "GpuPacking",
    "BestFitScore": "BestFit",
    "FGDScore": "FGD",
    "PWRScore": "PWR",
}


def resolve_trace(path_or_name: str) -> str:
    """A CSV path, or the name of a trace under data/csv."""
    if os.path.isfile(path_or_name):
        return path_or_name
    name = os.path.basename(path_or_name).replace(".csv", "")
    cand = os.path.join(_DATA, f"{name}.csv")
    if os.path.isfile(cand):
        return cand
    raise FileNotFoundError(f"trace not found: {path_or_name}")


def add_experiment_flags(ap: argparse.ArgumentParser) -> None:
    """The trace, report, device and method flags of every experiment
    entry, with experiments/run.py's defaults."""
    ap.add_argument("-f", "--trace", "--pods", dest="trace",
                    default="data/csv/openb_pod_list_default.csv",
                    help="pod-trace CSV, or a name like "
                    "openb_pod_list_default")
    ap.add_argument("--node-trace", "--nodes", dest="node_trace",
                    default="data/csv/openb_node_list_gpu_node.csv",
                    help="node-trace CSV")
    ap.add_argument("--use-timestamps", action="store_true",
                    help="replay creations and deletions in timestamp order")
    ap.add_argument("--no-per-event-report", action="store_true",
                    help="skip the per-event report lines")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("-r", "--deschedule-ratio", type=float, default=0.0)
    ap.add_argument("-p", "--deschedule-policy", default="",
                    help="cosSim | fragOnePod | fragMultiPod")
    ap.add_argument("-y", "--export-pod-snapshot-yaml-file-prefix",
                    default=None)
    ap.add_argument("-z", "--export-node-snapshot-csv-file-prefix",
                    default=None)
    ap.add_argument("--is-involved-cpu-pods", default="true")
    ap.add_argument("--pod-popularity-threshold", type=int, default=95)
    ap.add_argument("--pod-increase-step", type=int, default=1)
    ap.add_argument("--gpu-res-weight", type=float, default=0)
    ap.add_argument("--emit-configs", action="store_true",
                    help="also write the equivalent cluster and scheduler "
                    "config YAML")
    ap.add_argument("--engine", default="auto",
                    help="auto, table or pallas: the port's kernels (table "
                    "through the chunk surface); sequential: its sequential "
                    "oracle")
    ap.add_argument("--mesh", type=int, default=0,
                    help="0: one device (a mesh raises)")
    ap.add_argument("--analysis-from-log", action="store_true",
                    help="write the analysis CSVs by parsing simon.log "
                    "(the same bytes)")
    for flag in POLICY_FLAGS.values():
        ap.add_argument(f"-{flag}", type=int, default=0, help="score weight")
    ap.add_argument("-gpusel", "--gpu-sel-method", default="best",
                    help="best | worst | random | FGDScore | PWRScore | "
                    "DotProductScore")
    ap.add_argument("-dimext", "--dim-ext-method", default="share")
    ap.add_argument("-norm", "--norm-method", default="max")
    ap.add_argument("-tune", "--workload-tuning-ratio", type=float,
                    default=0)
    ap.add_argument("-tuneseed", "--workload-tuning-seed", type=int,
                    default=233)
    ap.add_argument("--shuffle-pod", default="false")
    ap.add_argument("--workload-inflation-ratio", type=float, default=1)
    ap.add_argument("-seed", "--workload-inflation-seed", type=int,
                    default=233)


def get_args(argv=None) -> argparse.Namespace:
    """experiments/run.py's flags, with its defaults."""
    ap = argparse.ArgumentParser(description="run one simulator experiment")
    ap.add_argument("-d", "--experiment-dir", default="./")
    add_experiment_flags(ap)
    return ap.parse_args(argv)


def selected_policies(args):
    """[(policy, weight)] of the weight flags above 0; FGDScore at 1000
    without any."""
    return [(name, getattr(args, flag)) for name, flag in POLICY_FLAGS.items()
            if getattr(args, flag) > 0] or [("FGDScore", 1000)]


_TRACE_CACHE = {}


def _load_trace_cached(path: str, loader):
    """A trace CSV's rows, parsed once per (path, mtime): every experiment
    of a sweep reads the same immutable rows."""
    key = (loader.__name__, path, os.path.getmtime(path))
    if key not in _TRACE_CACHE:
        _TRACE_CACHE[key] = loader(path)
    return list(_TRACE_CACHE[key])


def emit_configs(args, policies, outdir: Path):
    """Write the experiment as a Simon CR and a scheduler config, each
    named by the first four hex digits of its md5 (run.py's emit_configs,
    after generate_config_and_run.py's cc_/sc_ names)."""
    import yaml

    cc = {
        "apiVersion": "simon/v1alpha1",
        "kind": "Config",
        "metadata": {"name": "tpusim-experiment"},
        "spec": {
            "cluster": {"customConfig": str(args.trace)},
            "customConfig": {
                "shufflePod": args.shuffle_pod.lower() == "true",
                "useTimestamps": args.use_timestamps,
                "workloadInflationConfig": {
                    "ratio": args.workload_inflation_ratio,
                    "seed": args.workload_inflation_seed,
                },
                "workloadTuningConfig": {
                    "ratio": args.workload_tuning_ratio,
                    "seed": args.workload_tuning_seed,
                },
                "descheduleConfig": {
                    "ratio": args.deschedule_ratio,
                    "policy": args.deschedule_policy,
                },
                "typicalPodsConfig": {
                    "isInvolvedCpuPods": args.is_involved_cpu_pods.lower()
                    == "true",
                    "podPopularityThreshold": args.pod_popularity_threshold,
                    "podIncreaseStep": args.pod_increase_step,
                    "gpuResWeight": args.gpu_res_weight,
                },
            },
        },
    }
    sc = {
        "apiVersion": "kubescheduler.config.k8s.io/v1beta1",
        "kind": "KubeSchedulerConfiguration",
        "percentageOfNodesToScore": 100,
        "profiles": [{
            "schedulerName": "simon-scheduler",
            "plugins": {"score": {"enabled": [
                {"name": n, "weight": w} for n, w in policies]}},
            "pluginConfig": [{
                "name": "Open-Gpu-Share",
                "args": {
                    "dimExtMethod": args.dim_ext_method,
                    "normMethod": args.norm_method,
                    "gpuSelMethod": args.gpu_sel_method,
                },
            }],
        }],
    }
    for prefix, doc in (("cc", cc), ("sc", sc)):
        content = yaml.dump(doc)
        suffix = md5(content.encode()).hexdigest()[:4]
        (outdir / f"{prefix}_md{suffix}.yaml").write_text(content)


def check_engine_flags(args) -> None:
    """Raise ValueError for an --engine that is none of tpusim's, and
    NotImplementedError for a --mesh the port cannot run, naming the
    ROADMAP item that brings it."""
    engine = getattr(args, "engine", "auto")
    if engine not in PORT_ENGINES:
        raise ValueError(f"--engine {engine}: expected "
                         f"{' | '.join(PORT_ENGINES)}")
    if getattr(args, "mesh", 0) > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh} needs the mesh engine the PyTorch port does "
            "not have yet (ROADMAP queue 1, item 13 (mesh engine))")


def _build_sim(args):
    """The experiment's Simulator, its output directory, its pod CSV and
    its policies (the set-up half of run_experiment)."""
    check_engine_flags(args)
    outdir = Path(args.experiment_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    policies = selected_policies(args)
    if args.emit_configs:
        emit_configs(args, policies, outdir)
    sim, pod_csv, policies = _simulator(args)
    return sim, outdir, pod_csv, policies


def _simulator(args):
    """(the experiment's Simulator, its pod CSV, its policies)."""
    pod_csv = resolve_trace(args.trace)
    node_csv = resolve_trace(args.node_trace)
    policies = selected_policies(args)
    cfg = SimulatorConfig(
        policies=tuple(policies),
        gpu_sel_method=args.gpu_sel_method,
        dim_ext_method=args.dim_ext_method,
        norm_method=args.norm_method,
        shuffle_pod=args.shuffle_pod.lower() == "true",
        tuning_ratio=args.workload_tuning_ratio,
        tuning_seed=args.workload_tuning_seed,
        inflation_ratio=args.workload_inflation_ratio,
        inflation_seed=args.workload_inflation_seed,
        deschedule_ratio=args.deschedule_ratio,
        deschedule_policy=args.deschedule_policy,
        seed=args.workload_tuning_seed,
        report_per_event=not args.no_per_event_report,
        use_timestamps=args.use_timestamps,
        engine=getattr(args, "engine", "auto"),
        typical_pods=TypicalPodsConfig(
            is_involved_cpu_pods=args.is_involved_cpu_pods.lower() == "true",
            pod_popularity_threshold=args.pod_popularity_threshold,
            pod_increase_step=args.pod_increase_step,
            gpu_res_weight=args.gpu_res_weight,
        ),
    )
    sim = Simulator(_load_trace_cached(node_csv, load_node_csv), cfg,
                    device=args.device)
    sim.set_workload_pods(_load_trace_cached(pod_csv, load_pod_csv))
    return sim, pod_csv, policies


def post_schedule_stages(sim, args) -> None:
    """run.py's stages after the main schedule, in its order: inflation,
    then the descheduler with its PostDeschedule analysis and, with
    inflation, DescheduleInflation, then the snapshot exports."""
    if args.workload_inflation_ratio > 1:
        sim.run_workload_inflation_evaluation("ScheduleInflation")
    if args.deschedule_ratio > 0 and args.deschedule_policy:
        sim.deschedule_cluster()
        sim.cluster_analysis("PostDeschedule")
        if args.workload_inflation_ratio > 1:
            sim.run_workload_inflation_evaluation("DescheduleInflation")
    if args.export_pod_snapshot_yaml_file_prefix:
        path = f"{args.export_pod_snapshot_yaml_file_prefix}.yaml"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        sim.export_pod_snapshot_yaml(path)
    if args.export_node_snapshot_csv_file_prefix:
        path = f"{args.export_node_snapshot_csv_file_prefix}.csv"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        sim.export_node_snapshot_csv(path)


def _post_run(sim, args, outdir, pod_csv, policies, t0) -> dict:
    """Everything after the main schedule: the later stages, the stop
    marker, simon.log and the analysis CSVs (the tail half of
    run_experiment)."""
    post_schedule_stages(sim, args)
    sim.finish()
    wall = time.perf_counter() - t0
    log_path = outdir / "simon.log"
    with open(log_path, "w") as f:
        f.write(sim.log.dump())
    print(f"[run] {log_path} ({wall:.1f}s, {sim.last_result.events} events)")
    meta = {
        "workload": Path(pod_csv).stem,
        "policy": "_".join(f"{POLICY_FLAGS[n]}{w}" for n, w in policies),
        "tune": args.workload_tuning_ratio,
        "tune_seed": args.workload_tuning_seed,
        "de": args.dim_ext_method,
        "gs": args.gpu_sel_method,
        "dr": args.deschedule_ratio,
        "dp": args.deschedule_policy,
    }
    if args.analysis_from_log:
        return analyze_dir(str(outdir), meta)
    return analyze_sim(sim, str(outdir), meta)


def run_experiment(args) -> dict:
    """One experiment: its Simulator's run(), then _post_run."""
    sim, outdir, pod_csv, policies = _build_sim(args)
    t0 = time.perf_counter()
    sim.run()
    return _post_run(sim, args, outdir, pod_csv, policies, t0)


def dispatch_experiment_batch(args_list) -> dict:
    """The set-up of a seed group (the same trace, method and knobs under
    different seeds) and the launch of its replays as one lanes launch.
    The launch is asynchronous: the caller may finish another group's
    files while the lanes run (finish_experiment_batch waits)."""
    t0 = time.perf_counter()
    built = [_build_sim(a) for a in args_list]
    handle = dispatch_run_batch([b[0] for b in built])
    return {"args_list": args_list, "built": built, "handle": handle,
            "prep_s": time.perf_counter() - t0}


def finish_experiment_batch(st: dict) -> list:
    """Wait for a dispatch_experiment_batch handle and write each
    experiment's files."""
    t_fin = time.perf_counter()
    finish_run_batch(st["handle"])
    shared = (st["prep_s"] + time.perf_counter() - t_fin) / len(st["built"])
    return [_post_run(sim, args, outdir, pod_csv, policies,
                      time.perf_counter() - shared)
            for args, (sim, outdir, pod_csv, policies)
            in zip(st["args_list"], st["built"])]


def run_experiment_batch(args_list) -> list:
    """A seed group through one lanes launch; each experiment's files are
    those of run_experiment."""
    return finish_experiment_batch(dispatch_experiment_batch(args_list))


if __name__ == "__main__":
    run_experiment(get_args())
