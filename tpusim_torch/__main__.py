"""Replay a trace under one scheduling method; print the log, or write the
experiment's log and analysis CSVs.

    python -m tpusim_torch [-FGD W] [-PWR W] [-BestFit W] [-GpuPacking W]
        [-GpuClustering W] [-DotProd W] [-gpusel SEL] [-dimext M] [-norm M]
        [-tune R] [-tuneseed S] [--shuffle-pod true|false]
        [--workload-inflation-ratio R] [-seed S]
        [-f POD_TRACE] [--node-trace NODE_CSV] [--use-timestamps]
        [--no-per-event-report] [-d EXPERIMENT_DIR] [--device cpu]
    python -m tpusim_torch apply ...   (python -m tpusim_torch.cli apply)

The method flags are those of experiments/run.py: one integer weight per
score policy, the gpuSelMethod, and DotProduct's dim-ext and norm methods.
With no policy flag the run is the paper's FGD configuration (FGDScore at
weight 1000, gpu_sel FGDScore); the other rows of the paper's method list
are, for example, `-BestFit 1000` or `-PWR 500 -FGD 500 -gpusel FGDScore`.
Pods are shuffled and tuned to 1.3 x the cluster's GPU capacity with seed
42 unless the flags say otherwise; the node tie-break uses the tuning seed;
the typical pods are experiments/run.py's (popularity 95, step 1). A
--workload-inflation-ratio above 1 adds run.py's inflation stage after the
main replay (ScheduleInflation, seeded by -seed).
The trace flags take a CSV path or a name under data/csv (as
experiments/run.py's do; --pods and --nodes are their other names). Each
event prints its report block unless --no-per-event-report is given.

Without -d it prints the analysis log, whose last block is the Cluster
Analysis. With -d it writes <dir>/simon.log and the analysis CSVs
(analysis.csv, analysis_frag.csv, _allo, _cdol, _pwr and, if a pod failed,
_fail) as experiments/run.py does, with the same meta columns. The replay
runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

from tpusim_torch.analysis import analyze_sim
from tpusim_torch.io.trace import load_node_csv, load_pod_csv
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.typical import TypicalPodsConfig

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "csv")

# score policy -> its weight flag, in experiments/run.py's order
POLICY_FLAGS = {
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


# experiments/run.py's typical-pod settings (its flags' defaults)
RUN_TYPICAL = TypicalPodsConfig(pod_popularity_threshold=95,
                                pod_increase_step=1)


def method_config(policies=(("FGDScore", 1000),), gpu_sel="FGDScore",
                  dim_ext="share", norm="max", tune=1.3, tune_seed=42,
                  shuffle=True, report_per_event=True, use_timestamps=False,
                  typical: TypicalPodsConfig = None) -> SimulatorConfig:
    """One experiment of the paper's protocol: the given method on openb,
    typical pods at popularity 95 (unless `typical` says otherwise), the
    tie-break seeded with the tuning seed. The defaults are the paper's FGD
    configuration."""
    return SimulatorConfig(
        policies=tuple(policies),
        gpu_sel_method=gpu_sel,
        dim_ext_method=dim_ext,
        norm_method=norm,
        shuffle_pod=shuffle,
        tuning_ratio=tune,
        tuning_seed=tune_seed,
        seed=tune_seed,
        report_per_event=report_per_event,
        use_timestamps=use_timestamps,
        typical_pods=typical or TypicalPodsConfig(
            pod_popularity_threshold=95),
    )


def paper_config() -> SimulatorConfig:
    """The openb FGD configuration bench.py measures."""
    return method_config()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["apply"]:
        from tpusim_torch.cli import main as cli_main

        return cli_main(argv)
    ap = argparse.ArgumentParser(prog="python -m tpusim_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("-d", "--experiment-dir", default=None,
                    help="write simon.log and the analysis CSVs here")
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
    for flag in POLICY_FLAGS.values():
        ap.add_argument(f"-{flag}", type=int, default=0, help="score weight")
    ap.add_argument("-gpusel", "--gpu-sel-method", default=None,
                    help="best | worst | FGDScore | PWRScore | "
                    "DotProductScore (default: FGDScore without policy "
                    "flags, else best)")
    ap.add_argument("-dimext", "--dim-ext-method", default="share")
    ap.add_argument("-norm", "--norm-method", default="max")
    ap.add_argument("-tune", "--workload-tuning-ratio", type=float,
                    default=1.3)
    ap.add_argument("-tuneseed", "--workload-tuning-seed", type=int,
                    default=42)
    ap.add_argument("--shuffle-pod", default="true")
    ap.add_argument("--workload-inflation-ratio", type=float, default=1.0)
    ap.add_argument("-seed", "--workload-inflation-seed", type=int,
                    default=233)
    args = ap.parse_args(argv)
    flagged = [(name, getattr(args, flag))
               for name, flag in POLICY_FLAGS.items()
               if getattr(args, flag) > 0]
    gpu_sel = args.gpu_sel_method or ("best" if flagged else "FGDScore")
    policies = flagged or [("FGDScore", 1000)]
    cfg = method_config(
        policies, gpu_sel, args.dim_ext_method, args.norm_method,
        args.workload_tuning_ratio, args.workload_tuning_seed,
        args.shuffle_pod.lower() == "true", not args.no_per_event_report,
        args.use_timestamps, RUN_TYPICAL)
    cfg.inflation_ratio = args.workload_inflation_ratio
    cfg.inflation_seed = args.workload_inflation_seed
    pod_csv = resolve_trace(args.trace)
    sim = Simulator(load_node_csv(resolve_trace(args.node_trace)), cfg,
                    device=args.device)
    sim.set_workload_pods(load_pod_csv(pod_csv))
    t0 = time.perf_counter()
    sim.run()
    if cfg.inflation_ratio > 1:
        sim.run_workload_inflation_evaluation("ScheduleInflation")
    if args.experiment_dir is None:
        sys.stdout.write(sim.log.dump())
        return 0
    # experiments/run.py's _post_run: the stop marker, the log, the CSVs
    sim.finish()
    out = Path(args.experiment_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "simon.log", "w") as f:
        f.write(sim.log.dump())
    print(f"[run] {out / 'simon.log'} ({time.perf_counter() - t0:.1f}s, "
          f"{sim.last_result.events} events)")
    analyze_sim(sim, str(out), {
        "workload": Path(pod_csv).stem,
        "policy": "_".join(f"{POLICY_FLAGS[n]}{w}" for n, w in policies),
        "tune": args.workload_tuning_ratio,
        "tune_seed": args.workload_tuning_seed,
        "de": args.dim_ext_method,
        "gs": gpu_sel,
        "dr": 0.0,
        "dp": "",
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
