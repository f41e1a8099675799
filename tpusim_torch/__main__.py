"""Replay a trace under one scheduling method; print the log, or write the
experiment's log and analysis CSVs.

    python -m tpusim_torch [-FGD W] [-PWR W] [-BestFit W] [-GpuPacking W]
        [-GpuClustering W] [-DotProd W] [-Random W] [-Simon W]
        [-gpusel SEL] [-dimext M] [-norm M]
        [-tune R] [-tuneseed S] [--shuffle-pod true|false]
        [--workload-inflation-ratio R] [-seed S]
        [-r RATIO -p cosSim|fragOnePod|fragMultiPod] [-y PREFIX] [-z PREFIX]
        [--is-involved-cpu-pods B] [--pod-popularity-threshold N]
        [--pod-increase-step N] [--gpu-res-weight W]
        [-f POD_TRACE] [--node-trace NODE_CSV] [--use-timestamps]
        [--no-per-event-report] [--emit-configs] [--analysis-from-log]
        [--engine auto|table|pallas|sequential] [--mesh 0]
        [-d EXPERIMENT_DIR] [--device cpu]
    python -m tpusim_torch apply ...   (python -m tpusim_torch.cli apply)
    python -m tpusim_torch version | gen-doc [-d DIR] | debug   (the same)

The method flags are those of experiments/run.py: one integer weight per
score policy, the gpuSelMethod, and DotProduct's dim-ext and norm methods.
With no policy flag the run is the paper's FGD configuration (FGDScore at
weight 1000, gpu_sel FGDScore); the other rows of the paper's method list
are, for example, `-BestFit 1000`, `-PWR 500 -FGD 500 -gpusel FGDScore` or
`-Random 1000 -gpusel random -dimext merge` (01-Random).
Pods are shuffled and tuned to 1.3 x the cluster's GPU capacity with seed
42 unless the flags say otherwise; the node tie-break uses the tuning seed;
the typical pods are experiments/run.py's (popularity 95, step 1, unless
its typical-pod flags say otherwise). After the main replay come run.py's
later stages in its order: a --workload-inflation-ratio above 1 adds the
inflation stage (ScheduleInflation, seeded by -seed); -r above 0 with a -p
policy the descheduler (PostEviction and PostDeschedule, and
DescheduleInflation with inflation); -y/-z the pod YAML and node CSV
snapshots at <prefix>.yaml / <prefix>.csv.
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
import sys

from tpusim_torch.experiment import (
    POLICY_FLAGS,
    _simulator,
    add_experiment_flags,
    check_engine_flags,
    post_schedule_stages,
    run_experiment,
)
from tpusim_torch.sim.driver import SimulatorConfig
from tpusim_torch.sim.typical import TypicalPodsConfig


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
    if argv[:1] in (["apply"], ["version"], ["gen-doc"], ["debug"],
                    ["tune"], ["imitate"]):
        from tpusim_torch.cli import main as cli_main

        return cli_main(argv)
    ap = argparse.ArgumentParser(prog="python -m tpusim_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("-d", "--experiment-dir", default=None,
                    help="write simon.log and the analysis CSVs here")
    add_experiment_flags(ap)
    # the paper's protocol; gpu_sel None: FGDScore without policy flags
    ap.set_defaults(gpu_sel_method=None, workload_tuning_ratio=1.3,
                    workload_tuning_seed=42, shuffle_pod="true")
    args = ap.parse_args(argv)
    if args.gpu_sel_method is None:
        flagged = any(getattr(args, flag) > 0
                      for flag in POLICY_FLAGS.values())
        args.gpu_sel_method = "best" if flagged else "FGDScore"
    if args.experiment_dir is not None:
        run_experiment(args)  # experiments/run.py's: the log and the CSVs
        return 0
    check_engine_flags(args)
    sim = _simulator(args)[0]
    sim.run()
    post_schedule_stages(sim, args)
    sys.stdout.write(sim.log.dump())
    return 0


if __name__ == "__main__":
    sys.exit(main())
