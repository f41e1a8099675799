"""Replay a trace under one scheduling method and print the log.

    python -m tpusim_torch [-FGD W] [-PWR W] [-BestFit W] [-GpuPacking W]
        [-GpuClustering W] [-DotProd W] [-gpusel SEL] [-dimext M] [-norm M]
        [-tune R] [-tuneseed S] [--shuffle-pod true|false]
        [--nodes NODE_CSV] [--pods POD_CSV] [--device cpu]

The method flags are those of experiments/run.py: one integer weight per
score policy, the gpuSelMethod, and DotProduct's dim-ext and norm methods.
With no policy flag the run is the paper's FGD configuration (FGDScore at
weight 1000, gpu_sel FGDScore); the other rows of the paper's method list
are, for example, `-BestFit 1000` or `-PWR 500 -FGD 500 -gpusel FGDScore`.
Pods are shuffled and tuned to 1.3 x the cluster's GPU capacity with seed
42 unless the flags say otherwise; the node tie-break uses the tuning seed.
It prints the analysis log, whose last block is the Cluster Analysis. The
replay runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys

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


def method_config(policies=(("FGDScore", 1000),), gpu_sel="FGDScore",
                  dim_ext="share", norm="max", tune=1.3, tune_seed=42,
                  shuffle=True) -> SimulatorConfig:
    """One experiment of the paper's protocol: the given method on openb,
    typical pods at popularity 95, the tie-break seeded with the tuning
    seed. The defaults are the paper's FGD configuration."""
    return SimulatorConfig(
        policies=tuple(policies),
        gpu_sel_method=gpu_sel,
        dim_ext_method=dim_ext,
        norm_method=norm,
        shuffle_pod=shuffle,
        tuning_ratio=tune,
        tuning_seed=tune_seed,
        seed=tune_seed,
        typical_pods=TypicalPodsConfig(pod_popularity_threshold=95),
    )


def paper_config() -> SimulatorConfig:
    """The openb FGD configuration bench.py measures."""
    return method_config()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpusim_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", default=os.path.join(
        _DATA, "openb_node_list_gpu_node.csv"))
    ap.add_argument("--pods", default=os.path.join(
        _DATA, "openb_pod_list_default.csv"))
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
    args = ap.parse_args(argv)
    policies = [(name, getattr(args, flag))
                for name, flag in POLICY_FLAGS.items()
                if getattr(args, flag) > 0]
    gpu_sel = args.gpu_sel_method or ("best" if policies else "FGDScore")
    cfg = method_config(
        policies or (("FGDScore", 1000),), gpu_sel, args.dim_ext_method,
        args.norm_method, args.workload_tuning_ratio,
        args.workload_tuning_seed, args.shuffle_pod.lower() == "true")
    sim = Simulator(load_node_csv(args.nodes), cfg, device=args.device)
    sim.set_workload_pods(load_pod_csv(args.pods))
    sim.run()
    sys.stdout.write(sim.log.dump())
    return 0


if __name__ == "__main__":
    sys.exit(main())
