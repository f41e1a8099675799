"""The paper's experiment grid in one process (counterpart of
experiments/sweep.py): trace x method x seed, each experiment's simon.log
and analysis CSVs written as experiments/run.py writes them.

    python -m tpusim_torch.sweep --traces openb_pod_list_default \
        --methods 06-FGD 01-Random --seeds 3
    python -m tpusim_torch.sweep            # 10 methods x 21 traces x 10
    python -m tpusim_torch.sweep --fast     # no per-event report lines

Each experiment writes under --out-root/<trace>/<method>/<tune>/<seed>,
byte-identical to experiments/sweep.py's files, and a `.sweep_done`
marker once it is whole: a rerun skips the experiments whose marker holds
the same flags. A group (one trace and method, its seeds) runs its main
replays as the lanes of one launch (tpusim_torch.experiment
dispatch_experiment_batch) unless --no-batch is given; while a group's
lanes run on the card, the host finishes the files of the groups before
it, up to two groups behind. The replays run on the GPU unless --device
cpu is given; a failed launch ends the sweep.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from pathlib import Path

from tpusim_torch import experiment as runner

TRACES = [
    "openb_pod_list_default",
    "openb_pod_list_cpu037",
    "openb_pod_list_cpu050",
    "openb_pod_list_cpu072",
    "openb_pod_list_cpu100",
    "openb_pod_list_cpu200",
    "openb_pod_list_cpu250",
    "openb_pod_list_cpu300",
    "openb_pod_list_gpushare20",
    "openb_pod_list_gpushare40",
    "openb_pod_list_gpushare60",
    "openb_pod_list_gpushare80",
    "openb_pod_list_gpushare100",
    "openb_pod_list_gpuspec10",
    "openb_pod_list_gpuspec20",
    "openb_pod_list_gpuspec25",
    "openb_pod_list_gpuspec33",
    "openb_pod_list_multigpu20",
    "openb_pod_list_multigpu30",
    "openb_pod_list_multigpu40",
    "openb_pod_list_multigpu50",
]

# (id, policy flags, gpusel, dimext, norm): the reference's AllMethodList
# rows 01-07 and the PWR/FGD mixes 08, 11 and 12
METHODS = [
    ("01-Random", "-Random 1000", "random", "merge", "max"),
    ("02-DotProd", "-DotProd 1000", "best", "merge", "max"),
    ("03-GpuClustering", "-GpuClustering 1000", "best", "share", "max"),
    ("04-GpuPacking", "-GpuPacking 1000", "best", "share", "max"),
    ("05-BestFit", "-BestFit 1000", "best", "share", "max"),
    ("06-FGD", "-FGD 1000", "FGDScore", "share", "max"),
    ("07-PWR", "-PWR 1000", "PWRScore", "share", "max"),
    ("08-PWR_500_FGD_500", "-PWR 500 -FGD 500", "FGDScore", "share", "max"),
    ("11-PWR_100_FGD_900", "-PWR 100 -FGD 900", "FGDScore", "share", "max"),
    ("12-PWR_50_FGD_950", "-PWR 50 -FGD 950", "FGDScore", "share", "max"),
]

# groups whose lanes may run while the host finishes earlier groups
LOOKAHEAD = 2


def experiment_argv(out_root: str, trace: str, method, tune: float,
                    seed: int, fast: bool, device: str):
    """An experiment's flags (experiments/sweep.py's) and its directory."""
    mid, flags, gpusel, dimext, norm = method
    outdir = f"{out_root}/{trace}/{mid}/{tune}/{seed}"
    argv = (["-d", outdir, "-f", trace] + flags.split()
            + ["-gpusel", gpusel, "-dimext", dimext, "-norm", norm,
               "-tune", str(tune), "-tuneseed", str(seed),
               "--shuffle-pod", "true"]
            + (["--no-per-event-report"] if fast else []))
    # the marker keys on run.py's flags alone, so a directory that
    # experiments/sweep.py finished is not run again
    return argv + ["--device", device], argv, Path(outdir) / ".sweep_done"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpusim_torch.sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out-root", default="experiments/data")
    ap.add_argument("--tune", type=float, default=1.3)
    ap.add_argument("--seeds", type=int, default=10, help="seeds 42..42+n-1")
    ap.add_argument("--traces", nargs="*", default=None)
    ap.add_argument("--methods", nargs="*", default=None, help="method ids")
    ap.add_argument("--fast", action="store_true", help="no per-event report")
    ap.add_argument("--no-batch", action="store_true",
                    help="run the seeds one by one instead of as the lanes "
                    "of one launch a group")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    traces = args.traces or TRACES
    methods = [m for m in METHODS
               if args.methods is None or m[0] in args.methods]
    seeds = list(range(42, 42 + args.seeds))
    total = len(traces) * len(methods) * len(seeds)
    t_all = time.perf_counter()
    done = 0
    inflight = deque()

    def report(trace, mid, pending, t0):
        print(f"[sweep {done}/{total}] {trace} {mid} "
              f"seeds={[s for s, _, _, _ in pending]} "
              f"{time.perf_counter() - t0:.1f}s "
              f"(total {time.perf_counter() - t_all:.0f}s)", flush=True)

    def flush(entry):
        nonlocal done
        runner.finish_experiment_batch(entry["st"])
        for _, _, key, marker in entry["pending"]:
            marker.write_text(" ".join(key))
        done += len(entry["pending"])
        report(entry["trace"], entry["mid"], entry["pending"], entry["t0"])

    for trace in traces:
        for method in methods:
            mid = method[0]
            pending = []
            for seed in seeds:
                exp, key, marker = experiment_argv(
                    args.out_root, trace, method, args.tune, seed, args.fast,
                    args.device)
                if marker.exists() and marker.read_text() == " ".join(key):
                    done += 1
                    print(f"[sweep {done}/{total}] {trace} {mid} "
                          f"seed={seed} cached, skipping", flush=True)
                    continue
                pending.append((seed, exp, key, marker))
            if not pending:
                continue
            t0 = time.perf_counter()
            if len(pending) > 1 and not args.no_batch:
                st = runner.dispatch_experiment_batch(
                    [runner.get_args(a) for _, a, _, _ in pending])
                inflight.append(dict(trace=trace, mid=mid, pending=pending,
                                     st=st, t0=t0))
                while len(inflight) > LOOKAHEAD:
                    flush(inflight.popleft())
                continue
            while inflight:
                flush(inflight.popleft())
            for _, exp, key, marker in pending:
                runner.run_experiment(runner.get_args(exp))
                marker.write_text(" ".join(key))
            done += len(pending)
            report(trace, mid, pending, t0)
    while inflight:
        flush(inflight.popleft())
    print(f"[sweep] {total} experiments in "
          f"{time.perf_counter() - t_all:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
