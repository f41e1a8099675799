"""`python -m tpusim_torch.cli`: the port's copy of `python -m tpusim`'s
apply, version, gen-doc and debug subcommands (counterpart of
tpusim/cli.py; ref: cmd/apply/apply.go:14-40, cmd/version, cmd/doc,
cmd/debug).

    python -m tpusim_torch.cli apply -f CLUSTER_CONFIG [-s SCHEDULER_CONFIG]
        [-e gpu[,open-local]] [--report] [--use-greed] [-i]
        [--base-dir DIR] [--device cuda|cpu]
        [--table-residency auto|vmem|hbm] [--sweep-weights GRID.json]
        [--sweep-faults FAULTS.json]
        [--fault-mtbf N --fault-mttr N --fault-evict-every N
         --fault-seed S --fault-max-retries K]
        [--checkpoint-every N --checkpoint-dir DIR --checkpoint-keep K]
        [--compile-cache-dir DIR]
    python -m tpusim_torch.cli version      # tpusim's version line
    python -m tpusim_torch.cli gen-doc [-d DIR]   # DIR/tpusim.md
    python -m tpusim_torch.cli debug        # a no-op, exit 0

It takes tpusim's apply flags. `--sweep-weights GRID.json` replaces the
main schedule with one sweep over a weight grid (the lanes of one launch)
and prints its per-config table; `--sweep-faults FAULTS.json` with one
chaos sweep over fault schedules (the lanes of one launch of the replays'
fault forms) and prints the per-lane disruption frontier. The `--fault-*`
flags replay the main schedule under a seeded fault schedule (node
failures, recoveries and evictions: the in-scan fault lane, or the
segmented host loop with per-event reports on, the `[Fault]` and
`[Disruption]` lines). `--checkpoint-every` cuts every replay of more
events into chunks whose carry is written to a content-addressed file
(resumed after a kill; `--checkpoint-dir`, `--checkpoint-keep`), and
`--compile-cache-dir` names where the kernels' library is built. The flags
whose plane the port does not have yet (the obs outputs, --listen,
--policy) parse and then raise NotImplementedError naming the ROADMAP item
that brings them. The replays run on the GPU unless --device cpu is given. Its
standard output and the snapshot files it writes are byte-identical to
`python -m tpusim apply`'s on the same inputs, but for the `[Engine]`
lines and the `[Sweep]` and `[Chaos]` lines, which name the kernel that
ran.
"""

from __future__ import annotations

import argparse
import os
import sys

from tpusim_torch.apply import Applier, ApplyOptions
from tpusim_torch.sim.residency import RESIDENCIES

# tpusim's version line (tpusim/cli.py:46-47): the port prints the same
VERSION = "0.1.0"
COMMIT = os.environ.get("TPUSIM_COMMIT", "dev")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tpusim_torch.cli",
        description="Kubernetes GPU-cluster scheduling simulator, "
        "PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("apply", help="run a simulation")
    p.add_argument("-f", "--simon-config", required=True,
                   help="cluster-config YAML (Simon CR)")
    p.add_argument("-s", "--default-scheduler-config", default="",
                   help="KubeSchedulerConfiguration YAML")
    p.add_argument("--use-greed", action="store_true",
                   help="greedy app-pod queue sort")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="confirm app list")
    p.add_argument("-e", "--extended-resources", default="gpu",
                   help="comma-separated: gpu, open-local")
    p.add_argument("--base-dir", default=".",
                   help="root for relative paths inside the CR (default: cwd)")
    p.add_argument("--report", action="store_true",
                   help="print placement report tables")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the CUDA kernels (the default), cpu "
                   "their plain PyTorch versions")
    p.add_argument("--table-residency", choices=RESIDENCIES, default="auto",
                   help="vmem = the flat replay kernel, hbm = the blocked "
                   "one, auto = vmem while the tables fit the card's L2")
    p.add_argument("--fault-mtbf", type=float, default=0.0,
                   help="mean events between node failures (0 = none)")
    p.add_argument("--fault-mttr", type=float, default=0.0,
                   help="mean events until a failed node returns "
                   "(0 = never)")
    p.add_argument("--fault-evict-every", type=float, default=0.0,
                   help="mean events between single-pod evictions "
                   "(0 = none)")
    p.add_argument("--fault-seed", type=int, default=0)
    p.add_argument("--fault-max-retries", type=int, default=3)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="cut each replay into chunks of this many events, "
                   "checkpointing the carry after each (0 = one launch)")
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint directory (default "
                   "$TPUSIM_CHECKPOINT_DIR, else .tpusim_checkpoints/)")
    p.add_argument("--checkpoint-keep", type=int, default=0,
                   help="0: keep the newest checkpoint until the run ends; "
                   "-1: keep all (fork sources); N: the newest N")
    # tpusim's other apply flags: accepted, refused unless at their default
    p.add_argument("--profile", nargs="?",
                   const=os.path.join(".tpusim_obs", "tpusim_profile.jsonl"),
                   default="")
    p.add_argument("--metrics-out", default="")
    p.add_argument("--trace-out", default="")
    p.add_argument("--heartbeat-every", type=int, default=0)
    p.add_argument("--decisions-out", default="")
    p.add_argument("--series-every", type=int, default=0)
    p.add_argument("--listen", default="")
    p.add_argument("--sweep-weights", default="", metavar="WEIGHTS.json",
                   help="replace the main schedule with one sweep over a "
                   "weight grid: [[w, ...], ...] or {\"weights\": [[...]], "
                   "\"seeds\": [...], \"tunes\": [...]}, a row per config "
                   "in the scheduler config's policy order")
    p.add_argument("--sweep-faults", default="", metavar="FAULTS.json",
                   help="replace the main schedule with one chaos sweep: "
                   "[{FaultConfig fields}, ...] or {\"faults\": [...], "
                   "\"weights\": [[...]], \"seeds\": [...]}, a lane each")
    p.add_argument("--compile-cache-dir", default="",
                   help="where the kernels' library is built and looked for "
                   "(default $TPUSIM_COMPILE_CACHE_DIR, else "
                   ".tpusim_torch_build/)")
    p.add_argument("--policy", default="")

    sub.add_parser("version", help="print version")
    p_doc = sub.add_parser("gen-doc", help="generate markdown CLI docs")
    p_doc.add_argument("-d", "--dir", default="docs", help="output directory")
    sub.add_parser("debug", help="debug scaffold (no-op, ref parity)")
    return parser


def cmd_gen_doc(parser: argparse.ArgumentParser, args) -> int:
    """Write the parser's help as DIR/tpusim.md (tpusim's gen-doc)."""
    os.makedirs(args.dir, exist_ok=True)
    path = os.path.join(args.dir, "tpusim.md")
    with open(path, "w") as f:
        f.write(f"# tpusim\n\n```\n{parser.format_help()}\n```\n")
    print(f"wrote {path}")
    return 0


def apply_options(args) -> ApplyOptions:
    return ApplyOptions(
        simon_config=args.simon_config,
        default_scheduler_config=args.default_scheduler_config,
        use_greed=args.use_greed,
        interactive=args.interactive,
        extended_resources=[e.strip()
                            for e in args.extended_resources.split(",")
                            if e.strip()],
        base_dir=args.base_dir,
        report_tables=args.report,
        device=args.device,
        table_residency=args.table_residency,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_keep=args.checkpoint_keep,
        fault_mtbf=args.fault_mtbf,
        fault_mttr=args.fault_mttr,
        fault_evict_every=args.fault_evict_every,
        fault_seed=args.fault_seed,
        fault_max_retries=args.fault_max_retries,
        profile_out=args.profile,
        metrics_out=args.metrics_out,
        trace_out=args.trace_out,
        heartbeat_every=args.heartbeat_every,
        decisions_out=args.decisions_out,
        series_every=args.series_every,
        listen=args.listen,
        sweep_weights=args.sweep_weights,
        sweep_faults=args.sweep_faults,
        compile_cache_dir=args.compile_cache_dir,
        policy=args.policy,
    )


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "apply":
        Applier(apply_options(args)).run()
        return 0
    if args.command == "version":
        print(f"tpusim version {VERSION} (commit {COMMIT})")
        return 0
    if args.command == "gen-doc":
        return cmd_gen_doc(parser, args)
    if args.command == "debug":
        return 0  # ref: cmd/debug/debug.go run() is empty
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
