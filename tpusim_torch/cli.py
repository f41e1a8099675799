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
    python -m tpusim_torch.cli tune --nodes CSV --pods CSV [--policy
        learned|learned-bucketed|LearnedScore:FILE.json] [tpusim's flags]
        [--device cuda|cpu]
    python -m tpusim_torch.cli imitate --nodes CSV --pods CSV
        --decisions JSONL [--out FILE.json] [--device cuda|cpu]
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
`--compile-cache-dir` names where the kernels' library is built, and
`--policy` replaces the scheduler config's plugins with a learned policy
(or a built-in). The flags whose plane the port does not have yet
(--listen) parse and then raise NotImplementedError naming the ROADMAP item
that brings them. `tune` and `imitate` are tpusim's learned-scoring lane
(tpusim_torch.learn): a tuning generation is one lanes launch of the replay
kernels, an imitation's teacher forcing the `replay_forced` kernel; their
output and files are tpusim's but for the lines naming the kernel. The replays run on the GPU unless --device cpu is given. Its
standard output and the snapshot files it writes are byte-identical to
`python -m tpusim apply`'s on the same inputs, but for the `[Engine]`
lines and the `[Sweep]` and `[Chaos]` lines, which name the kernel that
ran.
"""

from __future__ import annotations

import argparse
import json
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
    p.add_argument("--profile", nargs="?",
                   const=os.path.join(".tpusim_obs", "tpusim_profile.jsonl"),
                   default="", metavar="PATH",
                   help="append the run's JSONL telemetry record (spans "
                   "with their dispatch/block split, exact counters); "
                   "synchronises on each phase")
    p.add_argument("--metrics-out", default="", metavar="PATH",
                   help="write the run record as a Prometheus textfile")
    p.add_argument("--trace-out", default="", metavar="PATH",
                   help="write a Chrome trace of the spans, with frag/alloc "
                   "and series counter tracks")
    p.add_argument("--heartbeat-every", type=int, default=0, metavar="N",
                   help="a progress line every N processed events from "
                   "inside the replay kernels (0 = off)")
    p.add_argument("--decisions-out", default="", metavar="PATH",
                   help="record every scheduling decision and write them "
                   "as JSONL (the input of explain and diff)")
    p.add_argument("--series-every", type=int, default=0, metavar="N",
                   help="sample the cluster every N processed events into "
                   "the run record's series block (0 = off)")
    # tpusim's other apply flags: accepted, refused unless at their default
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
    p.add_argument("--policy", default="", metavar="SPEC",
                   help="replace the scheduler config's score plugins: "
                   "'LearnedScore:FILE.json' (a signed learned-policy "
                   "artifact), 'learned' / 'learned-bucketed' (the "
                   "default-theta learned families), or a built-in name at "
                   "weight 1000")

    p_explain = sub.add_parser(
        "explain", help="why a node won one scheduling decision (per-policy "
        "score table from a --decisions-out JSONL)")
    p_explain.add_argument("decisions", help="decision JSONL file")
    p_explain.add_argument("-e", "--event", type=int, required=True,
                           help="event index to explain")
    p_diff = sub.add_parser(
        "diff", help="first-divergence finder + divergence histogram "
        "between two decision JSONLs (two runs/policies over the same "
        "trace)")
    p_diff.add_argument("run_a", help="decision JSONL of run A")
    p_diff.add_argument("run_b", help="decision JSONL of run B")
    p_diff.add_argument("--buckets", type=int, default=10,
                        help="event-range buckets of the divergence "
                        "histogram")
    p_report = sub.add_parser(
        "report", help="terminal summary of a run record's series "
        "(min/median/max + sparkline, straight from the JSONL)")
    p_report.add_argument("run", help="run-record JSONL (a --profile output "
                          "of a --series-every run)")
    add_learn_parsers(sub)
    sub.add_parser("version", help="print version")
    p_doc = sub.add_parser("gen-doc", help="generate markdown CLI docs")
    p_doc.add_argument("-d", "--dir", default="docs", help="output directory")
    sub.add_parser("debug", help="debug scaffold (no-op, ref parity)")
    return parser


def add_learn_parsers(sub) -> None:
    """tpusim's `tune` and `imitate` (tpusim/cli.py:455-660), with
    `--device`."""
    p = sub.add_parser(
        "tune",
        help="tune the per-policy score weights with ES/CMA, a generation "
        "one lanes launch of the replay kernels, and report "
        "tuned-vs-default on a held-out trace suffix")
    p.add_argument("--nodes", required=True, metavar="CSV",
                   help="node CSV of the tuning trace")
    p.add_argument("--pods", required=True, metavar="CSV",
                   help="pod CSV of the tuning trace")
    p.add_argument("--max-pods", type=int, default=0, metavar="N",
                   help="truncate the workload to its first N pods (0 = all)")
    p.add_argument("--policies",
                   default='[["FGDScore", 1000], ["BestFitScore", 500]]',
                   metavar="JSON",
                   help="policy family as [[name, default_weight], ...]; the "
                   "default weights seed the optimizer and are the held-out "
                   "report's baseline")
    p.add_argument("--policy", default="", metavar="SPEC",
                   help="tune a learned policy instead of --policies: "
                   "'learned', 'learned-bucketed' or 'LearnedScore:FILE.json'"
                   "; --best-out then writes a signed policy artifact, and "
                   "the weight bounds default to [-4000, 4000]")
    p.add_argument("--algo", choices=("es", "cma"), default="es",
                   help="optimizer: antithetic OpenAI-ES or diagonal CMA-ES")
    p.add_argument("--generations", type=int, default=10)
    p.add_argument("--popsize", type=int, default=8)
    p.add_argument("--sigma", type=float, default=250.0,
                   help="initial perturbation scale in weight units")
    p.add_argument("--lr", type=float, default=300.0,
                   help="ES step size in weight units (cma adapts its own)")
    p.add_argument("--seed", type=int, default=0,
                   help="optimizer draw seed (fixed seed -> byte-identical "
                   "log)")
    p.add_argument("--eval-seed", type=int, default=42,
                   help="replay seed every candidate shares")
    p.add_argument("--w-min", type=int, default=None,
                   help="weight lower bound (default 0; -4000 under "
                   "--policy learned)")
    p.add_argument("--w-max", type=int, default=None,
                   help="weight upper bound (default 4000)")
    p.add_argument("--obj-alloc", type=float, default=1.0,
                   help="objective weight on gpu_alloc_pct")
    p.add_argument("--obj-frag", type=float, default=1.0,
                   help="objective weight on frag percent of cluster GPU")
    p.add_argument("--obj-unsched", type=float, default=1.0,
                   help="objective weight on unscheduled percent of pods")
    p.add_argument("--holdout", type=float, default=0.2, metavar="FRAC",
                   help="trailing fraction of the pod list held out of "
                   "tuning for the tuned-vs-default report (0 disables)")
    p.add_argument("--log",
                   default=os.path.join(".tpusim_obs", "tune_log.jsonl"),
                   metavar="PATH",
                   help="digest-signed tuning log (JSONL; --resume's input)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the log's last generation")
    p.add_argument("--url", default="", metavar="URL",
                   help="tpusim's remote rollouts: the port has no job "
                   "service yet, and raises")
    p.add_argument("--engine", choices=("auto", "table", "sequential"),
                   default="auto", help="replay engine for the rollouts")
    p.add_argument("--best-out", default="", metavar="PATH",
                   help="write the tuned weight vector as a weights-grid "
                   "JSON (a signed artifact under --policy learned)")
    p.add_argument("--robust-mtbf", type=float, default=0.0,
                   metavar="EVENTS",
                   help="replay each generation's best under seeded fault "
                   "injection with this MTBF (0 = off; logged)")
    p.add_argument("--robust-mttr", type=float, default=0.0,
                   metavar="EVENTS")
    p.add_argument("--robust-seed", type=int, default=0)
    p.add_argument("--train-fault-mtbf", type=float, default=0.0,
                   metavar="EVENTS",
                   help="roll every lane out under a seeded fault schedule "
                   "with this MTBF (0 = fault-free training)")
    p.add_argument("--train-fault-mttr", type=float, default=0.0,
                   metavar="EVENTS")
    p.add_argument("--train-fault-evict-every", type=float, default=0.0,
                   metavar="EVENTS")
    p.add_argument("--train-fault-seed", type=int, default=0)
    p.add_argument("--obj-disrupt", type=float, default=0.0,
                   help="objective weight on pods lost to disruption")
    p.add_argument("--timeout", type=float, default=600.0,
                   metavar="SECONDS")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the CUDA kernels (the default), cpu "
                   "their plain PyTorch versions")

    p = sub.add_parser(
        "imitate",
        help="train a learned policy to imitate a recorded teacher: "
        "teacher-force the trace through a --decisions-out JSONL (the "
        "replay_forced kernel), fit the linear scorer, export it and "
        "report held-out top-1 agreement")
    p.add_argument("--nodes", required=True, metavar="CSV",
                   help="node CSV of the recorded trace")
    p.add_argument("--pods", required=True, metavar="CSV",
                   help="pod CSV of the recorded trace")
    p.add_argument("--decisions", required=True, metavar="JSONL",
                   help="the teacher run's decision log (apply "
                   "--decisions-out), digest-verified on load")
    p.add_argument("--max-pods", type=int, default=0, metavar="N",
                   help="truncate the workload to its first N pods (must "
                   "match the recorded run)")
    p.add_argument("--features", choices=("linear", "bucketed"),
                   default="linear", help="feature vocabulary")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=0.15)
    p.add_argument("--l2", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--holdout", type=float, default=0.2, metavar="FRAC",
                   help="trailing fraction of events held out of training")
    p.add_argument("--out", default="", metavar="PATH",
                   help="write the trained policy as a signed artifact")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the replay_forced kernel (the default), "
                   "cpu its plain PyTorch version")


def _load_trace(nodes_csv: str, pods_csv: str, max_pods: int):
    """(node rows, pod rows) of a trace's CSVs, the pods truncated to the
    first max_pods where > 0."""
    from tpusim_torch.io.trace import load_node_csv, load_pod_csv

    pods = load_pod_csv(pods_csv)
    return load_node_csv(nodes_csv), pods[:max_pods] if max_pods > 0 else pods


def cmd_tune(args) -> int:
    """tpusim's tune: 0, or 2 with a one-line error on unusable input."""
    from tpusim_torch.learn import (
        LocalRollout,
        ObjectiveConfig,
        RemoteRollout,
        TuneConfig,
        format_holdout_report,
        holdout_report,
        make_family_sim,
        make_robust_eval,
        run_tune,
    )
    from tpusim_torch.policies import POLICY_NAMES, is_policy_name

    try:
        learned = False
        if args.policy:
            from tpusim_torch.learn.policy import (
                parse_learned_name,
                parse_policy_spec,
            )

            policies = [(n, int(w)) for n, w in parse_policy_spec(args.policy)]
            learned = all(parse_learned_name(n) is not None
                          for n, _ in policies)
        else:
            policies = [(str(n), int(w))
                        for n, w in json.loads(args.policies)]
        for name, _ in policies:
            if not is_policy_name(name):
                raise ValueError(
                    f"unknown policy {name!r} (known: "
                    f"{', '.join(POLICY_NAMES)}, LearnedScore[<feature>])")
        w_lo = args.w_min if args.w_min is not None else (
            -4000 if learned else 0)
        w_hi = args.w_max if args.w_max is not None else 4000
        if learned:
            from tpusim_torch.learn.policy import THETA_HI, THETA_LO

            if w_lo < THETA_LO or w_hi > THETA_HI:
                raise ValueError(
                    f"--policy learned bounds [{w_lo}, {w_hi}] exceed the "
                    f"i32 theta export range [{THETA_LO}, {THETA_HI}]")
        if not 0.0 <= args.holdout < 1.0:
            raise ValueError(f"--holdout must be in [0, 1), got "
                             f"{args.holdout}")
        if args.url:
            RemoteRollout(args.url)  # raises: no job service in the port
        nodes, pods = _load_trace(args.nodes, args.pods, args.max_pods)
        n_train = len(pods) - int(len(pods) * args.holdout)
        train, held = pods[:n_train], pods[n_train:]
        if not train:
            raise ValueError("no training pods left after the holdout split")
        cfg = TuneConfig(
            algo=args.algo, generations=args.generations,
            popsize=args.popsize, sigma=args.sigma, lr=args.lr,
            seed=args.seed, eval_seed=args.eval_seed, w_lo=w_lo, w_hi=w_hi,
            objective=ObjectiveConfig(
                w_alloc=args.obj_alloc, w_frag=args.obj_frag,
                w_unsched=args.obj_unsched, w_disrupt=args.obj_disrupt))
        train_fault = train_fault_meta = None
        if args.train_fault_mtbf > 0 or args.train_fault_evict_every > 0:
            from tpusim_torch.sim.faults import FaultConfig

            train_fault = FaultConfig(
                mtbf_events=args.train_fault_mtbf,
                mttr_events=args.train_fault_mttr,
                evict_every_events=args.train_fault_evict_every,
                seed=args.train_fault_seed)
            train_fault_meta = {
                "mtbf": float(args.train_fault_mtbf),
                "mttr": float(args.train_fault_mttr),
                "evict_every": float(args.train_fault_evict_every),
                "seed": int(args.train_fault_seed),
            }
        sim = make_family_sim(nodes, train, policies, engine=args.engine,
                              device=args.device)
        backend = LocalRollout(sim, width=args.popsize, fault=train_fault)
        robust_eval = robust_meta = None
        if args.robust_mtbf > 0:
            from tpusim_torch.sim.faults import FaultConfig

            robust_eval = make_robust_eval(
                nodes, train, policies,
                FaultConfig(mtbf_events=args.robust_mtbf,
                            mttr_events=args.robust_mttr,
                            seed=args.robust_seed),
                device=args.device)
            robust_meta = {
                "mtbf": float(args.robust_mtbf),
                "mttr": float(args.robust_mttr),
                "seed": int(args.robust_seed),
            }
        result = run_tune(
            backend, policies, cfg, args.log, resume=args.resume,
            robust_eval=robust_eval, robust_meta=robust_meta,
            train_fault_meta=train_fault_meta, out=sys.stderr)

        from tpusim_torch.obs.emitters import format_tuning_curve

        print(format_tuning_curve(result.records))
        print(
            f"[tune] best weights "
            f"{','.join(str(w) for w in result.best_weights)} "
            f"(objective {result.best_objective:+.4f}) after "
            f"{len(result.records)} generations -> {result.log_path}")
        if held:
            eval_sim = make_family_sim(nodes, held, policies,
                                       engine=args.engine,
                                       device=args.device)
            report = holdout_report(
                eval_sim, policies, result.best_weights,
                objective=cfg.objective, eval_seed=cfg.eval_seed)
            print(format_holdout_report(report, policies))
        if args.best_out:
            if learned:
                from tpusim_torch.learn.dataset import feature_names_of
                from tpusim_torch.learn.policy import save_policy_artifact

                path = save_policy_artifact(
                    args.best_out, result.best_weights,
                    features=feature_names_of(policies),
                    meta={"trained": args.algo,
                          "objective": result.best_objective,
                          "source": "tune"})
                print(f"[tune] wrote learned-policy artifact {path}",
                      file=sys.stderr)
            else:
                from tpusim_torch.apply import save_weights_payload

                path = save_weights_payload(
                    args.best_out, [result.best_weights], policies=policies)
                print(f"[tune] wrote tuned weights payload {path}",
                      file=sys.stderr)
    except (OSError, ValueError, json.JSONDecodeError) as err:
        print(f"tpusim tune: {err}", file=sys.stderr)
        return 2
    return 0


def cmd_imitate(args) -> int:
    """tpusim's imitate: decision JSONL -> teacher-forced features (the
    replay_forced kernel) -> pairwise ranking fit -> i32 export -> held-out
    top-1 agreement (and a signed artifact); 0, or 2 on unusable input."""
    import numpy as np

    from tpusim_torch.learn import (
        ImitateConfig,
        TeacherReplay,
        imitate_with_mining,
        load_teacher_log,
        save_policy_artifact,
    )
    from tpusim_torch.learn.policy import FEATURE_SETS
    from tpusim_torch.sim.workload import sort_cluster_pods

    try:
        if not 0.0 <= args.holdout < 1.0:
            raise ValueError(f"--holdout must be in [0, 1), got "
                             f"{args.holdout}")
        header, rows = load_teacher_log(args.decisions)
        teacher = "+".join(n for n, _ in header.get("policies", [])) or "?"
        nodes, pods = _load_trace(args.nodes, args.pods, args.max_pods)
        # Simulator.run()'s prep: the stable (creation_time, name) sort,
        # no shuffle or tuning; a log recorded under other options fails
        # the replay's feasible-count check
        pods = sort_cluster_pods(list(pods), False,
                                 np.random.default_rng(233))
        features = FEATURE_SETS[args.features]
        replay = TeacherReplay(nodes, pods, header, rows, features=features,
                               device=args.device)
        cut = len(rows) - int(len(rows) * args.holdout)
        print(f"[imitate] teacher {teacher}: {len(rows)} events, training "
              f"on [0, {cut}), holdout from event {cut}", file=sys.stderr)
        _, theta, _hist = imitate_with_mining(
            replay, ImitateConfig(steps=args.steps, lr=args.lr, l2=args.l2,
                                  seed=args.seed),
            end_event=cut, out=sys.stderr)
        rep_train = replay.agreement(theta)
        rep_held = replay.agreement(theta, start_event=cut)
        print(f"[imitate] exported theta {','.join(str(t) for t in theta)}")
        print(
            f"[imitate] teacher-forced top-1 agreement: "
            f"{rep_train['matches']}/{rep_train['creates']} "
            f"({100 * rep_train['agreement']:.2f}%) overall, "
            f"{rep_held['matches']}/{rep_held['creates']} "
            f"({100 * rep_held['agreement']:.2f}%) on the held-out suffix")
        if args.out:
            path = save_policy_artifact(
                args.out, theta, features=features,
                meta={"trained": "imitation",
                      "teacher": header.get("policies", []),
                      "agreement_holdout": rep_held["agreement"],
                      "source": "imitate"})
            print(f"[imitate] wrote learned-policy artifact {path}",
                  file=sys.stderr)
    except (OSError, ValueError, json.JSONDecodeError) as err:
        print(f"tpusim imitate: {err}", file=sys.stderr)
        return 2
    return 0


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


def cmd_explain(args) -> int:
    """tpusim's explain: 0, or 2 with a one-line error on unusable input
    (a missing, torn or edited file, an event out of range)."""
    from tpusim_torch.obs import decisions as obs_decisions

    try:
        header, rows = obs_decisions.read_decisions(args.decisions)
        print(obs_decisions.format_explain(header, rows, args.event))
    except (OSError, ValueError, json.JSONDecodeError) as err:
        print(f"tpusim explain: {err}", file=sys.stderr)
        return 2
    return 0


def cmd_diff(args) -> int:
    """tpusim's diff: as diff(1), 0 when the placements are identical, 1
    when they diverge, 2 on unusable input (files of different traces
    included)."""
    from tpusim_torch.obs import decisions as obs_decisions

    try:
        ha, ra = obs_decisions.read_decisions(args.run_a)
        hb, rb = obs_decisions.read_decisions(args.run_b)
        d = obs_decisions.run_diff(
            ha, ra, hb, rb, label_a=os.path.basename(args.run_a),
            label_b=os.path.basename(args.run_b), buckets=args.buckets)
    except (OSError, ValueError, json.JSONDecodeError) as err:
        print(f"tpusim diff: {err}", file=sys.stderr)
        return 2
    print(d["text"])
    return 1 if d["first"] else 0


def cmd_report(args) -> int:
    """tpusim's report: the series block of the last record that has one;
    2 on unusable input."""
    from tpusim_torch.obs.emitters import read_jsonl
    from tpusim_torch.obs.series import format_report

    try:
        records = read_jsonl(args.run)
        with_series = [r for r in records if r.get("series")]
        if not with_series:
            raise ValueError(
                f"{args.run}: no record carries a series block (was the "
                "run made with --series-every and --profile?)")
        print(format_report(with_series[-1]["series"]))
    except (OSError, ValueError, json.JSONDecodeError) as err:
        print(f"tpusim report: {err}", file=sys.stderr)
        return 2
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "apply":
        Applier(apply_options(args)).run()
        return 0
    if args.command in ("explain", "diff", "report", "tune", "imitate"):
        return {"explain": cmd_explain, "diff": cmd_diff,
                "report": cmd_report, "tune": cmd_tune,
                "imitate": cmd_imitate}[args.command](args)
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
