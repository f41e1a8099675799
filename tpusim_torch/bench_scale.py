"""Synthetic scale run of the port: a 100k-node cluster and a 1M-pod
creation stream under FGD (the JAX package's bench_scale.py, BASELINE.json
config 5, "Synthetic 100k-node / 1M-pod stress").

The openb GPU node list is tiled out to --nodes nodes (the same SKU mix)
and --pods creation events are sampled from the openb default pods, with
the same rows as bench_scale.py's for the same seeds. The stream replays
under FGDScore 1000 with gpu_sel FGDScore and typical pods at popularity
95, taken from the whole stream, in --chunk-event pieces that carry the
node state. At 100k nodes the tables outgrow the card's L2 cache, so
--residency auto runs the blocked replay kernel (`replay_blocked`); vmem
forces the flat `replay`.

    python -m tpusim_torch.bench_scale                    # 100k / 1M, card
    python -m tpusim_torch.bench_scale --residency vmem   # the flat kernel
    python -m tpusim_torch.bench_scale --nodes 300 --pods 2000 --chunk 500 \\
        --device cpu                                      # plain, small

It replays the stream twice, the first time cold (the kernels' build and
first launch included), and prints a `[scale]` line for the second.
bench_scale.py's layout and cache flags: `--engine` (auto | table |
pallas | sequential; table runs the kernels through the chunk surface),
`--block-size` (-1 the flat `replay`, 0 --residency's rule, 128
`replay_blocked`; other widths raise), `--table-cache DIR` (the
content-keyed init_tables cache: a rerun serves each chunk's tables from
DIR instead of launching init_tables; the line then says
table_cache=hit|miss) and `--compile-cache-dir DIR` (where the kernels'
library is built). `--unswitched` and `--pallas-ceiling` are XLA and Pallas
layout knobs the port does not have: they raise, naming ROADMAP queue 1,
item 6. The obs flags are bench_scale.py's: `--profile PATH` (the JSONL run
record, spans split into dispatch and block), `--metrics-out PATH`
(Prometheus textfile), `--trace-out PATH` (Chrome trace), `--heartbeat N`
(a progress line every N events from inside the kernels' record forms) and
`--series-every N` (the cluster time-series, in the record and the trace);
`--listen` (the live endpoint) raises, naming ROADMAP queue 1, item 14.

    python -m tpusim_torch.bench_scale --nodes 1523 --pods 10000 \
        --sweep 1,16,64 [--sweep-out sweep.json]

measures the config sweep instead (bench_scale.py's --sweep): the stream
as one workload, a B-config weight grid of distinct rows (the base weight
minus the lane's index) through schedule_pods_sweep, report off. For each
B a `[sweep]` line with the cold and warm walls (min of 2 after the cold
one), the warm wall per config, its ratio to a standalone warm replay of
the same workload (Simulator.run_events) and the marginal cost of a
config, (warm(B) - warm(1)) / (B - 1); with --sweep-out, the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tpusim_torch.constants import MILLI
from tpusim_torch.io.trace import (
    NodeRow,
    PodRow,
    build_events,
    load_node_csv,
    load_pod_csv,
    pods_to_specs,
)
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.residency import table_bytes
from tpusim_torch.sim.table_engine import build_pod_types
from tpusim_torch.sim.typical import TypicalPodsConfig

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "csv")


def synth_cluster(num_nodes: int, seed: int = 0):
    """`num_nodes` rows drawn with replacement from the openb GPU node
    list, named synth-000000 on."""
    base = load_node_csv(os.path.join(_DATA, "openb_node_list_gpu_node.csv"))
    idx = np.random.default_rng(seed).integers(0, len(base), num_nodes)
    return [NodeRow(f"synth-{i:06d}", b.cpu_milli, b.memory_mib, b.gpu,
                    b.model, b.cpu_model)
            for i, b in enumerate(base[int(j)] for j in idx)]


def synth_pods(num_pods: int, seed: int = 1):
    """`num_pods` rows drawn with replacement from the openb default pod
    list, named sp-0000000 on (resources only)."""
    base = load_pod_csv(os.path.join(_DATA, "openb_pod_list_default.csv"))
    idx = np.random.default_rng(seed).integers(0, len(base), num_pods)
    return [PodRow(f"sp-{i:07d}", b.cpu_milli, b.memory_mib, b.num_gpu,
                   b.gpu_milli, b.gpu_spec)
            for i, b in enumerate(base[int(j)] for j in idx)]


def scale_config(seed: int = 42, residency: str = "auto",
                 **knobs) -> SimulatorConfig:
    """FGDScore 1000, gpu_sel FGDScore, typical pods at popularity 95;
    `knobs` are further SimulatorConfig fields (engine, block_size,
    table_cache_dir, compile_cache_dir)."""
    return SimulatorConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore", seed=seed,
        table_residency=residency, report_per_event=False,
        typical_pods=TypicalPodsConfig(pod_popularity_threshold=95), **knobs,
    )


class ScaleRun:
    """A Simulator over the synthetic cluster with the stream's typical
    pods, and the stream as specs, pod types and events."""

    def __init__(self, nodes, pods, cfg: SimulatorConfig, device):
        self.sim = Simulator(nodes, cfg, device=device)
        self.sim.set_workload_pods(pods)
        self.sim.set_typical_pods()
        self.specs = pods_to_specs(pods, None, device)
        self.types = build_pod_types(self.specs)  # the same for every chunk
        self.ev_kind, self.ev_pod = build_events(pods)

    def replay(self, chunk: int, events: int = None):
        """Replay the first `events` events (all by default) in pieces of
        `chunk`, carrying the node state. Returns (final state, each
        chunk's ReplayResult, failed creates, rebuilds of the blocked
        replay). Each piece's series samples are rebased onto the
        stream's event clock (`series_logs`), and its heartbeat ticks
        report the stream's progress."""
        from tpusim_torch.obs.series import log_from_stacked
        from tpusim_torch.sim.records import on_host

        events = len(self.ev_kind) if events is None else events
        state, results, failed, rebuilds = self.sim.init_state, [], 0, 0
        self.series_logs = []
        for lo in range(0, events, chunk):
            hi = min(lo + chunk, events)
            self.sim._hb_base = lo
            res = self.sim.run_events(state, self.specs, self.ev_kind[lo:hi],
                                      self.ev_pod[lo:hi], self.types)
            state = res.state
            results.append(res)
            failed += int(res.ever_failed.sum())
            if self.sim.last_kernel_stats is not None:
                rebuilds += self.sim.last_kernel_stats[2]
            if res.series is not None:
                self.series_logs.append(log_from_stacked(
                    on_host(res.series), base_pos=lo))
        self.sim._hb_base = 0
        return state, results, failed, rebuilds


def gpu_alloc(state) -> float:
    """Allocated share of the cluster's GPU milli, in percent."""
    gpu_left, gpu_cnt = state.gpu_left.cpu(), state.gpu_cnt.cpu()
    slot = torch.arange(gpu_left.shape[1])[None, :] < gpu_cnt[:, None]
    used = int(torch.where(slot, MILLI - gpu_left, 0).sum())
    return 100.0 * used / (int(gpu_cnt.sum()) * MILLI)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, warm_runs: int = 2):
    """(cold seconds, min warm seconds of `warm_runs`, the last result) of
    fn(), each call ended by a synchronise."""
    walls, out = [], None
    for _ in range(1 + warm_runs):
        _synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        _synchronize(device)
        walls.append(time.perf_counter() - t0)
    return walls[0], min(walls[1:]), out


def run_sweep_bench(run: ScaleRun, sizes, device) -> dict:
    """The config sweep's walls at each lane count of `sizes` (the module
    docstring) against a standalone warm replay; returns the rows."""
    from tpusim_torch.sim.driver import schedule_pods_sweep

    sim = run.sim
    trace = sim.prepare_pods()
    specs = pods_to_specs(trace, sim.node_index, device)
    ev_kind, ev_pod = build_events(trace)
    events = len(ev_kind)
    cold, standalone, _ = _timed(lambda: sim.run_events(
        sim.init_state, specs, ev_kind, ev_pod), device)
    print(f"[sweep] standalone nodes={len(sim.nodes)} events={events} "
          f"kernel={sim.last_engine} residency={sim.last_residency} "
          f"warm={standalone:.4f}s (cold {cold:.3f}s)")
    base = np.asarray([w for _, w in sim.cfg.policies], np.int32)
    rows, warm1 = [], None
    for b in sorted(set(sizes) | {1}):
        grid = np.stack([base - i for i in range(b)]).astype(np.int32)
        cold, warm, lanes = _timed(
            lambda grid=grid: schedule_pods_sweep(sim, trace, grid), device)
        warm1 = warm if b == 1 else warm1
        marginal = (warm - warm1) / (b - 1) if b > 1 else None
        row = dict(b=b, events=events, kernel=sim.last_engine,
                   residency=sim.last_residency, cold_s=cold, warm_s=warm,
                   per_config_s=warm / b,
                   ratio_vs_standalone=warm / b / standalone,
                   marginal_s=marginal,
                   marginal_vs_standalone=(None if marginal is None else
                                           marginal / standalone),
                   placed_lane0=lanes[0].placed)
        rows.append(row)
        print(f"[sweep] B={b} cold={cold:.3f}s warm={warm:.4f}s "
              f"per_config={warm / b:.4f}s "
              f"ratio_vs_standalone={warm / b / standalone:.3f} "
              + (f"marginal={marginal:.4f}s "
                 f"({marginal / standalone:.3f} of standalone) "
                 if marginal is not None else "")
              + f"kernel={sim.last_engine}")
    return dict(nodes=len(sim.nodes), events=events,
                policies=[name for name, _ in sim.cfg.policies],
                device=str(device), standalone_warm_s=standalone, rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpusim_torch.bench_scale",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--pods", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42,
                    help="cluster and tie-break seed; the pods use seed + 1")
    ap.add_argument("--chunk", type=int, default=200_000,
                    help="events per replay call; the state carries over")
    ap.add_argument("--residency", default="auto",
                    help="auto | vmem | hbm (SimulatorConfig.table_residency)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--sweep", default="", metavar="B[,B...]",
                    help="measure the config sweep at these lane counts "
                    "instead of the scale run")
    ap.add_argument("--sweep-out", default="", metavar="PATH",
                    help="write the sweep's rows here as JSON")
    ap.add_argument("--engine", default="auto",
                    help="auto | table | pallas | sequential "
                    "(SimulatorConfig.engine)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="-1: the flat replay; 0: --residency's rule; 128: "
                    "replay_blocked (SimulatorConfig.block_size)")
    ap.add_argument("--table-cache", default="", metavar="DIR",
                    help="content-keyed init_tables cache: a rerun serves "
                    "the tables from DIR (SimulatorConfig.table_cache_dir)")
    ap.add_argument("--compile-cache-dir", default="", metavar="DIR",
                    help="where the kernels' library is built and looked "
                    "for (SimulatorConfig.compile_cache_dir)")
    ap.add_argument("--unswitched", action="store_true",
                    help="tpusim's flat-select layout A/B: not in the port")
    ap.add_argument("--pallas-ceiling", action="store_true",
                    help="tpusim's Pallas residency ceiling: not in the port")
    ap.add_argument("--profile", default="", metavar="PATH",
                    help="profile the run (phase spans with their "
                    "dispatch/block split, exact counters) and append the "
                    "JSONL run record here")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write a Prometheus textfile of the run record")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write a Chrome trace of the phase spans")
    ap.add_argument("--heartbeat", type=int, default=0, metavar="EVENTS",
                    help="a progress line (events/s, ETA) every N events "
                    "from inside the kernels (0 = off)")
    ap.add_argument("--series-every", type=int, default=0, metavar="EVENTS",
                    help="sample the cluster time-series every N processed "
                    "events (0 = off): into --profile's record and "
                    "--trace-out's counter tracks")
    ap.add_argument("--listen", default="", metavar="[HOST]:PORT",
                    help="tpusim's live endpoint: not in the port yet")
    args = ap.parse_args(argv)
    if args.chunk <= 0:
        ap.error("--chunk must be positive")
    for flag, on in (("--unswitched", args.unswitched),
                     ("--pallas-ceiling", args.pallas_ceiling)):
        if on:
            raise NotImplementedError(
                f"{flag} is an XLA or Pallas layout knob the PyTorch port "
                "does not have (ROADMAP queue 1, item 6)")
    if args.listen:
        raise NotImplementedError(
            "--listen needs the service plane the PyTorch port does not "
            "have yet (ROADMAP queue 1, item 14 (service plane))")
    profiling = bool(args.profile or args.metrics_out or args.trace_out)
    device = torch.device(args.device)
    if args.compile_cache_dir:
        print(f"[obs] compile cache at {args.compile_cache_dir}",
              file=sys.stderr)

    run = ScaleRun(synth_cluster(args.nodes, args.seed),
                   synth_pods(args.pods, args.seed + 1),
                   scale_config(args.seed, args.residency,
                                engine=args.engine,
                                block_size=args.block_size,
                                table_cache_dir=args.table_cache,
                                compile_cache_dir=args.compile_cache_dir,
                                profile=profiling,
                                heartbeat_every=args.heartbeat,
                                series_every=args.series_every),
                   device)
    if args.sweep:
        sizes = [int(x) for x in args.sweep.split(",") if x.strip()]
        if not sizes or min(sizes) < 1:
            ap.error(f"--sweep wants positive lane counts, got {args.sweep!r}")
        out = run_sweep_bench(run, sizes, device)
        if args.sweep_out:
            out["card"] = (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")
            with open(args.sweep_out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    walls = []
    for _ in range(2):  # cold, then warm
        run.sim.obs.reset()  # the record describes the warm run
        _synchronize(device)
        t0 = time.perf_counter()
        state, _, failed, rebuilds = run.replay(args.chunk)
        _synchronize(device)
        walls.append(time.perf_counter() - t0)
    sim, k = run.sim, run.types.num_types
    placed = args.pods - failed
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    wall = walls[1]
    print(
        f"[scale] nodes={args.nodes} pods={args.pods} "
        f"kernel={sim.last_engine} residency={sim.last_residency} K={k} "
        f"table_mb={table_bytes(args.nodes, k, 1) / 1e6:.1f} "
        f"wall={wall:.3f}s (cold {walls[0]:.3f}s) placed={placed} "
        f"throughput={placed / wall:.0f} placements/s "
        f"us_per_event={1e6 * wall / args.pods:.2f} "
        f"gpu_alloc={gpu_alloc(state):.2f}% rebuilds={rebuilds} "
        f"device={card}"
        + (f" table_cache={sim.last_table_cache}" if args.table_cache else "")
    )
    if profiling:
        emit_obs(run, args, k)
    return 0


def emit_obs(run: ScaleRun, args, k: int) -> None:
    """Write --profile / --metrics-out / --trace-out for the warm run, as
    bench_scale.py does: its meta names the bench, the shape and the
    select's block width."""
    from tpusim_torch.obs import emitters, note_compile_cache
    from tpusim_torch.obs.series import (
        concat_series,
        series_from_record,
        series_to_record,
        series_tracks,
    )

    sim = run.sim
    cache_dir = args.compile_cache_dir or os.environ.get(
        "TPUSIM_COMPILE_CACHE_DIR", "")
    note_compile_cache(sim.obs, enabled=bool(cache_dir), cache_dir=cache_dir)
    series_block = None
    if args.series_every and run.series_logs:
        series_block = series_to_record(
            concat_series(run.series_logs), args.series_every,
            [name for name, _ in sim.cfg.policies])
    block = 128 if sim.last_residency == "hbm" else -1
    record = emitters.build_record(
        sim.run_telemetry(),
        meta={"bench": "bench_scale", "nodes": args.nodes, "pods": args.pods,
              "block": block, "types": k},
        series=series_block)
    counter_series = None
    if args.trace_out:
        counter_series = sim.event_counter_series()
        if series_block is not None:
            counter_series.update(series_tracks(
                series_from_record(series_block)))
    for p in emitters.emit_record(
            record, sim.run_telemetry().spans, jsonl=args.profile,
            metrics=args.metrics_out, trace=args.trace_out,
            counter_series=counter_series):
        print(f"[obs] wrote {p}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
