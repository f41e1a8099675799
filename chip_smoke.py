"""Smoke run of the PyTorch/CUDA port (tpusim_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. card    the card's name and power limit (nvidia-smi); a CUDA device is
           required.
2. build   the port's CUDA kernels, compiled from tpusim_torch/kernels/*.cu.
3. check   each kernel against its plain PyTorch version on the same inputs,
           tolerance zero (exact equality), for every policy configuration
           the kernels cover: init_tables on the full openb tables of each,
           replay on seeded random clusters (256 nodes, ~1k events for the
           method rows, ~300 for the other DotProduct pairs and FGD/worst)
           and on the full openb FGD trace, replay_blocked (outputs and
           stats) on seeded random clusters of five 128-node blocks for
           every method row's configuration and FGD/worst, of 17 and 513
           blocks for BestFit and PWR+FGD, and on the full openb FGD
           trace, its plain version on CPU copies of the inputs.
           Both replay kernels are timed per method row at openb, and
           replay for FGD/worst (the one-FGD configuration through the
           general kernel), beside the plain version and the bound.
4. main    Simulator.run() on the card for every row of the paper's method
           list but 01-Random (openb gpu_node list, default trace, tune 1.3,
           tuning seed 42, seed 42), once with table_residency "auto" (the
           flat replay at this size) and once with "hbm" (replay_blocked):
           the launch counts are set to 0 before each run and read after
           it, the kernels of that run's residency must have been launched
           and the other replay kernel not, and the placements and device
           masks must match the digests of the JAX package's run of the row.
5. scale   tpusim_torch.bench_scale's path: 100,000 synthetic nodes, the
           1M-pod stream in 200k-event chunks, residency "auto", with the
           launch counts set to 0 before and read after: auto must have
           chosen replay_blocked, the first chunk's placements and masks
           must match the JAX package's digests, and the flat replay over
           the same chunks must give identical outputs. Both kernels are
           timed. At the scale width init_tables and both replay kernels
           are held to their plain versions (CPU copies) over 2,000
           events from the state after the first chunk, for FGD, BestFit
           and PWR+FGD, tolerance 0 with stats; then both replay kernels
           are timed on 20,000 events at 10k, 30k and 100k nodes for
           06-FGD, 05-BestFit and 08, beside the tier auto picks there.

It then prints one JSON line describing the kernels, the card's line, and
as the last line {"ok": true, "device": {...}}.

This script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# Digests of the JAX package's Simulator.run() on the paper's openb FGD
# configuration (CPU, table engine): sha256 of placed_node as int32 and of
# dev_mask as uint8. tests/test_torch_driver.py pins them against tpusim.
OPENB_PLACED_SHA256 = (
    "ab2bdf81ba2e44defba6b5cc760450efcf35317501034aa82b552e71c4bcd30a"
)
OPENB_DEV_MASK_SHA256 = (
    "6e208732b4dc66047e6d8ebf604514bf5ff51df84b89c314d13147237065b749"
)
OPENB_EVENTS = 10811

# The paper's method list (experiments/generate_run_scripts.py METHODS, the
# reference's AllMethodList) but 01-Random, with the digests of the JAX
# package's Simulator.run() of each on openb (tune 1.3, tuning seed 42,
# seed 42, shuffled): (id, [(policy, weight)], gpu_sel, dim_ext, norm,
# placed_node sha256, dev_mask sha256). tests/test_torch_driver.py pins
# them against tpusim.
METHODS = [
    ("02-DotProd", [("DotProductScore", 1000)], "best", "merge", "max",
     "cd3d3c92ae70688eb44a0885579d52f78abbf35023052660654587b748698607",
     "5d8d9ab31be34e43b941b69ebb27f90ad23008b18f4e59608212245b9ad06cb0"),
    ("03-GpuClustering", [("GpuClusteringScore", 1000)], "best", "share",
     "max",
     "2c3ff677fb68aea0aba8853501aa9fced09972a22c66a5f2614124ab8f4419f9",
     "0e48c0b272b2b1b3377c2db212c019d2edb69e9173dc2c053938d684ba0d051f"),
    ("04-GpuPacking", [("GpuPackingScore", 1000)], "best", "share", "max",
     "74be55bd5b76db02acd1781a8f69af0b9eda4810435a265dd773966da0049a5b",
     "e972b013cc96ee6973e610fea7452c10e56c962221e9a2be9698789cd634dad9"),
    ("05-BestFit", [("BestFitScore", 1000)], "best", "share", "max",
     "fd5cc9ca10d9b335f1bbd51776a2f1a4ed534a748c62d73d8a5741875f561f94",
     "98e69aab86a550b961e704280b1c29bc4b45d36104de1df54d64e6b1d0f28b29"),
    ("06-FGD", [("FGDScore", 1000)], "FGDScore", "share", "max",
     OPENB_PLACED_SHA256, OPENB_DEV_MASK_SHA256),
    ("07-PWR", [("PWRScore", 1000)], "PWRScore", "share", "max",
     "f0453b26bac83573e63248a8b95b8c9bfc06bd0c51ad6687832ed63f72498f99",
     "9ab248a0d5c742ad0faa1db91b6ab4279ca41d2bd28e39bdb9dd45e6e86c5572"),
    ("08-PWR_500_FGD_500", [("FGDScore", 500), ("PWRScore", 500)],
     "FGDScore", "share", "max",
     "b068adbcf082c8427ab0160a66d02a31db04d9f2f2eeac207acd792fd4f2e0e4",
     "c970edad98dcb61c2ecb588b9478f6e75ccca1b29b577d8a176217ee48655a21"),
    ("11-PWR_100_FGD_900", [("FGDScore", 900), ("PWRScore", 100)],
     "FGDScore", "share", "max",
     "c1f3f7fec3661e7fcaeea69135679a75d0aec4cb377b1dbd894517b369c66f15",
     "64b5801c48674ac3ff2de3e922021ee0a5bf682d8fbfaa8a12eb8ffb53678de6"),
    ("12-PWR_50_FGD_950", [("FGDScore", 950), ("PWRScore", 50)],
     "FGDScore", "share", "max",
     "17175fbaa7e0c6120116cf22b7034c0e86c233783075439fe712aaf850bcdf7b",
     "e77ee1c175eef12bcdfe2affac4075a653b06ac66e18476caa9fdec712100576"),
]

# The scale configuration of tpusim_torch/bench_scale.py (BASELINE.json
# config 5): nodes, pods, events replayed, chunk and seed, and the digests
# of the JAX package's replay of the first chunk (Simulator(engine="table")
# on the CPU: sha256 of placed_node as int32, of dev_mask as uint8).
# tests/test_torch_hbm_engine.py pins them against tpusim (slow-marked).
SCALE_NODES = 100_000
SCALE_PODS = 1_000_000
SCALE_EVENTS = 1_000_000
SCALE_CHUNK = 200_000
SCALE_SEED = 42
# the plain checks at the scale width: this many events of the stream from
# the state after the first chunk
SCALE_PREFIX = 2_000
# where auto's choice is measured: both replay kernels alone on the first
# CROSSOVER_EVENTS events of the stream at each width, for these rows
CROSSOVER_NODES = (10_000, 30_000, 100_000)
CROSSOVER_EVENTS = 20_000
CROSSOVER_ROWS = ("06-FGD", "05-BestFit", "08-PWR_500_FGD_500")
SCALE_PLACED_SHA256 = (
    "1f0be96bf52f89078eccb6314aef76dba3397c69cfdf5eda315de5669c22954d"
)
SCALE_DEV_MASK_SHA256 = (
    "27a746dd4d802700411c36654ad06fd0c716d87e07a948834fa732ab2f591c65"
)

# NVIDIA H100 SXM peaks (data sheet): HBM3 bandwidth and float32 outside
# the tensor cores, the type of FGD's arithmetic
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

REPLACES = {"init_tables": "tpusim/sim/pallas_engine.py:780",
            "replay": "tpusim/sim/pallas_engine.py:780",
            "replay_blocked": "tpusim/sim/pallas_engine.py:1346"}
# the kernels each residency's replay launches
RESIDENCY_KERNELS = {"vmem": ("init_tables", "replay"),
                     "hbm": ("init_tables", "replay_blocked")}
# rows whose replay is checked on ~1k-event random clusters; the other
# configurations get ~300 events
RANDOM_ROWS = ("02-DotProd", "03-GpuClustering", "04-GpuPacking",
               "05-BestFit", "07-PWR", "08-PWR_500_FGD_500")
DIM_EXT = ("merge", "share", "divide", "extend")
NORM = ("node", "pod", "max")
# node counts of the wide random blocked cases: 17 blocks (more than the
# block's 16 warps) and 513 (more than its 512 threads)
WIDE_BLOCKED = (2100, 65_600)
SOURCE = "tpusim_torch/kernels/replay.cu"
WARM_RUNS = 5  # the paper's FGD row; the other rows take 3


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def digest(a: np.ndarray, dtype) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype).tobytes()).hexdigest()


def kernel_ms(ready, repeats: int, reset=lambda: None,
              warmup: bool = True) -> float:
    """Median device milliseconds of one launch of a prepared kernel, with
    CUDA events around each launch alone: the launch's arguments are built
    once, and `reset`, queued before each start event, restores what the
    kernel mutates. With `warmup`, one untimed launch first loads the
    module. These launches go past the wrappers, so they add to no launch
    count."""
    import torch

    from tpusim_torch.sim.fused_engine import launch

    if warmup:
        reset()
        launch(ready)
    pairs = []
    for _ in range(repeats):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(ready)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def wall_ms(fn):
    """Host milliseconds of one fn() call ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def to_cpu(x):
    """A result (tensors, possibly in named tuples) as CPU tensors."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        parts = [to_cpu(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def max_abs_err(got, want) -> int:
    """Largest absolute difference over every tensor of two results."""
    import torch

    err = 0
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            err = max(err, max_abs_err(a, b))
        elif isinstance(a, torch.Tensor):
            if a.shape != b.shape:
                raise SmokeFailure(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
            err = max(err, int((a.long() - b.long()).abs().max()) if a.numel()
                      else 0)
    return err


def column_ops(name: str, ks: int, kw: int, t: int, norm: str) -> int:
    """Operations of one policy's column, all K = ks + kw types on one
    node, counted from its code in replay.cu (float32 operations, and for
    the integer columns their int32 operations):
    FGD        the node's current-frag sum over the T typical pods (2T),
               once; per share type 8 per-device hypothetical sums (16T)
               and 8 sigmoid scores of 6; per whole type one hypothetical
               sum (2T) and one sigmoid score (as counted before);
    BestFit    16 per type;
    GpuPacking ~420 per type (Sub's pick: 64 order compares, 64 ahead
               counts, then the tiers);
    GpuClustering ~30 per type;
    PWR        per share type ~60 (two CPU watt figures, 8 devices x 4),
               per whole type ~250 (with Sub's pick);
    DotProduct 9 slots x 14 per type (1 slot under merge), and 15 more
               per slot for tanh under norm=pod."""
    k = ks + kw
    if name == "FGDScore":
        return 2 * t + ks * (16 * t + 48) + kw * (2 * t + 6)
    if name == "DotProductScore":
        return k * (9 * 14 + (9 * 15 if norm == "pod" else 0))
    per_type = {"BestFitScore": 16, "GpuPackingScore": 420,
                "GpuClusteringScore": 30}
    if name == "PWRScore":
        return 60 * ks + 250 * kw
    return per_type[name] * k


def config_ops(cfg, ks: int, kw: int, t: int) -> int:
    """Operations of one column under a ReplayConfig: every policy's."""
    return sum(column_ops(p.name, ks, kw, t, cfg.norm) for p in cfg.policies)


def bound_ms(bytes_moved: int, ops: int):
    """(least milliseconds, what bounds it) from bytes and operations."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def chain_ms(step_ms: float, kinds: np.ndarray, n: int, k: int,
             refreshes: int, n_pol: int = 1) -> float:
    """Least time of the replay's serial event chain. Every event waits on
    the one before it, so each costs at least one step of the block's event
    loop, `step_ms` (this run's all-skip replay per event: the event's read
    and the two block barriers that stand for the block-wide agreement
    every event needs), plus its own bytes at the memory rate: on a create
    the type's feas row, each policy's score row and the ranks
    ((n_pol + 2) x 4 N bytes), on a refresh the dirty column ((n_pol + 2)
    K table entries) and its node, and on every event the event, the pod's
    fields, its outputs and one node's state."""
    creates = int((kinds == 0).sum())
    node_bytes = (1 + 1 + 1 + 1 + 8 + 9) * 4
    per_event = 2 * 4 + 7 * 4 + 5 * 4 + 2 * node_bytes
    bytes_moved = (creates * 4 * (n_pol + 2) * n
                   + refreshes * (4 * (n_pol + 2) * k + node_bytes)
                   + kinds.size * per_event)
    return kinds.size * step_ms + bytes_moved / PEAK_BYTES_PER_S * 1e3


def throughput_bound(n: int, k: int, t: int, p: int, e: int, n_pol: int,
                     refreshes: int, ops: int, extra_bytes: int = 0):
    """(ms, what bounds it) of a replay as if its events were independent:
    every input read once and every output written once (the node state
    and the tables both ways, the types, typical pods, pods, ranks and
    events in, the pod and event outputs out, and `extra_bytes`), and the
    operations of one column refresh per event after the first create or
    delete."""
    state_bytes = n * (1 + 1 + 1 + 1 + 8 + 9 + 1 + 1) * 4
    table_bytes = (n_pol + 2) * k * n * 4
    replay_bytes = (2 * state_bytes + 2 * table_bytes + 5 * k * 4 + 5 * t * 4
                    + p * 6 * 4 + n * 4 + e * 2 * 4 + p * 3 * 4 + e * 2 * 4
                    + extra_bytes)
    return bound_ms(replay_bytes, refreshes * ops)


def chain_blocked_ms(step_ms: float, kinds: np.ndarray, unpinned: int,
                     n: int, k: int, refreshes: int, n_pol: int, nn: int,
                     rebuilds: int) -> float:
    """Least time of replay_blocked's serial event chain: E x `step_ms`
    (this run's all-skip replay_blocked per event) plus each event's own
    bytes at the memory rate. Beside chain_ms's event, pod, output and node
    bytes, a refresh reads the dirty column ((n_pol + 2) K entries) and the
    block's K x 128 entries of every score row, the Filter row and the 128
    ranks, and writes the block's K summaries (3 values, plus 2 extrema per
    normalised policy); with nn normalised policies every event reads the
    type's 2 nn N/128 block extrema; each rebuild reads the type's n_pol + 1
    rows and the N ranks and writes its 3 N/128 summaries; an unpinned
    create reads its type's 2 N/128 summaries; the init reads every table
    entry and rank (twice with normalised policies) and writes every
    summary."""
    nblk = n // 128
    node_bytes = (1 + 1 + 1 + 1 + 8 + 9) * 4
    per_event = 2 * 4 + 7 * 4 + 5 * 4 + 2 * node_bytes + 2 * nn * nblk * 4
    refresh = (4 * (n_pol + 2) * k + node_bytes
               + 4 * ((n_pol + 1) * k + 1) * 128 + 4 * k * (3 + 2 * nn))
    rebuild = 4 * (n_pol + 2) * n + 4 * 3 * nblk
    init = ((2 if nn else 1) * 4 * ((n_pol + 1) * k * n + n)
            + 4 * k * nblk * (3 + 2 * nn))
    bytes_moved = (kinds.size * per_event + refreshes * refresh
                   + rebuilds * rebuild + unpinned * 2 * 4 * nblk + init)
    return kinds.size * step_ms + bytes_moved / PEAK_BYTES_PER_S * 1e3


def random_case(seed: int, num_nodes: int, num_pods: int, device):
    """A seeded random cluster, pods (CPU-only, share-GPU, multi-GPU, a few
    model-constrained and pinned), create/delete events, typical pods and
    tie-break ranks, as the port's tensors."""
    from tpusim_torch.sim.table_engine import build_pod_types
    from tpusim_torch.types import make_node_state, make_typical_pods, PodSpec
    import torch

    rng = np.random.default_rng(seed)
    gpu_cnt = rng.choice([0, 2, 4, 8], num_nodes, p=[0.15, 0.25, 0.35, 0.25])
    state = make_node_state(
        cpu_cap=rng.choice([32000, 64000, 96000, 128000], num_nodes),
        mem_cap=rng.choice([131072, 262144, 393216], num_nodes),
        gpu_cnt=gpu_cnt,
        gpu_type=[int(rng.integers(0, 4)) if g else -1 for g in gpu_cnt],
        cpu_type=rng.integers(0, 3, num_nodes), device=device,
    )
    kind = rng.integers(0, 3, num_pods)  # cpu-only, share, whole
    milli = np.where(kind == 1, rng.choice([100, 250, 500, 750], num_pods),
                     np.where(kind == 2, 1000, 0))
    num = np.where(kind == 2, rng.choice([1, 2, 4, 8], num_pods),
                   (kind == 1).astype(int))
    mask = np.where((kind > 0) & (rng.random(num_pods) < 0.25),
                    (1 << rng.integers(0, 4, num_pods))
                    | (1 << rng.integers(0, 4, num_pods)), 0)
    pinned = np.where(rng.random(num_pods) < 0.02,
                      rng.integers(0, num_nodes, num_pods), -1)

    def col(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    pods = PodSpec(col(rng.choice([1000, 2000, 4000, 8000, 16000], num_pods)),
                   col(rng.choice([1024, 4096, 16384], num_pods)),
                   col(milli), col(num), col(mask), col(pinned))
    kinds, idx, alive = [], [], []
    for i in range(num_pods):
        kinds.append(0)
        idx.append(i)
        alive.append(i)
        if rng.random() < 0.34 and len(alive) > 1:
            victim = alive.pop(int(rng.integers(0, len(alive))))
            kinds.append(1)
            idx.append(victim)
    t = 24
    freq = rng.random(t).astype(np.float32)
    tp = make_typical_pods(zip(
        rng.choice([1000, 4000, 8000, 16000], t),
        rng.choice([0, 100, 250, 500, 1000], t),
        rng.choice([1, 2], t), rng.choice([0, 1, 6], t),
        freq / freq.sum()), device)
    rank = col(rng.permutation(num_nodes))
    return (state, pods, build_pod_types(pods), col(kinds), col(idx), tp,
            rank)


def check_configs():
    """(label, ReplayConfig, pods of its random case) of every policy
    configuration the kernels cover and this script checks: the method
    rows, the eleven other DotProduct (dim_ext, norm) pairs, and FGD with
    gpu_sel worst. FGD under gpu_sel FGDScore and best is checked on three
    seeds of its own."""
    from tpusim_torch.sim import fused_engine as fe

    out = []
    for mid, policies, gpu_sel, dim_ext, norm, *_ in METHODS:
        if mid != "06-FGD":
            out.append((mid, fe.make_config(policies, gpu_sel, dim_ext, norm),
                        800 if mid in RANDOM_ROWS else 230))
    for dim_ext in DIM_EXT:
        for norm in NORM:
            if (dim_ext, norm) != ("merge", "max"):
                out.append((f"DotProd-{dim_ext}-{norm}", fe.make_config(
                    [("DotProductScore", 1000)], "DotProductScore", dim_ext,
                    norm), 230))
    out.append(("FGD-worst", fe.make_config([("FGDScore", 1000)], "worst"),
                230))
    return out


def check_random(device):
    """Both kernels against their plain versions on seeded random
    clusters of 256 nodes, for every checked configuration. Returns the
    largest error of each kernel."""
    import torch

    from tpusim_torch.sim import fused_engine as fe

    worst = {"init_tables": 0, "replay": 0}
    fgd = [(f"06-FGD seed={seed}", fe.make_config(
        [("FGDScore", 1000)], "FGDScore" if seed != 3 else "best"), 800)
        for seed in (1, 2, 3)]
    for i, (label, cfg, num_pods) in enumerate(fgd + check_configs()):
        state, pods, types, evk, evp, tp, rank = random_case(
            i + 1, 256, num_pods, device)
        tables = fe.init_tables(state, types, tp, cfg)
        plain_tables = fe.plain_init_tables(state, types, tp, cfg)
        err_t = max_abs_err(tables, plain_tables)
        args = (state, pods, types, evk, evp, tp, rank, plain_tables, cfg)
        err_r = max_abs_err(fe.replay(*args), fe.plain_replay(*args))
        torch.cuda.synchronize()
        print(f"check random {label} nodes=256 events={evk.shape[0]}: "
              f"init_tables max_abs_err={err_t} replay max_abs_err={err_r} "
              f"(tolerance 0)")
        if err_t or err_r:
            raise SmokeFailure(f"a kernel disagrees with its plain version "
                               f"on the random case of {label}")
        worst["init_tables"] = max(worst["init_tables"], err_t)
        worst["replay"] = max(worst["replay"], err_r)
    return worst


def blocked_configs():
    """(label, ReplayConfig) of every method row and FGD/worst."""
    from tpusim_torch.sim import fused_engine as fe

    return ([(row[0], fe.make_config(*row[1:5])) for row in METHODS]
            + [("FGD-worst", fe.make_config([("FGDScore", 1000)], "worst"))])


def check_random_blocked(device) -> int:
    """replay_blocked against plain_replay_blocked, which runs on CPU
    copies of the same inputs, on seeded random clusters: of 600 nodes
    (five 128-node blocks once padded) for every method row's configuration
    and FGD/worst, and for the normalised BestFit and PWR+FGD rows also of
    WIDE_BLOCKED nodes, where a warp rebuilds several blocks of a summary
    row and the select and drift loops stride over more blocks than the
    block has threads. Outputs and stats, tolerance 0. Returns the largest
    error."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    configs = dict(blocked_configs())
    cases = [(label, 600) for label in configs]
    cases += [(label, nodes) for nodes in WIDE_BLOCKED
              for label in ("05-BestFit", "08-PWR_500_FGD_500")]
    worst = 0
    for i, (label, nodes) in enumerate(cases):
        cfg = configs[label]
        state, pods, types, evk, evp, tp, rank = random_case(
            100 + i, nodes, 300, device)
        state, rank = pad_nodes(state, rank, 128)
        tables = fe.init_tables(state, types, tp, cfg)
        ready = he.prepare_replay_blocked(state, pods, types, evk, evp, tp,
                                          rank, tables, cfg)
        fe.launch(ready)  # a comparison: past the wrapper, not counted
        got = to_cpu(ready.finish())
        want = he.plain_replay_blocked(*to_cpu(
            (state, pods, types, evk, evp, tp, rank, tables)), cfg)
        err = max_abs_err(got, want)
        print(f"check random blocked {label} nodes={nodes} "
              f"({state.num_nodes // 128} blocks) events={evk.shape[0]}: "
              f"replay_blocked max_abs_err={err} (tolerance 0, stats "
              f"{got[1].tolist()} against {want[1].tolist()})")
        if err:
            raise SmokeFailure(f"replay_blocked disagrees with "
                               f"plain_replay_blocked on {label} at "
                               f"{nodes} nodes")
        worst = max(worst, err)
    return worst


def openb_inputs(device):
    """The paper's prepared openb trace as the port's tensors."""
    import torch

    from tpusim_torch.__main__ import paper_config
    from tpusim_torch.io.trace import (
        build_events, load_node_csv, load_pod_csv, pods_to_specs,
    )
    from tpusim_torch.sim.driver import Simulator
    from tpusim_torch.sim.table_engine import build_pod_types

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    sim = Simulator(load_node_csv(os.path.join(
        data, "openb_node_list_gpu_node.csv")), paper_config(), device)
    sim.set_workload_pods(load_pod_csv(os.path.join(
        data, "openb_pod_list_default.csv")))
    sim.set_typical_pods()
    trace = sim.prepare_pods()
    specs = pods_to_specs(trace, sim.node_index, device)
    evk, evp = (torch.as_tensor(a, device=device)
                for a in build_events(trace))
    return (sim.init_state, specs, build_pod_types(specs), evk, evp,
            sim.typical, sim.rank)


def check_kernels(device, card: str):
    """Phase 3: each kernel against its plain version on the card, and
    each method row's kernel times at openb beside their bounds."""
    import torch

    from tpusim_torch.sim import fused_engine as fe

    worst = check_random(device)
    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    n, k, t = state.num_nodes, types.num_types, tp.size
    ks, kw = types.num_share, types.num_types - types.num_share
    e, p = evk.shape[0], specs.cpu.shape[0]

    # the init tables of every configuration at openb size
    rows = [(row[0], fe.make_config(*row[1:5])) for row in METHODS]
    plain_init = {}
    for label, cfg in rows + [(c[0], c[1]) for c in check_configs()
                              if c[0] not in dict(rows)]:
        ready = fe.prepare_init_tables(state, types, tp, cfg)
        init_ms = kernel_ms(ready, 20)
        plain_ms, plain_tables = wall_ms(
            lambda: fe.plain_init_tables(state, types, tp, cfg))
        err = max_abs_err(ready.finish(), plain_tables)
        plain_init[label] = (init_ms, plain_ms, plain_tables)
        print(f"check openb init_tables {label} [{len(cfg.policies)}x{k}, "
              f"{n}]: max_abs_err={err} (tolerance 0); {init_ms:.4f} ms "
              f"(plain {plain_ms:.1f} ms)")
        if err:
            raise SmokeFailure(f"init_tables disagrees with plain_init_tables"
                               f" on openb under {label}")
        worst["init_tables"] = max(worst["init_tables"], err)

    def prepared(cfg, tables, kinds=evk):
        ready = fe.prepare_replay(state, specs, types, kinds, evp, tp, rank,
                                  tables, cfg)
        live = ready.tensors

        def reset():
            for name, src in (("cpu_left", state.cpu_left),
                              ("mem_left", state.mem_left),
                              ("gpu_left", state.gpu_left),
                              ("aff_cnt", state.aff_cnt), ("score", tables[0]),
                              ("sdev", tables[1]), ("feas", tables[2])):
                live[name].copy_(src)
            live["placed"].fill_(-1)
            live["maskb"].zero_()
            live["failed"].zero_()
        return ready, reset

    # the event chain without work: the same number of events, all skips,
    # through the FGD-specialised and the general kernel
    skip_ms = {}
    for label in ("06-FGD", "08-PWR_500_FGD_500"):
        cfg = dict(rows)[label]
        ready, _ = prepared(cfg, plain_init[label][2],
                            torch.full_like(evk, 2))
        skip_ms[label] = kernel_ms(ready, 3)
        print(f"time openb replay all-skip ({label} kernel): {e} events "
              f"{skip_ms[label]:.3f} ms, {skip_ms[label] / e * 1e3:.3f} us "
              f"each, on {card}")

    kinds = evk.cpu().numpy()
    started = np.flatnonzero(kinds != 2)
    refreshes = int(e - started[0] - 1) if started.size else 0
    tp_bytes = 5 * t * 4
    type_bytes = 5 * k * 4
    state_bytes = n * (1 + 1 + 1 + 1 + 8 + 9 + 1 + 1) * 4
    measured = {}
    # FGD/worst runs the one-FGD configuration through the general kernel:
    # what the runtime policy switch costs beside 06-FGD's specialised one
    timed = rows + [("FGD-worst", fe.make_config([("FGDScore", 1000)],
                                                 "worst"))]
    for label, cfg in timed:
        init_ms, plain_init_ms, tables = plain_init[label]
        ready, reset = prepared(cfg, tables)
        replay_ms = kernel_ms(ready, 3, reset)
        plain_replay_ms = None
        if label == "06-FGD":  # the paper's row replays in full beside plain
            got = ready.finish()
            plain_replay_ms, want = wall_ms(lambda: fe.plain_replay(
                state, specs, types, evk, evp, tp, rank, tables, cfg))
            err = max_abs_err(got, want)
            print(f"check openb replay 06-FGD E={e} P={p}: max_abs_err={err}"
                  f" (tolerance 0); plain {plain_replay_ms:.1f} ms")
            if err:
                bad = (got.event_node != want.event_node).nonzero()
                raise SmokeFailure(
                    "replay disagrees with plain_replay; first differing "
                    f"event {int(bad[0]) if bad.numel() else 'none'}")
            worst["replay"] = max(worst["replay"], err)
        # bounds from this run's inputs: every input read once, every output
        # written once; the replay refreshes one column per event after the
        # first create or delete, and is a serial chain of events besides
        n_pol = len(cfg.policies)
        table_bytes = (n_pol + 2) * k * n * 4
        ops = config_ops(cfg, ks, kw, t)
        init_bound = bound_ms(state_bytes + type_bytes + tp_bytes
                              + table_bytes, n * ops)
        throughput = throughput_bound(n, k, t, p, e, n_pol, refreshes, ops)
        step = skip_ms["06-FGD" if label == "06-FGD"
                       else "08-PWR_500_FGD_500"] / e  # the kernel it runs
        chain = chain_ms(step, kinds, n, k, refreshes, n_pol)
        replay_bound = dict(bound_ms=chain, bound_by="operations",
                            bound_note="serial event chain: E x (one "
                            "all-skip step of the block + the event's bytes "
                            "at the memory rate)")
        if throughput[0] > chain:
            replay_bound = dict(bound_ms=throughput[0],
                                bound_by=throughput[1])
        print(f"time openb {label}: init_tables {init_ms:.4f} ms (bound "
              f"{init_bound[0]:.6f} by {init_bound[1]}), replay "
              f"{replay_ms:.3f} ms = {replay_ms / e * 1e3:.3f} us an event "
              f"(chain bound {chain:.4f} ms, throughput bound "
              f"{throughput[0]:.6f} ms by {throughput[1]}), kernel launches "
              f"alone, on {card}")
        measured[label] = {
            "init_tables": dict(ms=init_ms, plain_ms=plain_init_ms,
                                bound_ms=init_bound[0],
                                bound_by=init_bound[1]),
            "replay": dict(ms=replay_ms, plain_ms=plain_replay_ms,
                           **replay_bound),
        }
    return measured, worst


def check_blocked(device, card: str):
    """Phase 3 for replay_blocked: against its plain version on random
    clusters and on the full openb FGD trace, and each method row's kernel
    time at openb (node axis padded to 1280, tables from init_tables)
    beside its bound."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.residency import num_normalized

    worst = check_random_blocked(device)
    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    state, rank = pad_nodes(state, rank, 128)
    n, k, t = state.num_nodes, types.num_types, tp.size
    ks, kw = types.num_share, types.num_types - types.num_share
    e, p = evk.shape[0], specs.cpu.shape[0]
    kinds = evk.cpu().numpy()
    started = np.flatnonzero(kinds != 2)
    refreshes = int(e - started[0] - 1) if started.size else 0
    pinned = specs.pinned.cpu().numpy()[evp.cpu().numpy()]
    unpinned = int(((kinds == 0) & (pinned < 0)).sum())

    def prepared(cfg, tables, kinds=evk):
        ready = he.prepare_replay_blocked(state, specs, types, kinds, evp, tp,
                                          rank, tables, cfg)
        live = ready.tensors

        def reset():
            for name, src in (("cpu_left", state.cpu_left),
                              ("mem_left", state.mem_left),
                              ("gpu_left", state.gpu_left),
                              ("aff_cnt", state.aff_cnt), ("score", tables[0]),
                              ("sdev", tables[1]), ("feas", tables[2])):
                live[name].copy_(src)
            live["placed"].fill_(-1)
            live["maskb"].zero_()
            live["failed"].zero_()
        return ready, reset

    measured = {}
    for row in METHODS:
        label, cfg = row[0], fe.make_config(*row[1:5])
        n_pol, nn = len(cfg.policies), num_normalized(cfg.policies)
        tables = fe.init_tables(state, types, tp, cfg)
        ready, _ = prepared(cfg, tables, torch.full_like(evk, 2))
        step = kernel_ms(ready, 3) / e
        ready, reset = prepared(cfg, tables)
        blocked_ms = kernel_ms(ready, 3, reset)
        got = ready.finish()  # the last timed launch ran from the reset state
        rebuilds = int(got[1][2])
        plain_ms = None
        if label == "06-FGD":  # the paper's row replays in full beside plain
            plain_ms, want = wall_ms(lambda: he.plain_replay_blocked(
                *to_cpu((state, specs, types, evk, evp, tp, rank, tables)),
                cfg))
            err = max_abs_err(to_cpu(got), want)
            print(f"check openb replay_blocked 06-FGD E={e} P={p} N={n}: "
                  f"max_abs_err={err} (tolerance 0, stats "
                  f"{got[1].tolist()}); plain {plain_ms:.1f} ms on the CPU")
            if err:
                raise SmokeFailure("replay_blocked disagrees with "
                                   "plain_replay_blocked on openb")
            worst = max(worst, err)
        chain = chain_blocked_ms(step, kinds, unpinned, n, k, refreshes,
                                 n_pol, nn, rebuilds)
        throughput = throughput_bound(
            n, k, t, p, e, n_pol, refreshes, config_ops(cfg, ks, kw, t),
            4 * k * (n // 128) * (3 + 2 * nn))
        bound = dict(bound_ms=chain, bound_by="operations",
                     bound_note="serial event chain: E x (one all-skip step "
                     "of replay_blocked + the event's bytes at the memory "
                     "rate)")
        if throughput[0] > chain:
            bound = dict(bound_ms=throughput[0], bound_by=throughput[1])
        print(f"time openb {label}: replay_blocked {blocked_ms:.3f} ms = "
              f"{blocked_ms / e * 1e3:.3f} us an event, {rebuilds} rebuilds, "
              f"all-skip {step * 1e3:.3f} us an event (chain bound "
              f"{chain:.4f} ms, throughput bound {throughput[0]:.6f} ms by "
              f"{throughput[1]}), kernel launches alone, on {card}")
        measured[label] = dict(ms=blocked_ms, plain_ms=plain_ms,
                               rebuilds=rebuilds, **bound)
        if plain_ms is not None:
            measured[label]["plain_note"] = ("plain_replay_blocked on CPU "
                                             "copies of the inputs")
    return measured, worst


def run_counts() -> dict:
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine  # noqa: F401 (its wrapper)

    return {fn.__name__: fn.launches for fn in fe.KERNEL_WRAPPERS}


def check_launches(label: str, counts: dict, tier: str, sim) -> None:
    """The run launched every kernel of its residency and not the other
    replay kernel."""
    want = RESIDENCY_KERNELS[tier]
    missing = [name for name in want if counts[name] == 0]
    stray = [name for name, c in counts.items() if c and name not in want]
    if sim.last_residency != tier or missing or stray:
        raise SmokeFailure(f"{label}: residency {sim.last_residency} (want "
                           f"{tier}), launches {counts}: never launched "
                           f"{missing}, launched {stray}")


def main_path(device, card: str):
    """Phase 4: every method row through Simulator.run() on the card, with
    table_residency "auto" and then "hbm", the launch counts set to 0
    before each run and read after it. Returns {run label: counts}."""
    import dataclasses

    import torch

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.io.trace import (
        build_events, load_node_csv, load_pod_csv, pods_to_specs,
    )
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    nodes = load_node_csv(os.path.join(data, "openb_node_list_gpu_node.csv"))
    pods = load_pod_csv(os.path.join(data, "openb_pod_list_default.csv"))

    launches = {}
    for mid, policies, gpu_sel, dim_ext, norm, placed_sha, mask_sha in METHODS:
        for setting, tier in (("auto", "vmem"), ("hbm", "hbm")):
            label = mid if setting == "auto" else f"{mid}/hbm"
            cfg = dataclasses.replace(
                method_config(policies, gpu_sel, dim_ext, norm),
                table_residency=setting)
            fe.reset_launch_counts()
            t0 = time.perf_counter()
            sim = Simulator(nodes, cfg, device=device)
            sim.set_workload_pods(pods)
            res = sim.run()
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            counts = run_counts()
            check_launches(label, counts, tier, sim)
            launches[label] = counts
            if label == "06-FGD":
                print("\n".join(sim.log.lines[-19:]))

            failed = len(res.unscheduled_pods)
            placements = len(res.pods) - failed
            s = res.state
            slot = (torch.arange(8)[None, :] < s.gpu_cnt[:, None])
            used = int(torch.where(slot, 1000 - s.gpu_left, 0).sum())
            alloc = 100.0 * used / (int(s.gpu_cnt.sum()) * 1000)
            got_placed = digest(res.placed_node, np.int32)
            got_mask = digest(res.dev_mask, np.uint8)
            if res.events != OPENB_EVENTS or got_placed != placed_sha \
                    or got_mask != mask_sha:
                raise SmokeFailure(
                    f"{label}: main path differs from the JAX reference: "
                    f"events {res.events} placed sha256 {got_placed} "
                    f"dev_mask sha256 {got_mask}")

            trace = sim.prepare_pods()
            specs = pods_to_specs(trace, sim.node_index, device)
            evk, evp = build_events(trace)
            walls = []
            for _ in range(WARM_RUNS if label == "06-FGD" else 3):
                ms, _ = wall_ms(lambda: sim.run_events(
                    sim.init_state, specs, evk, evp))
                walls.append(ms / 1e3)
            warm = min(walls)
            stats = (f", stats {sim.last_kernel_stats}"
                     if sim.last_kernel_stats is not None else "")
            print(f"main path {label}: {sim.last_engine} ({tier}), launches "
                  f"{counts}{stats}, events={res.events} "
                  f"placements={placements} failed={failed} "
                  f"gpu_alloc={alloc:.2f}%, digests match the JAX reference;"
                  f" cold run() {cold_s:.3f} s, warm replay min "
                  f"{warm * 1e3:.2f} ms of {len(walls)} "
                  f"({', '.join(f'{w * 1e3:.2f}' for w in walls)} ms), "
                  f"{placements / warm:.1f} placements/s on {card}")
    return launches


def scale_path(device, card: str):
    """Phase 5: tpusim_torch.bench_scale's path at 100k nodes, residency
    "auto", the launch counts set to 0 before it and read after it; then
    the flat replay over the same chunks, each kernel alone on the first
    chunk, the plain checks at this width and the crossover timings.
    Returns (counts, {kernel: its numbers at this scale, "errors": the
    plain checks' largest error of each kernel})."""
    import torch

    from tpusim_torch import bench_scale as bs
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    t0 = time.perf_counter()
    nodes = bs.synth_cluster(SCALE_NODES, SCALE_SEED)
    pods = bs.synth_pods(SCALE_PODS, SCALE_SEED + 1)
    auto = bs.ScaleRun(nodes, pods, bs.scale_config(SCALE_SEED, "auto"),
                       device)
    sim, types = auto.sim, auto.types
    k, n = types.num_types, SCALE_NODES
    print(f"scale setup: {n} nodes, {SCALE_PODS} pods, K={k}, T="
          f"{sim.typical.size}, {time.perf_counter() - t0:.1f} s on the host")

    fe.reset_launch_counts()
    wall, (state, results, failed, rebuilds) = wall_ms(
        lambda: auto.replay(SCALE_CHUNK, SCALE_EVENTS))
    counts = run_counts()
    check_launches("scale", counts, "hbm", sim)
    if counts["replay_blocked"] != len(results):
        raise SmokeFailure(f"scale: {len(results)} chunks but launches "
                           f"{counts}")
    got = (digest(results[0].placed_node.cpu().numpy(), np.int32),
           digest(results[0].dev_mask.cpu().numpy(), np.uint8))
    if got != (SCALE_PLACED_SHA256, SCALE_DEV_MASK_SHA256):
        raise SmokeFailure(f"scale: the first chunk differs from the JAX "
                           f"reference: placed sha256 {got[0]} dev_mask "
                           f"sha256 {got[1]}")
    placed = SCALE_EVENTS - failed
    print(f"scale path: {sim.last_engine} ({sim.last_residency}), launches "
          f"{counts}, {SCALE_EVENTS} events in {len(results)} chunks, "
          f"placed={placed} gpu_alloc={bs.gpu_alloc(state):.2f}% "
          f"rebuilds={rebuilds}, first chunk's digests match the JAX "
          f"reference; wall {wall / 1e3:.3f} s, "
          f"{wall * 1e3 / SCALE_EVENTS:.3f} us an event, "
          f"{placed / (wall / 1e3):.1f} placements/s on {card}")

    # the flat replay over the same chunks (a comparison: not counted)
    flat = bs.ScaleRun(nodes, pods, bs.scale_config(SCALE_SEED, "vmem"),
                       device)
    wall_f, (_, results_f, _, _) = wall_ms(
        lambda: flat.replay(SCALE_CHUNK, SCALE_EVENTS))
    err = max(max_abs_err(a, b) for a, b in zip(results, results_f))
    print(f"check scale: {flat.sim.last_engine} against replay_blocked over "
          f"{len(results_f)} chunks: max_abs_err={err} (tolerance 0); wall "
          f"{wall_f / 1e3:.3f} s, {wall_f * 1e3 / SCALE_EVENTS:.3f} us an "
          f"event")
    if err or flat.sim.last_engine != "replay":
        raise SmokeFailure("scale: the flat replay and replay_blocked differ")

    # each kernel alone on the first chunk, one timed launch, beside the
    # all-skip step of the same length and the chain bounds
    cfg = fe.make_config(list(sim.cfg.policies), sim.cfg.gpu_sel_method)
    evk = torch.as_tensor(auto.ev_kind[:SCALE_CHUNK], device=device)
    evp = torch.as_tensor(auto.ev_pod[:SCALE_CHUNK], device=device)
    kinds = auto.ev_kind[:SCALE_CHUNK]
    started = np.flatnonzero(kinds != 2)
    refreshes = int(kinds.size - started[0] - 1) if started.size else 0
    pinned = auto.specs.pinned.cpu().numpy()[auto.ev_pod[:SCALE_CHUNK]]
    unpinned = int(((kinds == 0) & (pinned < 0)).sum())
    skips = torch.full_like(evk, 2)
    tp, p, e = sim.typical, SCALE_PODS, SCALE_CHUNK
    ops = config_ops(cfg, types.num_share, k - types.num_share, tp.size)
    out = {}
    for name, (st, rank) in (("replay", (sim.init_state, sim.rank)),
                             ("replay_blocked", pad_nodes(
                                 sim.init_state, sim.rank, 128))):
        init = fe.prepare_init_tables(st, types, tp, cfg)
        init_ms = kernel_ms(init, 3)
        tables = init.finish()
        prep = (fe.prepare_replay if name == "replay"
                else he.prepare_replay_blocked)
        step = kernel_ms(prep(st, auto.specs, types, skips, evp, tp, rank,
                              tables, cfg), 3) / e
        ms = kernel_ms(prep(st, auto.specs, types, evk, evp, tp, rank,
                            tables, cfg), 1, warmup=False)
        width = st.num_nodes
        # every node's state, the types and typical pods read once, the
        # three tables written once; one column per node
        init_bound = bound_ms(
            width * (1 + 1 + 1 + 1 + 8 + 9 + 1 + 1) * 4 + 5 * k * 4
            + 5 * tp.size * 4 + 3 * k * width * 4, width * ops)
        if name == "replay":
            chain = chain_ms(step, kinds, width, k, refreshes)
            extra = 0
        else:
            chain = chain_blocked_ms(step, kinds, unpinned, width, k,
                                     refreshes, 1, 0, 0)
            extra = 4 * k * (width // 128) * 3
        throughput = throughput_bound(width, k, tp.size, p, e, 1,
                                      refreshes, ops, extra)
        bound = dict(bound_ms=chain, bound_by="operations",
                     bound_note="serial event chain")
        if throughput[0] > chain:
            bound = dict(bound_ms=throughput[0], bound_by=throughput[1])
        print(f"time scale first chunk ({e} events, {n} nodes, N={width}): "
              f"{name} {ms:.3f} ms = {ms / e * 1e3:.3f} us an event "
              f"(all-skip {step * 1e3:.3f} us an event, chain bound "
              f"{chain:.3f} ms, throughput bound {throughput[0]:.6f} ms by "
              f"{throughput[1]}); init_tables {init_ms:.4f} ms (bound "
              f"{init_bound[0]:.6f} by {init_bound[1]}); kernel launches "
              f"alone, on {card}")
        out[name] = dict(ms=ms, plain_ms=None, events=e,
                         wall_s=(wall if name == "replay_blocked"
                                 else wall_f) / 1e3, **bound)
        out[f"init_tables/{name}"] = dict(ms=init_ms, plain_ms=None,
                                          bound_ms=init_bound[0],
                                          bound_by=init_bound[1])
    out["errors"] = scale_plain_checks(auto, results[0].state, device)
    crossover(auto, results[0].state, device, card)
    return counts, out


def scale_plain_checks(auto, state, device) -> dict:
    """init_tables and both replay kernels against their plain versions at
    the scale width, from `state` (the node state after the first chunk,
    on the card) over the next SCALE_PREFIX events of the stream: the
    scale configuration (init_tables and replay_blocked at N = 100,096,
    replay at 100,000) and the normalised 05-BestFit and 08 rows
    (replay_blocked; init_tables for BestFit, whose plain table build is
    cheap). The plain versions run on CPU copies of the same inputs; the
    kernels launch past their wrappers. Tables, outputs and stats,
    tolerance 0. Returns the largest error of each kernel."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    sim, types, tp, specs = auto.sim, auto.types, auto.sim.typical, auto.specs
    lo, hi = SCALE_CHUNK, SCALE_CHUNK + SCALE_PREFIX
    evk = torch.as_tensor(auto.ev_kind[lo:hi], device=device)
    evp = torch.as_tensor(auto.ev_pod[lo:hi], device=device)
    padded, rank_p = pad_nodes(state, sim.rank, 128)
    rows = {row[0]: row for row in METHODS}
    worst = dict(init_tables=0, replay=0, replay_blocked=0)
    for label, kernels, check_init in (
            ("06-FGD", ("replay", "replay_blocked"), True),
            ("05-BestFit", ("replay_blocked",), True),
            ("08-PWR_500_FGD_500", ("replay_blocked",), False)):
        cfg = fe.make_config(*rows[label][1:5])
        tables = {}
        for st in (state, padded):
            init = fe.prepare_init_tables(st, types, tp, cfg)
            fe.launch(init)
            tables[st.num_nodes] = init.finish()
        if check_init:
            t0 = time.perf_counter()
            want = fe.plain_init_tables(*to_cpu((padded, types, tp)), cfg)
            plain_s = time.perf_counter() - t0
            err = max_abs_err(to_cpu(tables[padded.num_nodes]), want)
            print(f"check scale init_tables {label} [{len(cfg.policies)}x"
                  f"{types.num_types}, {padded.num_nodes}] from the state "
                  f"after the first chunk: max_abs_err={err} (tolerance 0);"
                  f" plain {plain_s:.1f} s on the CPU")
            worst["init_tables"] = max(worst["init_tables"], err)
        for name in kernels:
            st, rank = ((state, sim.rank) if name == "replay"
                        else (padded, rank_p))
            prep, plain = ((fe.prepare_replay, fe.plain_replay)
                           if name == "replay" else
                           (he.prepare_replay_blocked,
                            he.plain_replay_blocked))
            args = (st, specs, types, evk, evp, tp, rank,
                    tables[st.num_nodes])
            ready = prep(*args, cfg)
            fe.launch(ready)
            got = to_cpu(ready.finish())
            t0 = time.perf_counter()
            want = plain(*to_cpu(args), cfg)
            plain_s = time.perf_counter() - t0
            err = max_abs_err(got, want)
            stats = (f", stats {got[1].tolist()} against "
                     f"{want[1].tolist()}" if name != "replay" else "")
            print(f"check scale {name} {label} N={st.num_nodes} events "
                  f"{lo}..{hi} from the state after the first chunk: "
                  f"max_abs_err={err} (tolerance 0{stats}); plain "
                  f"{plain_s:.1f} s on the CPU")
            worst[name] = max(worst[name], err)
    if any(worst.values()):
        raise SmokeFailure(f"scale: a kernel disagrees with its plain version "
                           f"at the scale width: {worst}")
    return worst


def crossover(auto, after, device, card) -> None:
    """Where auto's choice pays: both replay kernels alone, one launch
    each, on CROSSOVER_EVENTS events of the scale stream under the
    CROSSOVER_ROWS configurations, at each of CROSSOVER_NODES synthetic
    nodes from the cluster's initial state, and at the scale width also
    from `after`, the state after the first chunk (events from
    SCALE_CHUNK on). Prints each pair beside the tier auto picks there."""
    import torch

    from tpusim_torch import bench_scale as bs
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.driver import Simulator
    from tpusim_torch.sim.residency import select_residency

    types, tp, specs = auto.types, auto.sim.typical, auto.specs
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    rows = {row[0]: row for row in METHODS}
    windows = []
    for nodes in CROSSOVER_NODES:
        sim = auto.sim if nodes == SCALE_NODES else Simulator(
            bs.synth_cluster(nodes, SCALE_SEED), bs.scale_config(SCALE_SEED),
            device)
        windows.append((nodes, "initial state", sim.init_state, sim.rank, 0))
    windows.append((SCALE_NODES, "state after the first chunk", after,
                    auto.sim.rank, SCALE_CHUNK))
    for nodes, where, state, rank, lo in windows:
        hi = lo + CROSSOVER_EVENTS
        evk = torch.as_tensor(auto.ev_kind[lo:hi], device=device)
        evp = torch.as_tensor(auto.ev_pod[lo:hi], device=device)
        padded, rank_p = pad_nodes(state, rank, 128)
        for label in CROSSOVER_ROWS:
            cfg = fe.make_config(*rows[label][1:5])
            ms, rebuilds = {}, 0
            for name, st, rk, prep in (
                    ("replay", state, rank, fe.prepare_replay),
                    ("replay_blocked", padded, rank_p,
                     he.prepare_replay_blocked)):
                init = fe.prepare_init_tables(st, types, tp, cfg)
                fe.launch(init)
                ready = prep(st, specs, types, evk, evp, tp, rk,
                             init.finish(), cfg)
                ms[name] = kernel_ms(ready, 1, warmup=False)
                if name == "replay_blocked":
                    rebuilds = int(ready.finish()[1][2])
            tier = select_residency(nodes, types.num_types,
                                    len(cfg.policies), l2)
            print(f"time crossover {label} nodes={nodes} ({where}, events "
                  f"{lo}..{hi}): replay {ms['replay']:.3f} ms = "
                  f"{ms['replay'] / CROSSOVER_EVENTS * 1e3:.3f} us an event, "
                  f"replay_blocked {ms['replay_blocked']:.3f} ms = "
                  f"{ms['replay_blocked'] / CROSSOVER_EVENTS * 1e3:.3f} us an "
                  f"event, {rebuilds} rebuilds, blocked/flat "
                  f"{ms['replay_blocked'] / ms['replay']:.3f}; auto picks "
                  f"{tier}; kernel launches alone, on {card}")


def main() -> int:
    try:
        import torch
    except ImportError as err:
        print(f"chip_smoke: torch is not importable: {err}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    try:
        from tpusim_torch import kernels
    except ImportError as err:
        print(f"chip_smoke: the tpusim_torch package is missing: {err}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    try:
        card = card_line()
        print(f"card: {card}")
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda}")

        t0 = time.perf_counter()
        info = kernels.build()
        print(f"build: {info.seconds:.1f} s -> {info.path}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                print(f"ptxas: {line.strip()}")
        print(f"kernels: {', '.join(kernels.KERNELS)} "
              f"(route cuda, {SOURCE})")
        kernels.library()

        measured, errors = check_kernels(device, card)
        blocked, errors["replay_blocked"] = check_blocked(device, card)
        print(f"phase check done at {time.perf_counter() - t0:.1f} s")
        launches = main_path(device, card)
        print(f"phase main done at {time.perf_counter() - t0:.1f} s")
        launches["scale"], scale = scale_path(device, card)
        for name, err in scale.pop("errors").items():
            errors[name] = max(errors[name], err)
        print(f"phase scale done at {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1

    for label, m in blocked.items():
        measured.setdefault(label, {})["replay_blocked"] = m
    rows = []
    for name in kernels.KERNELS:
        configs = {}
        for label, m in measured.items():
            if name in m:
                runs = (label, f"{label}/hbm")
                configs[label] = dict(launches=sum(
                    launches.get(r, {}).get(name, 0) for r in runs),
                    **m[name])
        configs["scale"] = dict(launches=launches["scale"][name],
                                **scale[name if name != "init_tables"
                                        else "init_tables/replay_blocked"])
        rows.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=sum(c[name] for c in launches.values()),
            max_abs_err=errors[name], library_ms=None,
            **measured["06-FGD"][name], configs=configs,
        ))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
