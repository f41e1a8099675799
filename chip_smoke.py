"""Smoke run of the PyTorch/CUDA port (tpusim_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only clocks    # phases by name, repeatable

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. card    the card's name and power limit (nvidia-smi); a CUDA device is
           required.
2. build   the port's CUDA kernels, compiled from tpusim_torch/kernels/*.cu:
           the main library and the variants of kernels.VARIANTS (the
           clocked build), one nvcc each, all in parallel.
3. check   each kernel against its plain PyTorch version on the same inputs,
           tolerance zero (exact equality), for every policy configuration
           the kernels cover: init_tables on the full openb tables of each
           (flat and padded), on seeded random and type-shape cases, and on
           partly used clusters of INIT_NODES nodes under INIT_ROWS (1, 2,
           3 and 8 distinct device values a node, CPU-only nodes, share
           types that fit no device, Sub picks over unequal values,
           typical pods of frequency 0), beside an empty launch's time;
           replay on seeded random clusters (256 nodes, ~1k events for
           RANDOM_ROWS, ~300 for the other rows, DotProduct pairs,
           FGD/worst and the MIXES of RandomScore,
           gpu_sel random and Simon; the randomized ones through the
           randomized instantiation, from a root key) and on the openb
           trace: in full under FGD, FGD/worst and 01-Random (PLAIN_ROWS),
           and over its first 2,000 events under Simon and the six-policy
           profile (PREFIX_ROWS, the kernel timed on the same prefix), and
           replay_blocked on seeded random
           clusters of five 128-node blocks for every method row's
           configuration that draws nothing per event, FGD/worst and
           Simon+FGD, of 17 and 513 blocks for BestFit
           and PWR+FGD, and on the openb trace (in full under FGD, the
           prefix under Simon), its plain version on CPU copies of the
           inputs; both replay kernels on the type
           shapes of SHAPE_CASES (share items past a round of the block's
           threads, no share type, only share types, one typical pod, the
           most types and typical pods staged), with init_tables, and one
           type and one typical pod past those (PAST_LIMIT: the global
           forms) under FGD and the six-policy profile. Each replay check
           holds outputs, stats, the final
           tables and block summaries, and the tables against init_tables
           over the final state. Both replay kernels are timed per method
           row at openb, and replay for FGD/worst (the one-FGD
           configuration through the general kernel), beside the plain
           version and the bound; each timed run's placements and masks
           must match the row's JAX digests, and the bounds count refreshes
           from those placements (from the plain run for FGD/worst).
4. clocks  the phase split of both replay kernels through the clocked
           build (each run's outputs held to the main build's) for 06-FGD,
           05-BestFit, 08 and 01-Random (replay only) at openb and, in the
           scale phase, on the first
           2,000 events at 100k nodes; written to
           chiprun_out/phase_clocks.json.
5. main    Simulator.run() on the card for every row of the paper's method
           list, Simon alone and the six-policy profile of `simon apply`
           (openb gpu_node list, default trace, tune 1.3, tuning seed 42,
           seed 42), per-event reports on, once with table_residency
           "auto" (the flat replay at this size) and once with "hbm"
           (replay_blocked; the flat replay for 01-Random and the profile,
           which draw per event): the launch counts are set to 0
           before each run and read after it, the kernels of that run's
           residency must have been launched and the other replay kernel
           not, the placements and device masks must match the digests of
           the JAX package's run of the row, and so must simon.log (without
           its [Engine] line) and the analysis CSVs (REPORT_SHA256). Under
           "auto" the report half is timed beside the warm replay wall: the
           metrics post-pass on the card (CUDA events, median of 5 for
           06-FGD, of 3 for the other rows), the fetch, the Bellman series,
           the formatting and the CSV write (host clock); for 06-FGD the
           card's post-pass must equal the plain one on the CPU.
6. apply   `python -m tpusim_torch.cli apply`'s path (Applier.run): the
           openb gpu_node list and default trace written as YAML by the
           port's prepare_input, the paper's FGD scheduler config, tune
           1.3 with seed 42, shuffled, inflation 1.1, the snapshot
           exports, a YAML app (a Deployment, a DaemonSet, a pod pinned by
           nodeSelector, one with tolerations) and a Helm chart scheduled
           on the placed cluster, -e gpu --report (write_apply_bundle),
           once with table_residency "auto" and once with "hbm": the
           launch counts set to 0 before each run and read after it (each
           of the residency's kernels launched once a replay stage: the
           main replay, the inflation, each app), the standard output
           without its [Engine] lines and the three exported files held
           to the JAX package's digests (APPLY_SHA256), each stage timed
           (YAML ingestion, each replay and its report tail, the report
           tables, the whole run). Then the first app's replay, from the
           placed state, through replay and replay_blocked against their
           plain versions on CPU copies, tolerance 0. Last, `apply -f
           example/test-cluster-config.yaml` with no scheduler config (the
           built-in six-policy profile), its standard output held to
           APPLY_DEFAULT_SHA256.
7. scale   tpusim_torch.bench_scale's path: 100,000 synthetic nodes, the
           1M-pod stream in 200k-event chunks, residency "auto", with the
           launch counts set to 0 before and read after: auto must have
           chosen replay_blocked, the first chunk's placements and masks
           must match the JAX package's digests, and the flat replay over
           the same chunks must give identical outputs. Both kernels are
           timed. At the scale width init_tables and both replay kernels
           are held to their plain versions (CPU copies) over 2,000
           events from the state after the first chunk, for FGD, BestFit
           and PWR+FGD, tolerance 0 with stats and final tables; then both
           replay kernels are timed on 20,000 events at 10k, 30k and 100k
           nodes for 06-FGD, 05-BestFit and 08, beside the tier auto picks
           there.

Run with every phase, it then prints one JSON line describing the
kernels, the card's line, and as the last line {"ok": true, "device":
{...}}; with --only, the last two.

    python3 chip_smoke.py --ab PARENT CHANGE CHANGE PARENT

times the replay kernels of several checkouts of this repository in turns
instead (each a directory, for example a `git archive` unpacked under
chiprun_ab/). Each turn runs in a process of its own that imports that
checkout's tpusim_torch, builds its kernels and times each kernel launch
alone with CUDA events: on the openb trace under every method row,
`init_tables` (median of 20), `replay` and `replay_blocked` (median of 3,
state restored before each), and the main phase's replay wall (warm
Simulator.run_events, residency "auto", min of 5, host clock around a
synchronise); then, on the first chunk of the 100k-node
scale stream, `init_tables` (median of 3) and `replay_blocked` (one
launch). Every replay's placements, device masks and per-event nodes, and
every init_tables launch's tables, are digested, and all turns must agree
on them (rows a checkout cannot run, such as 01-Random before it had a
PRNG, are left out of its turn; the randomized rows time `replay` only).
It prints one line per turn and row, a table of the turns side by
side and each fresh build's ptxas register report, and writes the results
to chiprun_out/kernel_ab.json.

This script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import functools
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
# reference's AllMethodList), then Simon alone and the six-policy profile
# `simon apply` runs without a scheduler config (utils.go:251-272), with the
# digests of the JAX package's Simulator.run() of each on openb (tune 1.3,
# tuning seed 42, seed 42, shuffled; its table engine for 01-Random, Simon
# and the profile): (id, [(policy, weight)], gpu_sel, dim_ext, norm,
# placed_node sha256, dev_mask sha256). tests/test_torch_driver.py pins
# them against tpusim.
METHODS = [
    ("01-Random", [("RandomScore", 1000)], "random", "merge", "max",
     "56b1bcbba83821c3e6e88dd53c54c001561167abb19ae6e7fa420c90270d005c",
     "19ffe136ff49aa70d465291eb06bfb87e815010105e6aaee7144ea651ef53ab5"),
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
    ("Simon", [("Simon", 1000)], "best", "share", "max",
     "3739790efebefea2aebe49cdefaf8137dfc006969ae14c19b86f4edec0128006",
     "73ec8c65eaa239829bd3f277078bf70d429c543655c9d7c6f1c8ac5c8f2051fa"),
    ("default-profile", [("Simon", 1), ("BestFitScore", 1),
                         ("RandomScore", 1), ("DotProductScore", 1),
                         ("FGDScore", 1), ("PWRScore", 1)], "best", "share",
     "max",
     "56ecee404c6f5d0f012ebc8f4bd6f604bc77ded2e80742dec58d201a15a9a5b2",
     "fc042fdbcb252a66ba0ade461aa2703a1427d1b0fc04c2f72a24356e438998d8"),
]
# the rows that draw per event: they run the flat replay under any
# residency, from the main replay's root key, PRNGKey(seed 42)
RANDOMIZED_ROWS = ("01-Random", "default-profile")
OPENB_KEY = (0, 42)

# The files of one experiment that the report digests cover, in order:
# simon.log without its [Engine] line (which names the engine that ran)
# and the analysis CSVs.
REPORT_FILES = ("simon.log", "analysis.csv", "analysis_allo.csv",
                "analysis_cdol.csv", "analysis_fail.csv", "analysis_frag.csv",
                "analysis_pwr.csv")
# sha256 of each METHODS row's experiment files with per-event reports on
# (report_digest of the JAX package's Simulator.run(), finish() and
# experiments/analysis.py analyze_sim with row_meta, on the CPU).
# tests/test_torch_report.py pins them against tpusim.
REPORT_SHA256 = {
    "01-Random":
        "d17211ee728ff232781be782cae808b1f72c9be8b331da482256a020ac678b53",
    "02-DotProd":
        "3381e20d47132ca2619b9457a06935a2c6d64a450f43400906a59555f2a1beb9",
    "03-GpuClustering":
        "119a1dd21fdbf9d6cef51097c39d0c74af7b6fcf35675e5346d65f33989b6861",
    "04-GpuPacking":
        "0a6eb5a458961eaab866ce16d0ca1c125c43a787955ad84bc674f450006a86c6",
    "05-BestFit":
        "327956c411a56f79a0f331a45d30e7fd7d45710ff7dd481aa60e0ccbaef7b4d9",
    "06-FGD":
        "572dff81f444275e1a8d87e0dcfdcd7ba886b931a90654bdc00d8f5bf828e968",
    "07-PWR":
        "a693391ed183f9d710d7b1b3d909914bf4c82d7d2763f32152ceee2022f5d489",
    "08-PWR_500_FGD_500":
        "c49a9bfde26af4c6eff9be9182e74e83e4880d1a6ac06ce3cb85a641592198c7",
    "11-PWR_100_FGD_900":
        "ec06c060ad4a647bda043a3f9f79c76f92093966e2465a03c6f503cd4eead20f",
    "12-PWR_50_FGD_950":
        "f0c2ad2b2b3e5ebe4147970f1161f310d3c13d34abe7f7e5cbba7df980e74bf5",
    "Simon":
        "b2d7d8be74108792c620a5f7eb2d7de39943a335484fb3ebad71c0b97fc31d6a",
    "default-profile":
        "4496b46fd57ef1752ea5e3ac16f1860f21bada6f1db74755027367012f95fddc",
}

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
# 32-bit integer operations: 64 INT32 lanes per SM and clock (the Hopper
# white paper, half the FP32 lanes), 132 SMs, at the 1.98 GHz boost clock
# that the FP32 peak assumes
PEAK_INT32_PER_S = 64 * 132 * 1.98e9
# int32 operations of one threefry2x32 draw: 20 rounds of add, rotate and
# xor, six key injections of two adds (one with its round constant), the
# third key word's two xors, and the draw's xor and shift
THREEFRY_OPS = 20 * 3 + 6 * 2 + 5 + 2 + 2

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
# the other mixes of RandomScore, gpu_sel random and Simon the check phase
# holds to the plain versions: (label, [(policy, weight)], gpu_sel); the
# randomized ones flat only
MIXES = (
    ("Random-best", [("RandomScore", 1000)], "best"),
    ("FGD-random", [("FGDScore", 1000)], "random"),
    ("Random+FGD", [("RandomScore", 500), ("FGDScore", 500)], "FGDScore"),
    ("Simon+FGD", [("Simon", 500), ("FGDScore", 500)], "FGDScore"),
)
# a root key for the random cases (the event chain's, PRNGKey(7))
CHECK_KEY = (0, 7)
# the rows whose openb replay the check phase also runs through the plain
# version, beside the kernel: in full the paper's FGD row, FGD/worst (which
# has no JAX digest) and 01-Random (the randomized instantiation and the
# key chain over every event); Simon and the six-policy profile over the
# first PLAIN_PREFIX events (the kernel timed again on the same prefix),
# for their plain versions take minutes over the whole trace and the JAX
# digests already hold the whole of it
PLAIN_ROWS = ("06-FGD", "FGD-worst", "01-Random")
PREFIX_ROWS = ("Simon", "default-profile")
PLAIN_PREFIX = 2_000
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


def report_digests(exp_dir: str) -> dict:
    """{file: sha256} of an experiment directory's REPORT_FILES ("absent"
    for a file that is not there), the log without its [Engine] lines."""
    out = {}
    for name in REPORT_FILES:
        path = os.path.join(exp_dir, name)
        if not os.path.exists(path):
            out[name] = "absent"
            continue
        with open(path, "rb") as f:
            data = f.read()
        if name == "simon.log":
            data = b"".join(line for line in data.splitlines(keepends=True)
                            if b"[Engine]" not in line)
        out[name] = hashlib.sha256(data).hexdigest()
    return out


def report_digest(exp_dir: str) -> str:
    """One sha256 over report_digests' lines, in REPORT_FILES order."""
    lines = "".join(f"{name} {sha}\n"
                    for name, sha in report_digests(exp_dir).items())
    return hashlib.sha256(lines.encode()).hexdigest()


def row_meta(policies, gpu_sel: str, dim_ext: str) -> dict:
    """The meta columns experiments/run.py writes into analysis.csv for a
    METHODS row's experiment on openb (tune 1.3, tuning seed 42)."""
    from tpusim_torch.__main__ import POLICY_FLAGS

    return {"workload": "openb_pod_list_default",
            "policy": "_".join(f"{POLICY_FLAGS[n]}{w}" for n, w in policies),
            "tune": 1.3, "tune_seed": 42, "de": dim_ext, "gs": gpu_sel,
            "dr": 0.0, "dp": ""}


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


def empty_launch_ms(repeats: int) -> float:
    """Median device milliseconds of an empty kernel's launch through the
    port's library, timed as kernel_ms times a kernel: the floor under
    every launch's time."""
    import torch

    from tpusim_torch import kernels

    stream = torch.cuda.current_stream().cuda_stream
    kernels.launch_empty(stream)
    pairs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kernels.launch_empty(stream)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def reset_of(ready, state, tables):
    """A function that restores what a prepared replay mutates: the node
    state and tables it starts from, and its per-pod outputs."""
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
    return reset


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


def node_ops(cfg, state, types, tp) -> np.ndarray:
    """Operations of one column of every policy of `cfg` on each node, all
    K types, counted on this run's inputs (float32 operations, and for the
    integer columns their int32 operations). Work that depends on the node
    alone counts once a node, work that depends on a type once a (type,
    node) pair, and FGD's hypothetical sums once per distinct free device
    value that can take the type:
    FGD        the current frag, a sum over the T' typical pods with a
               frequency (2T'); per share type one hypothetical sum (2T')
               and sigmoid score (6) for each distinct free value of the
               node's devices that holds the type's milli; per whole type
               one of each;
    BestFit    8 a node (free GPU milli), 10 a type;
    GpuPacking 136 a node (idle devices; Sub's device order: 64 compares,
               64 counts), 70 a type (the take along that order, the tiers);
    GpuClustering 20 a node (the classes present, the pack term), 8 a type;
    PWR        153 a node (its watts now, Sub's device order); a share type
               ~55 (its CPU watts after the pod, 8 devices x 5), a whole
               type ~65 (its CPU watts, the take, the idle flips);
    DotProduct 32 a node (free milli, idle devices, groups); 9 slots x 14 a
               type (1 slot under merge), and 15 more a slot for tanh under
               norm=pod;
    Simon      3 a node (its capacities as floats), 14 a type (3
               conversions, subtractions, divisions and maxima, a multiply,
               a rounding);
    RandomScore none: it has no column (the replay's bound counts its
               draws).
    int64 [N]."""
    g = np.sort(state.gpu_left.cpu().numpy(), axis=1)
    first = np.ones(g.shape, bool)
    first[:, 1:] = g[:, 1:] != g[:, :-1]
    n = g.shape[0]
    ks, k = types.num_share, types.num_types
    kw = k - ks
    t = int((tp.freq.cpu().numpy() != 0).sum())
    # per node, the (share type, distinct value that holds it) pairs
    values = np.zeros(n, np.int64)
    milli, count = np.unique(types.share.gpu_milli.cpu().numpy(),
                             return_counts=True)
    for m, c in zip(milli.tolist(), count.tolist()):
        values += c * (first & (g >= m)).sum(1)
    ops = np.zeros(n, np.int64)
    for p in cfg.policies:
        if p.name == "FGDScore":
            ops += 2 * t + (values + kw) * (2 * t + 6)
        elif p.name == "DotProductScore":
            slots = 1 if cfg.dim_ext == "merge" else 9
            ops += 32 + k * slots * (14 + (15 if cfg.norm == "pod" else 0))
        elif p.name == "PWRScore":
            ops += 153 + 55 * ks + 65 * kw
        elif not p.per_event:  # RandomScore's draws: the replay's bound
            node, per_type = {"BestFitScore": (8, 10),
                              "GpuPackingScore": (136, 70),
                              "GpuClusteringScore": (20, 8),
                              "Simon": (3, 14)}[p.name]
            ops += node + per_type * k
    return ops


def bound_ms(bytes_moved: int, ops: int):
    """(least milliseconds, what bounds it) from bytes and operations."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def refreshes_of(event_node) -> int:
    """The column refreshes a replay needs: one after each event that
    changed a node (a create that placed its pod, the delete of a placed
    pod), but the last."""
    return int((event_node[:-1] >= 0).sum())


def placed_refreshes(kinds: np.ndarray, pods: np.ndarray, placed) -> int:
    """refreshes_of for a stream of creates and skips alone, counted from
    its final placements (checked against the JAX digests) instead of the
    kernel's per-event telemetry: with no delete a pod keeps the node its
    create chose, so an event changed a node iff it created a pod that
    ended placed."""
    if (kinds == 1).any():
        raise SmokeFailure("placed_refreshes needs a stream without deletes")
    placed = placed.cpu().numpy()
    return int(((kinds == 0) & (placed[pods] >= 0))[:-1].sum())


def check_digests(where: str, result, placed_sha: str, mask_sha: str):
    """A timed replay's placements and device masks against the JAX
    package's digests of the same run."""
    got = (digest(result.placed_node.cpu().numpy(), np.int32),
           digest(result.dev_mask.cpu().numpy(), np.uint8))
    if got != (placed_sha, mask_sha):
        raise SmokeFailure(f"{where}: differs from the JAX reference: "
                           f"placed sha256 {got[0]} dev_mask sha256 {got[1]}")


def chain_ms(step_ms: float, kinds: np.ndarray, n: int, k: int,
             refreshes: int, n_pol: int = 1) -> float:
    """Least time of the replay's serial event chain. Every event waits on
    the one before it, so each costs at least one step of the block's event
    loop, `step_ms` (this run's all-skip replay per event: the event's read
    and the block barrier that stands for the block-wide agreement every
    event needs), plus its own bytes at the memory rate: on a create
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
                     refreshes: int, ops: float, extra_bytes: int = 0):
    """(ms, what bounds it) of a replay as if its events were independent:
    every input read once and every output written once (the node state
    and the tables both ways, the types, typical pods, pods, ranks and
    events in, the pod and event outputs out, and `extra_bytes`), and the
    operations of one column refresh (`ops`, node_ops' mean over the
    initial state: the refreshed nodes' states are not recorded) per event
    after the first create or delete."""
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
    block's 128 ranks, and reads and writes the block's K summaries (3
    values, plus 2 extrema per normalised policy); with nn normalised
    policies every event reads the
    type's 2 nn N/128 block extrema; each rebuild reads the type's n_pol + 1
    rows and the N ranks and writes its 3 N/128 summaries; an unpinned
    create reads its type's 2 N/128 summaries; the init reads every table
    entry and rank (twice with normalised policies) and writes every
    summary."""
    nblk = n // 128
    node_bytes = (1 + 1 + 1 + 1 + 8 + 9) * 4
    per_event = 2 * 4 + 7 * 4 + 5 * 4 + 2 * node_bytes + 2 * nn * nblk * 4
    refresh = (4 * (n_pol + 2) * k + node_bytes + 4 * 128
               + 2 * 4 * k * (3 + 2 * nn))
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


def typed_case(seed: int, num_nodes: int, ks: int, kw: int, t: int,
               num_pods: int, device, num_events: int):
    """A seeded random cluster whose pods fall in exactly ks share-GPU and
    kw other pod types (each type requested once in the first ks + kw
    pods, the rest drawn from them), with t typical pods and the first
    `num_events` create/delete events; the rest as random_case."""
    from tpusim_torch.sim.table_engine import build_pod_types
    from tpusim_torch.types import PodSpec, make_typical_pods
    import torch

    state, _, _, _, _, _, rank = random_case(seed, num_nodes, 1, device)
    rng = np.random.default_rng(seed + 1000)
    k = ks + kw
    j = np.arange(k)
    # distinct (cpu, mem) per type; share types first
    cpu = 500 + (j % 64) * 250
    mem = 1024 * (1 + j // 64)
    share = j < ks
    whole_num = rng.choice([0, 1, 2, 4, 8], k)
    milli = np.where(share, rng.choice([100, 250, 500, 750], k),
                     np.where(whole_num > 0, 1000, 0))
    num = np.where(share, 1, whole_num)
    mask = np.where((num > 0) & (rng.random(k) < 0.25),
                    1 << rng.integers(0, 4, k), 0)
    which = np.concatenate([j, rng.integers(0, k, max(num_pods - k, 0))])
    pinned = np.where(rng.random(which.size) < 0.02,
                      rng.integers(0, num_nodes, which.size), -1)

    def col(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    pods = PodSpec(col(cpu[which]), col(mem[which]), col(milli[which]),
                   col(num[which]), col(mask[which]), col(pinned))
    kinds, idx, alive = [], [], []
    for i in range(which.size):
        kinds.append(0)
        idx.append(i)
        alive.append(i)
        if rng.random() < 0.34 and len(alive) > 1:
            kinds.append(1)
            idx.append(alive.pop(int(rng.integers(0, len(alive)))))
    kinds, idx = kinds[:num_events], idx[:num_events]
    freq = rng.random(t).astype(np.float32) + 0.01
    tp = make_typical_pods(zip(
        rng.choice([1000, 4000, 8000, 16000], t),
        rng.choice([0, 100, 250, 500, 1000], t), rng.choice([1, 2], t),
        rng.choice([0, 1, 6], t), freq / freq.sum()), device)
    types = build_pod_types(pods)
    if (types.num_share, types.num_types) != (ks, k):
        raise SmokeFailure(f"typed_case made {types.num_share} share of "
                           f"{types.num_types} types, not {ks} of {k}")
    return state, pods, types, col(kinds), col(idx), tp, rank


# node counts of the init_tables cases: one node, either side of the
# kernel's 32-node tile, and several tiles
INIT_NODES = (1, 31, 33, 97, 640)
# the configurations they run under: FGD alone, PWR+FGD, GpuPacking, and a
# DotProduct pair
INIT_ROWS = ("06-FGD", "08-PWR_500_FGD_500", "04-GpuPacking",
             "DotProd-extend-pod")
# free milli a used device may hold: nine values, so a node can show eight
DEVICE_VALUES = (0, 100, 250, 400, 500, 600, 750, 900, 1000)


def init_config(row: str):
    """The ReplayConfig of an INIT_ROWS label."""
    from tpusim_torch.sim import fused_engine as fe

    if row == "DotProd-extend-pod":
        return fe.make_config([("DotProductScore", 1000)], "DotProductScore",
                              "extend", "pod")
    return fe.make_config(*[r for r in METHODS if r[0] == row][0][1:5])


def init_case_fields(seed: int, num_nodes: int):
    """Numpy fields (node state, pods, typical pods, under the JAX
    package's field names) of a seeded, partly used cluster for the
    init_tables checks: GPU nodes whose devices hold 1, 2, 3 or 8 distinct
    free values (8 on 8 devices), CPU-only nodes, CPU, memory and affinity
    counts in use; pods whose types include share requests that fit no
    device of most nodes (950, 990 milli), fractional requests on 2 or 4
    devices (Sub takes devices of different free values), whole GPUs and
    CPU only; typical pods, about a third of frequency 0."""
    rng = np.random.default_rng(seed)
    n = num_nodes
    distinct = rng.choice([0, 1, 2, 3, 8], n, p=[0.15, 0.25, 0.25, 0.2, 0.15])
    gpu_cnt = np.select([distinct == 0, distinct <= 2, distinct == 3],
                        [0, rng.choice([2, 4, 8], n), rng.choice([4, 8], n)],
                        8)
    gpu_left = np.zeros((n, 8), np.int32)
    for i in range(n):
        c, d = gpu_cnt[i], distinct[i]
        if c == 0:
            continue
        values = rng.choice(DEVICE_VALUES, d, replace=False)
        devs = np.concatenate([values, rng.choice(values, c - d)])
        gpu_left[i, :c] = rng.permutation(devs)
    cpu_cap = rng.choice([32000, 64000, 96000, 128000], n)
    mem_cap = rng.choice([131072, 262144, 393216], n)
    node = dict(
        cpu_left=cpu_cap - np.minimum(
            rng.choice([0, 1000, 7000, 33000], n), cpu_cap),
        cpu_cap=cpu_cap, mem_left=mem_cap - rng.choice([0, 4096, 65536], n),
        mem_cap=mem_cap, gpu_left=gpu_left, gpu_cnt=gpu_cnt,
        gpu_type=np.where(gpu_cnt > 0, rng.integers(0, 4, n), -1),
        cpu_type=rng.integers(0, 3, n),
        aff_cnt=rng.choice([0, 0, 1, 2], (n, 9)) * (gpu_cnt > 0)[:, None],
    )
    p = 160
    kind = rng.integers(0, 4, p)  # cpu-only, share, whole, fractional multi
    milli = np.select(
        [kind == 1, kind == 2, kind == 3],
        [rng.choice([100, 250, 500, 750, 950, 990], p), np.full(p, 1000),
         rng.choice([300, 500], p)], 0)
    num = np.select([kind == 1, kind == 2, kind == 3],
                    [np.ones(p, int), rng.choice([1, 2, 4, 8], p),
                     rng.choice([2, 4], p)], 0)
    pods = dict(
        cpu=rng.choice([1000, 2000, 4000, 8000, 16000, 40000], p),
        mem=rng.choice([1024, 4096, 16384], p), gpu_milli=milli,
        gpu_num=num,
        gpu_mask=np.where((kind > 0) & (rng.random(p) < 0.25),
                          (1 << rng.integers(0, 4, p))
                          | (1 << rng.integers(0, 4, p)), 0),
        pinned=np.full(p, -1),
    )
    t = 24
    freq = rng.random(t).astype(np.float32) * (rng.random(t) > 0.35)
    typical = dict(
        cpu=rng.choice([1000, 4000, 8000, 16000], t),
        gpu_milli=rng.choice([0, 100, 250, 500, 1000], t),
        gpu_num=rng.choice([1, 2], t), gpu_mask=rng.choice([0, 1, 6], t),
        freq=(freq / freq.sum()).astype(np.float32),
    )
    return node, pods, typical


def init_case(seed: int, num_nodes: int, device):
    """init_case_fields as the port's (state, pod types, typical pods)."""
    from tpusim_torch import types as tt
    from tpusim_torch.sim.table_engine import build_pod_types

    node, pods, typical = init_case_fields(seed, num_nodes)
    return (tt.node_state_from_numpy(node, device),
            build_pod_types(tt.pod_spec_from_numpy(pods, device)),
            tt.typical_pods_from_numpy(typical, device))


def check_init_cases(device) -> int:
    """init_tables against plain_init_tables, tolerance 0, on the
    init_case states of every INIT_NODES size under every INIT_ROWS
    configuration. Returns the largest error."""
    from tpusim_torch.sim import fused_engine as fe

    worst = 0
    for i, nodes in enumerate(INIT_NODES):
        state, types, tp = init_case(400 + i, nodes, device)
        for row in INIT_ROWS:
            cfg = init_config(row)
            err = max_abs_err(fe.init_tables(state, types, tp, cfg),
                              fe.plain_init_tables(state, types, tp, cfg))
            print(f"check init_tables used cluster {row} N={nodes} "
                  f"K={types.num_types} (ks={types.num_share}) T={tp.size}: "
                  f"max_abs_err={err} (tolerance 0)")
            if err:
                raise SmokeFailure(f"init_tables disagrees with "
                                   f"plain_init_tables on the used cluster "
                                   f"of {nodes} nodes under {row}")
            worst = max(worst, err)
    return worst


# (label, ks, kw, typical pods, nodes, pods, events) of the type-shape
# cases: share items past one round of the block's threads, no share type,
# only share types, one typical pod, and the most types and typical pods
# the replay kernels stage
SHAPE_CASES = (
    ("ks=200", 200, 40, 24, 300, 400, 540),
    ("ks=0", 0, 60, 24, 300, 300, 400),
    ("ks=K", 60, 0, 24, 300, 300, 400),
    ("T=1", 30, 30, 1, 300, 300, 400),
    ("K,T max", 1024, 1024, 1024, 130, 2100, 150),
)
SHAPE_ROWS = ("06-FGD", "08-PWR_500_FGD_500")


def final_errors(ready, got, keep, types, tp, cfg) -> int:
    """Largest difference between what a launched replay kernel left in
    its tables (and, for replay_blocked, its block summaries) and what its
    plain version left in `keep`, and between those tables and
    init_tables over the final node state outside the column of the last
    event's node (which is refreshed only at the next event)."""
    import torch

    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.residency import num_normalized

    t = ready.tensors
    tables = tuple(t[name] for name in ("score", "sdev", "feas"))
    err = max_abs_err(to_cpu(tables), to_cpu(keep["tables"]))
    result = got[0] if ready.name == "replay_blocked" else got
    if ready.name == "replay_blocked":
        names = ("bt", "br", "bn") + (("brmin", "brmax", "slo", "shi")
                                      if num_normalized(cfg.policies) else ())
        err = max(err, max_abs_err(
            to_cpu(tuple(t[name] for name in names)),
            to_cpu(tuple(getattr(keep["summaries"], name)
                         for name in names))))
    init = fe.prepare_init_tables(result.state, types, tp, cfg)
    fe.launch(init)  # a comparison: past the wrapper, not counted
    fresh = init.finish()
    last = int(result.event_node[-1])
    if last >= 0:
        fresh = tuple(x.clone() for x in fresh)
        tables = tuple(x.clone() for x in tables)
        for a, b in zip(fresh, tables):
            a[:, last] = b[:, last]
    torch.cuda.synchronize()
    return max(err, max_abs_err(to_cpu(tables), to_cpu(fresh)))


def against_plain(name: str, args, cfg, plain_on_cpu: bool = False,
                  key=CHECK_KEY) -> int:
    """Launch `replay` or `replay_blocked` on `args` = (state, pods, types,
    ev_kind, ev_pod, typical pods, rank, tables), past its wrapper (a
    comparison: not counted), and run its plain version on the same inputs
    (CPU copies with `plain_on_cpu`), `replay` from root `key`. Returns the
    largest error over the outputs, stats, final tables and summaries."""
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    prep, plain = ((fe.prepare_replay, fe.plain_replay) if name == "replay"
                   else (he.prepare_replay_blocked, he.plain_replay_blocked))
    kw = dict(key=key) if name == "replay" else {}
    ready = prep(*args, cfg, **kw)
    fe.launch(ready)
    got, keep = ready.finish(), {}
    want = plain(*(to_cpu(args) if plain_on_cpu else args), cfg, keep=keep,
                 **kw)
    return max(max_abs_err(to_cpu(got), to_cpu(want)),
               final_errors(ready, got, keep, args[2], args[5], cfg))


def shape_errors(label: str, row: str, device) -> dict:
    """Each kernel's largest error against its plain version on the
    SHAPE_CASES case `label` under the method row `row` (init_tables on
    the case's nodes and on them padded to 128)."""
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe

    i = [c[0] for c in SHAPE_CASES].index(label)
    _, ks, kw, t, nodes, num_pods, events = SHAPE_CASES[i]
    state, pods, types, evk, evp, tp, rank = typed_case(
        200 + i, nodes, ks, kw, t, num_pods, device, events)
    cfg = fe.make_config(*[r for r in METHODS if r[0] == row][0][1:5])
    errs = {"init_tables": 0}
    for name, (st, rk) in (("replay", (state, rank)),
                           ("replay_blocked", pad_nodes(state, rank, 128))):
        tables = fe.init_tables(st, types, tp, cfg)
        errs["init_tables"] = max(errs["init_tables"], max_abs_err(
            tables, fe.plain_init_tables(st, types, tp, cfg)))
        errs[name] = against_plain(
            name, (st, pods, types, evk, evp, tp, rk, tables), cfg)
    print(f"check shape {label} {row}: K={types.num_types} "
          f"(ks={types.num_share}) T={tp.size} nodes={nodes} "
          f"events={evk.shape[0]}: max_abs_err init_tables="
          f"{errs['init_tables']} (nodes {nodes} and padded) replay="
          f"{errs['replay']} replay_blocked={errs['replay_blocked']} with "
          f"final tables and summaries (tolerance 0)")
    return errs


# (label, ks, kw, typical pods) of the shapes one pod type and one typical
# pod past what the staged forms hold: the kernels' global forms
PAST_LIMIT = (("K=2049", 100, 1949, 1), ("T=1025", 1, 1, 1025))
# the configurations they run under: the specialised FGD shape (which runs
# the general kernel's global form), and the six-policy profile (the
# randomized replay's global form; its blocked run drops RandomScore)
PAST_LIMIT_ROWS = ("06-FGD", "default-profile")


def past_limit_errors(label: str, row: str, device) -> dict:
    """init_tables and both replay kernels against their plain versions
    (tables; outputs, stats, final tables and summaries; tolerance 0) on
    the PAST_LIMIT shape `label` under the method row `row`: the host
    launches the global forms there. Returns each kernel's largest error."""
    from tpusim_torch import kernels
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe

    i = [c[0] for c in PAST_LIMIT].index(label)
    _, ks, kw, t = PAST_LIMIT[i]
    state, pods, types, evk, evp, tp, rank = typed_case(
        300 + i, 130, ks, kw, t, max(ks + kw, 90), device, 60)
    if kernels.staged(types.num_types, tp.size):
        raise SmokeFailure(f"{label} is within the staged limits")
    cfg = fe.make_config(*[r for r in METHODS if r[0] == row][0][1:5])
    blocked_cfg = cfg if not cfg.randomized else fe.make_config(
        [(p.name, w) for p, w in zip(cfg.policies, cfg.weights)
         if not p.per_event], "best", cfg.dim_ext, cfg.norm)
    errs = {"init_tables": 0}
    for name, c, (st, rk) in (
            ("replay", cfg, (state, rank)),
            ("replay_blocked", blocked_cfg, pad_nodes(state, rank, 128))):
        tables = fe.init_tables(st, types, tp, c)
        errs["init_tables"] = max(errs["init_tables"], max_abs_err(
            tables, fe.plain_init_tables(st, types, tp, c)))
        errs[name] = against_plain(
            name, (st, pods, types, evk, evp, tp, rk, tables), c)
    print(f"check past the staged limits {label} {row}: K="
          f"{types.num_types} T={tp.size} nodes={state.num_nodes} "
          f"events={evk.shape[0]} (global forms): max_abs_err "
          f"init_tables={errs['init_tables']} replay={errs['replay']} "
          f"replay_blocked={errs['replay_blocked']} with final tables and "
          f"summaries (tolerance 0)")
    return errs


def check_shapes(device):
    """init_tables and both replay kernels against their plain versions
    (tables; outputs, stats, final tables and summaries; tolerance 0) on
    the SHAPE_CASES under the SHAPE_ROWS configurations, and past the
    staged limits (past_limit_errors). Returns the largest error of each
    kernel."""
    worst = dict(init_tables=0, replay=0, replay_blocked=0)
    for label, *_ in SHAPE_CASES:
        for row in SHAPE_ROWS:
            errs = shape_errors(label, row, device)
            for name, err in errs.items():
                worst[name] = max(worst[name], err)
            if any(errs.values()):
                raise SmokeFailure(f"a kernel disagrees with its plain "
                                   f"version on the shape case {label}, {row}")
    for label, *_ in PAST_LIMIT:
        for row in PAST_LIMIT_ROWS:
            errs = past_limit_errors(label, row, device)
            for name, err in errs.items():
                worst[name] = max(worst[name], err)
            if any(errs.values()):
                raise SmokeFailure(f"a kernel's global form disagrees with "
                                   f"its plain version at {label}, {row}")
    return worst


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
    out += [(label, fe.make_config(policies, gpu_sel), 230)
            for label, policies, gpu_sel in MIXES]
    return out


def check_random(device):
    """Both kernels against their plain versions on seeded random
    clusters of 256 nodes, for every checked configuration. Returns the
    largest error of each kernel."""
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
        err_r = against_plain("replay", (state, pods, types, evk, evp, tp,
                                         rank, plain_tables), cfg)
        print(f"check random {label} nodes=256 events={evk.shape[0]}: "
              f"init_tables max_abs_err={err_t} replay max_abs_err={err_r} "
              f"with final tables (tolerance 0)")
        if err_t or err_r:
            raise SmokeFailure(f"a kernel disagrees with its plain version "
                               f"on the random case of {label}")
        worst["init_tables"] = max(worst["init_tables"], err_t)
        worst["replay"] = max(worst["replay"], err_r)
    return worst


def blocked_configs():
    """(label, ReplayConfig) of every method row that is not randomized,
    FGD/worst and Simon+FGD."""
    from tpusim_torch.sim import fused_engine as fe

    return ([(row[0], fe.make_config(*row[1:5])) for row in METHODS
             if row[0] not in RANDOMIZED_ROWS]
            + [("FGD-worst", fe.make_config([("FGDScore", 1000)], "worst"))]
            + [(label, fe.make_config(policies, gpu_sel))
               for label, policies, gpu_sel in MIXES if label == "Simon+FGD"])


def check_random_blocked(device) -> int:
    """replay_blocked against plain_replay_blocked, which runs on CPU
    copies of the same inputs, on seeded random clusters: of 600 nodes
    (five 128-node blocks once padded) for every method row's configuration
    and FGD/worst, and for the normalised BestFit and PWR+FGD rows also of
    WIDE_BLOCKED nodes, where a warp rebuilds several blocks of a summary
    row and the select and drift loops stride over more blocks than the
    block has threads. Outputs, stats, final tables and summaries,
    tolerance 0. Returns the largest error."""
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe

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
        err = against_plain("replay_blocked", (state, pods, types, evk, evp,
                                               tp, rank, tables), cfg,
                            plain_on_cpu=True)
        print(f"check random blocked {label} nodes={nodes} "
              f"({state.num_nodes // 128} blocks) events={evk.shape[0]}: "
              f"replay_blocked max_abs_err={err} with stats, final tables "
              f"and summaries (tolerance 0)")
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
    for name, err in check_shapes(device).items():
        worst[name] = max(worst.get(name, 0), err)
    worst["init_tables"] = max(worst["init_tables"], check_init_cases(device))
    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    n, k, t = state.num_nodes, types.num_types, tp.size
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
        print(f"check openb init_tables {label} [{cfg.num_tables}x{k}, "
              f"{n}]: max_abs_err={err} (tolerance 0); {init_ms:.4f} ms "
              f"(plain {plain_ms:.1f} ms)")
        if err:
            raise SmokeFailure(f"init_tables disagrees with plain_init_tables"
                               f" on openb under {label}")
        worst["init_tables"] = max(worst["init_tables"], err)

    empty_ms = empty_launch_ms(20)
    print(f"time empty launch: {empty_ms:.4f} ms (an empty kernel through "
          f"the same library and ctypes call, median of 20), on {card}")

    def prepared(cfg, tables, kinds=evk):
        ready = fe.prepare_replay(state, specs, types, kinds, evp, tp, rank,
                                  tables, cfg, key=OPENB_KEY)
        return ready, reset_of(ready, state, tables)

    # the event chain without work: the same number of events, all skips,
    # through the FGD-specialised, the general and the randomized kernel
    # (which also advances the key chain every event)
    skip_ms = {}
    for label in ("06-FGD", "08-PWR_500_FGD_500", "01-Random"):
        cfg = dict(rows)[label]
        ready, _ = prepared(cfg, plain_init[label][2],
                            torch.full_like(evk, 2))
        skip_ms[label] = kernel_ms(ready, 3)
        print(f"time openb replay all-skip ({label} kernel): {e} events "
              f"{skip_ms[label]:.3f} ms, {skip_ms[label] / e * 1e3:.3f} us "
              f"each, on {card}")

    kinds, pods = evk.cpu().numpy(), evp.cpu().numpy()
    methods = {row[0]: row for row in METHODS}
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
        got = ready.finish()  # the last timed launch ran from the reset state
        plain_replay_ms = None
        if label in methods:
            check_digests(f"replay {label}", got, *methods[label][5:7])
            refreshes = placed_refreshes(kinds, pods, got.placed_node)
        prefix = {}
        if label in PLAIN_ROWS + PREFIX_ROWS:  # beside the plain version
            keep = {}
            ek, ep = ((evk, evp) if label in PLAIN_ROWS
                      else (evk[:PLAIN_PREFIX], evp[:PLAIN_PREFIX]))
            cmp_ready, cmp_got = ready, got
            if label in PREFIX_ROWS:
                cmp_ready = fe.prepare_replay(state, specs, types, ek, ep, tp,
                                              rank, tables, cfg, key=OPENB_KEY)
                prefix = dict(prefix_events=PLAIN_PREFIX, prefix_ms=kernel_ms(
                    cmp_ready, 3, reset_of(cmp_ready, state, tables)))
                cmp_got = cmp_ready.finish()
            ms_p, want = wall_ms(lambda: fe.plain_replay(
                state, specs, types, ek, ep, tp, rank, tables, cfg,
                keep=keep, key=OPENB_KEY))
            if label in PLAIN_ROWS:
                plain_replay_ms = ms_p
                if label not in methods:  # no JAX digest: the plain's count
                    refreshes = refreshes_of(want.event_node.cpu().numpy())
            else:
                prefix["plain_prefix_ms"] = ms_p
            err = max(max_abs_err(cmp_got, want),
                      final_errors(cmp_ready, cmp_got, keep, types, tp, cfg))
            print(f"check openb replay {label} E={ek.shape[0]} P={p}: "
                  f"max_abs_err={err} with final tables (tolerance 0); plain "
                  f"{ms_p:.1f} ms" + (f", the kernel on the same prefix "
                                      f"{prefix['prefix_ms']:.3f} ms"
                                      if prefix else ""))
            if err:
                bad = (cmp_got.event_node != want.event_node).nonzero()
                raise SmokeFailure(
                    f"replay disagrees with plain_replay under {label}; "
                    "first differing event "
                    f"{int(bad[0]) if bad.numel() else 'none'}")
            worst["replay"] = max(worst["replay"], err)
        # bounds from this run's inputs: every input read once, every output
        # written once; the replay refreshes one column after each event
        # that changed a node, and is a serial chain of events besides
        n_pol = cfg.num_tables  # the policies with score-table rows
        table_bytes = (n_pol + 2) * k * n * 4
        ops = node_ops(cfg, state, types, tp)
        init_bound = bound_ms(state_bytes + type_bytes + tp_bytes
                              + table_bytes, int(ops.sum()))
        throughput = throughput_bound(n, k, t, p, e, n_pol, refreshes,
                                      ops.mean())
        step = skip_ms["06-FGD" if label == "06-FGD"
                       else "01-Random" if cfg.randomized
                       else "08-PWR_500_FGD_500"] / e  # the kernel it runs
        chain = chain_ms(step, kinds, n, k, refreshes, n_pol)
        replay_bound = dict(bound_ms=chain, bound_by="operations",
                            bound_note="serial event chain: E x (one "
                            "all-skip step of the block + the event's bytes "
                            "at the memory rate)")
        if any(pol.per_event for pol in cfg.policies):
            # plus RandomScore's draws: one threefry2x32 per node and create
            # event at the card's int32 rate
            draws = int((kinds == 0).sum()) * n
            chain += draws * THREEFRY_OPS / PEAK_INT32_PER_S * 1e3
            replay_bound = dict(
                bound_ms=chain, bound_by="operations",
                bound_note="serial event chain (the randomized kernel's "
                "all-skip step + the event's bytes at the memory rate) + "
                f"{draws} threefry2x32 draws (N a create event) x "
                f"{THREEFRY_OPS} int32 operations at {PEAK_INT32_PER_S:.3g}"
                "/s")
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
                                bound_by=init_bound[1],
                                empty_launch_ms=empty_ms),
            "replay": dict(ms=replay_ms, plain_ms=plain_replay_ms,
                           **replay_bound, **prefix),
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
    e, p = evk.shape[0], specs.cpu.shape[0]
    kinds, pods = evk.cpu().numpy(), evp.cpu().numpy()
    pinned = specs.pinned.cpu().numpy()[pods]
    unpinned = int(((kinds == 0) & (pinned < 0)).sum())

    def prepared(cfg, tables, kinds=evk, pods_of=evp):
        ready = he.prepare_replay_blocked(state, specs, types, kinds, pods_of,
                                          tp, rank, tables, cfg)
        return ready, reset_of(ready, state, tables)

    measured = {}
    for row in METHODS:
        if row[0] in RANDOMIZED_ROWS:  # they run the flat replay only
            continue
        label, cfg = row[0], fe.make_config(*row[1:5])
        n_pol, nn = len(cfg.policies), num_normalized(cfg.policies)
        tables = fe.init_tables(state, types, tp, cfg)
        ready, _ = prepared(cfg, tables, torch.full_like(evk, 2))
        step = kernel_ms(ready, 3) / e
        ready, reset = prepared(cfg, tables)
        blocked_ms = kernel_ms(ready, 3, reset)
        got = ready.finish()  # the last timed launch ran from the reset state
        rebuilds = int(got[1][2])
        check_digests(f"replay_blocked {label}", got[0], *row[5:7])
        refreshes = placed_refreshes(kinds, pods, got[0].placed_node)
        plain_ms = None
        prefix = {}
        if label in PLAIN_ROWS + PREFIX_ROWS:  # beside the plain version
            keep = {}
            ek, ep = ((evk, evp) if label in PLAIN_ROWS
                      else (evk[:PLAIN_PREFIX], evp[:PLAIN_PREFIX]))
            cmp_ready, cmp_got = ready, got
            if label in PREFIX_ROWS:
                cmp_ready, cmp_reset = prepared(cfg, tables, ek, ep)
                prefix = dict(prefix_events=PLAIN_PREFIX,
                              prefix_ms=kernel_ms(cmp_ready, 3, cmp_reset))
                cmp_got = cmp_ready.finish()
            ms_p, want = wall_ms(lambda: he.plain_replay_blocked(
                *to_cpu((state, specs, types, ek, ep, tp, rank, tables)),
                cfg, keep=keep))
            if label in PLAIN_ROWS:
                plain_ms = ms_p
            else:
                prefix["plain_prefix_ms"] = ms_p
            err = max(max_abs_err(to_cpu(cmp_got), want),
                      final_errors(cmp_ready, cmp_got, keep, types, tp, cfg))
            print(f"check openb replay_blocked {label} E={ek.shape[0]} P={p} "
                  f"N={n}: max_abs_err={err} with final tables and summaries "
                  f"(tolerance 0, stats {cmp_got[1].tolist()}); plain "
                  f"{ms_p:.1f} ms on the CPU" + (
                      f", the kernel on the same prefix "
                      f"{prefix['prefix_ms']:.3f} ms" if prefix else ""))
            if err:
                raise SmokeFailure(f"replay_blocked disagrees with "
                                   f"plain_replay_blocked on openb, {label}")
            worst = max(worst, err)
        chain = chain_blocked_ms(step, kinds, unpinned, n, k, refreshes,
                                 n_pol, nn, rebuilds)
        throughput = throughput_bound(
            n, k, t, p, e, n_pol, refreshes,
            node_ops(cfg, state, types, tp).mean(),
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
                               rebuilds=rebuilds, **bound, **prefix)
        if plain_ms is not None or prefix:
            measured[label]["plain_note"] = ("plain_replay_blocked on CPU "
                                             "copies of the inputs")
    return measured, worst


CLOCK_ROWS = ("06-FGD", "05-BestFit", "08-PWR_500_FGD_500", "01-Random")
# the clocked library variants
CLOCK_VARIANTS = ("clocked",)


def clocked_run(ready, variant: str, device):
    """Launch a prepared replay through a clocked library variant, one
    launch timed alone with CUDA events (the kernel's module loaded by an
    earlier launch). Returns (ms, clocks as a dict of ints). Not counted."""
    import torch

    from tpusim_torch import kernels

    clocks = torch.zeros(kernels.NUM_CLOCKS, dtype=torch.int64,
                         device=device)
    ready.args.clocks = clocks.data_ptr()
    ready.tensors["clocks"] = clocks
    stream = torch.cuda.current_stream(device).cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    kernels.launch(ready.name, ready.args, stream, variant)
    end.record()
    torch.cuda.synchronize()
    vals = clocks.tolist()
    return start.elapsed_time(end), dict(zip(kernels.CLOCK_SLOTS, vals))


def clock_line(where: str, name: str, label: str, variant: str, e: int,
               ms: float, clk: dict) -> dict:
    """Print one run's phase split as us an event (cycles converted at the
    run's own rate: the loop's and the init's cycles over its ms) and
    return it."""
    rate = (clk["loop"] + clk["init"]) / (ms * 1e3)  # cycles a microsecond
    split = {ph: clk[ph] / rate / e for ph in
             ("refresh", "work", "setup", "sum", "block", "drift", "extrema",
              "select", "commit", "wait")}
    out = dict(where=where, kernel=name, row=label, variant=variant, events=e,
               ms=ms, mhz=rate, us_per_event=split,
               init_us=clk["init"] / rate, refreshes=clk["refreshes"],
               items=clk["items"] / max(clk["refreshes"], 1),
               rescans=clk["rescans"])
    print(f"clocks {where} {name} {label} [{variant}]: {ms:.3f} ms, "
          f"{ms / e * 1e3:.3f} us an event at {rate:.0f} MHz; us an event: "
          + ", ".join(f"{ph} {v:.3f}" for ph, v in split.items())
          + f" (wait is inside the others); init {out['init_us']:.1f} us; "
          f"{clk['refreshes']} refreshes ({out['items']:.0f} lanes each), "
          f"{clk['rescans']} rescans")
    return out


def phase_clocks(device, card: str, inputs, where: str, rows, kernels_run,
                 variants=CLOCK_VARIANTS):
    """The phase split of both replay kernels through the clocked
    variants, on `inputs` = (state, specs, types, evk, evp, tp, rank), for
    each row label of `rows`. Each clocked run's outputs must equal the
    main build's on the same inputs. Returns the split of every run."""
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    state, specs, types, evk, evp, tp, rank = inputs
    padded, rank_p = pad_nodes(state, rank, 128)
    methods = {row[0]: row for row in METHODS}
    e = evk.shape[0]
    out = []
    for label in rows:
        cfg = fe.make_config(*methods[label][1:5])
        for name, st, rk, prep in (
                ("replay", state, rank, fe.prepare_replay),
                ("replay_blocked", padded, rank_p, he.prepare_replay_blocked)):
            if name not in kernels_run or (name == "replay_blocked"
                                           and cfg.randomized):
                continue
            init = fe.prepare_init_tables(st, types, tp, cfg)
            fe.launch(init)
            tables = init.finish()
            args = (st, specs, types, evk, evp, tp, rk, tables, cfg)
            if name == "replay":
                prep = functools.partial(prep, key=OPENB_KEY)
            base = prep(*args)
            fe.launch(base)  # the main build, past the wrapper: not counted
            want = to_cpu(base.finish())
            for variant in variants:
                clocked_run(prep(*args), variant, device)  # loads the module
                ready = prep(*args)
                ms, clk = clocked_run(ready, variant, device)
                err = max_abs_err(to_cpu(ready.finish()), want)
                if err:
                    raise SmokeFailure(f"the {variant} build of {name} "
                                       f"differs from the main build on "
                                       f"{label} ({where})")
                out.append(clock_line(where, name, label, variant, e, ms,
                                      clk))
    return out


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


def check_report(label: str, sim, mid: str, meta: dict) -> float:
    """Write the run's simon.log (after finish()) and analysis CSVs into a
    temporary directory and hold their digest to REPORT_SHA256[mid].
    Returns the CSV write's host milliseconds."""
    import tempfile

    from tpusim_torch.analysis import analyze_sim

    sim.finish()
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "simon.log"), "w") as f:
            f.write(sim.log.dump())
        t0 = time.perf_counter()
        analyze_sim(sim, d, meta)
        csv_ms = (time.perf_counter() - t0) * 1e3
        if report_digest(d) != REPORT_SHA256[mid]:
            raise SmokeFailure(f"{label}: simon.log or an analysis CSV differs "
                               f"from the JAX reference: {report_digests(d)}")
    return csv_ms


def report_times(sim, trace, specs, evk, evp, out, repeats: int,
                 check_cpu: bool) -> dict:
    """Milliseconds of the report half on a warm replay's output `out`:
    the metrics post-pass on the card (CUDA events around each run, median
    of `repeats`), the one fetch to the host, the Bellman series with a
    fresh memo as in a run, and the formatting of the report block (host
    clock each). With `check_cpu`, the card's post-pass must equal the
    plain one on CPU copies of the inputs, field by field, bit for bit."""
    import torch

    from tpusim_torch.sim.fetch import device_fetch
    from tpusim_torch.sim.metrics import compute_event_metrics

    pairs, full = [], None
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        full = sim._attach_metrics(out, sim.init_state, specs, evk, evp)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = dict(postpass=float(np.median(
        [a.elapsed_time(b) for a, b in pairs])))
    if check_cpu:
        want = compute_event_metrics(
            to_cpu(sim.init_state), to_cpu(specs), evk, evp,
            out.event_node.cpu(), out.event_dev.cpu(), to_cpu(sim.typical))
        for name, a, b in zip(want._fields, full.metrics, want):
            if not torch.equal(a.cpu(), b):
                raise SmokeFailure(f"the post-pass's {name} on the card "
                                   f"differs from the plain one on the CPU")
    times["fetch"], host = wall_ms(lambda: device_fetch(full))
    sim._bellman_eval = None
    t0 = time.perf_counter()
    bellman = sim._bellman_series(sim.init_state, trace, evk, evp, host)
    times["bellman"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sim._format_event_reports(host, trace, evk, evp, bellman)
    times["format"] = (time.perf_counter() - t0) * 1e3
    return times


def main_path(device, card: str):
    """Phase 5: every method row through Simulator.run() on the card, with
    table_residency "auto" and then "hbm", per-event reports on, the launch
    counts set to 0 before each run and read after it; the log and CSVs
    held to the JAX digests; under "auto" the report half timed beside the
    replay wall. Returns {run label: counts}."""
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
            if mid in RANDOMIZED_ROWS:  # the flat replay, whatever the knob
                tier = "vmem"
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
            csv_ms = check_report(label, sim, mid,
                                  row_meta(policies, gpu_sel, dim_ext))

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
                ms, out = wall_ms(lambda: sim.run_events(
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
            if setting == "auto":
                t = report_times(sim, trace, specs, evk, evp, out,
                                 WARM_RUNS if label == "06-FGD" else 3,
                                 label == "06-FGD")
                print(f"report {label}: log and CSV digests match the JAX "
                      f"reference; replay wall {warm * 1e3:.2f} ms, post-pass "
                      f"{t['postpass']:.3f} ms (card, median of "
                      f"{WARM_RUNS if label == '06-FGD' else 3}), fetch "
                      f"{t['fetch']:.3f} ms, Bellman {t['bellman']:.1f} ms, "
                      f"formatting {t['format']:.1f} ms, CSV write "
                      f"{csv_ms:.1f} ms (host clock) on {card}")
    return launches


def scale_path(device, card: str, nodes, pods, auto):
    """Phase 7: tpusim_torch.bench_scale's path at 100k nodes, residency
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

    sim, types = auto.sim, auto.types
    k, n = types.num_types, SCALE_NODES

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
    refreshes = placed_refreshes(kinds, auto.ev_pod[:SCALE_CHUNK],
                                 results[0].placed_node)
    pinned = auto.specs.pinned.cpu().numpy()[auto.ev_pod[:SCALE_CHUNK]]
    unpinned = int(((kinds == 0) & (pinned < 0)).sum())
    skips = torch.full_like(evk, 2)
    tp, p, e = sim.typical, SCALE_PODS, SCALE_CHUNK
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
        ops = node_ops(cfg, st, types, tp)
        init_bound = bound_ms(
            width * (1 + 1 + 1 + 1 + 8 + 9 + 1 + 1) * 4 + 5 * k * 4
            + 5 * tp.size * 4 + 3 * k * width * 4, int(ops.sum()))
        if name == "replay":
            chain = chain_ms(step, kinds, width, k, refreshes)
            extra = 0
        else:
            chain = chain_blocked_ms(step, kinds, unpinned, width, k,
                                     refreshes, 1, 0, 0)
            extra = 4 * k * (width // 128) * 3
        throughput = throughput_bound(width, k, tp.size, p, e, 1,
                                      refreshes, ops.mean(), extra)
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
            got, keep = ready.finish(), {}
            t0 = time.perf_counter()
            want = plain(*to_cpu(args), cfg, keep=keep)
            plain_s = time.perf_counter() - t0
            err = max(max_abs_err(to_cpu(got), want),
                      final_errors(ready, got, keep, types, tp, cfg))
            stats = (f", stats {got[1].tolist()} against "
                     f"{want[1].tolist()}" if name != "replay" else "")
            print(f"check scale {name} {label} N={st.num_nodes} events "
                  f"{lo}..{hi} from the state after the first chunk: "
                  f"max_abs_err={err} with final tables (tolerance 0{stats});"
                  f" plain "
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



# The apply phase's bundle: the openb gpu_node list and default trace as
# YAML (tpusim_torch.io.data_prep.prepare_input), under the paper's FGD
# scheduler config, tuned to 1.3 with seed 42, shuffled, workload
# inflation 1.1, the snapshot exports, and two apps scheduled on the placed
# cluster: APPLY_APP_YAML (a Deployment, a DaemonSet over every node, a pod
# pinned by nodeSelector to the first node, a pod with tolerations) and the
# Helm chart APPLY_CHART.
APPLY_APP_YAML = """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: web
  namespace: apps
spec:
  replicas: 6
  template:
    metadata:
      annotations:
        alibabacloud.com/gpu-milli: "250"
        alibabacloud.com/gpu-count: "1"
    spec:
      containers:
      - name: main
        resources:
          requests:
            cpu: "2"
            memory: 4Gi
---
apiVersion: apps/v1
kind: DaemonSet
metadata:
  name: node-agent
  namespace: kube-system
spec:
  template:
    spec:
      containers:
      - name: agent
        resources:
          requests:
            cpu: 100m
            memory: 128Mi
---
apiVersion: v1
kind: Pod
metadata:
  name: pinned-trainer
  namespace: apps
  annotations:
    alibabacloud.com/gpu-milli: "1000"
    alibabacloud.com/gpu-count: "2"
spec:
  nodeSelector:
    kubernetes.io/hostname: PINNED_NODE
  containers:
  - name: main
    resources:
      requests:
        cpu: "8"
        memory: 32Gi
---
apiVersion: v1
kind: Pod
metadata:
  name: tolerant-batch
  namespace: apps
spec:
  tolerations:
  - key: dedicated
    operator: Exists
  containers:
  - name: main
    resources:
      requests:
        cpu: "4"
        memory: 8Gi
"""
APPLY_CHART = {
    "Chart.yaml": "apiVersion: v2\nname: infer\nversion: 0.1.0\n"
                  "appVersion: '1.0'\n",
    "values.yaml": "replicaCount: 3\ngpu:\n  milli: 500\n  count: 1\n"
                   "resources:\n  requests:\n    cpu: 4\n    memory: 16Gi\n",
    "templates/_helpers.tpl":
        '{{- define "infer.fullname" -}}\n'
        '{{- printf "%s-%s" .Release.Name .Chart.Name | trunc 63 '
        '| trimSuffix "-" -}}\n{{- end -}}\n',
    "templates/deployment.yaml": """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: {{ include "infer.fullname" . }}
spec:
  replicas: {{ .Values.replicaCount }}
  template:
    metadata:
      annotations:
        alibabacloud.com/gpu-milli: {{ .Values.gpu.milli | quote }}
        alibabacloud.com/gpu-count: {{ .Values.gpu.count | quote }}
    spec:
      containers:
        - name: {{ .Chart.Name }}
          resources:
            {{- toYaml .Values.resources | nindent 12 }}
""",
    "templates/NOTES.txt": 'Deployed {{ include "infer.fullname" . }}\n',
}
# The apply phase's outputs from the JAX package (`python -m tpusim apply -f
# <CR> -s example/test-scheduler-config.yaml -e gpu --report` on the CPU,
# the CR of write_apply_bundle(..., apps=True, inflation=1.1)): sha256 of
# the standard output without its [Engine] lines and of each exported
# file. tests/test_torch_apply.py pins them against tpusim (slow-marked).
APPLY_SHA256 = {
    "stdout":
        "c6a3dcc35183b66b938ace28eee4a1081119f90e1534faf70b8e97a28547761a",
    "pod_init_schedule.yaml":
        "6810e19aa47827cac6f622bedc04b49a5c72e7ec089d0f35e03f91b3a8f53088",
    "node_init_schedule.csv":
        "86cd8a9712920d95092aacf701017a641e853e104eebf20b0f8e1386129f060b",
    "node_init_schedule_pod.csv":
        "54725fb7b52c1dc589c9456efc722ba67d57406d345e975cde07dbd61e615a73",
}
APPLY_SCHEDULER = os.path.join("example", "test-scheduler-config.yaml")


def write_apply_bundle(root: str, cluster: str, pinned: str,
                       tune: float = 1.3, inflation: float = 1.1,
                       apps: bool = True, extra=None) -> str:
    """Write the apply phase's apps and Simon CR under `root` for the
    cluster-config directory `cluster` (the YAML app's pod pinned to node
    `pinned`), with the snapshot exports under root/out. `extra` updates
    the CR's customConfig. Returns the CR's path."""
    import yaml

    app_dir = os.path.join(root, "apps", "yaml-app")
    chart_dir = os.path.join(root, "apps", "infer")
    os.makedirs(app_dir, exist_ok=True)
    with open(os.path.join(app_dir, "app.yaml"), "w") as f:
        f.write(APPLY_APP_YAML.replace("PINNED_NODE", pinned))
    for name, text in APPLY_CHART.items():
        path = os.path.join(chart_dir, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    out = os.path.join(root, "out")
    custom = {
        "shufflePod": True,
        "workloadTuningConfig": {"ratio": tune, "seed": 42},
        "typicalPodsConfig": {"isInvolvedCpuPods": True,
                              "podPopularityThreshold": 95,
                              "podIncreaseStep": 1, "gpuResWeight": 0},
        "exportConfig": {
            "podSnapshotYamlFilePrefix": os.path.join(out, "pod"),
            "nodeSnapshotCSVFilePrefix": os.path.join(out, "node")},
    }
    if inflation > 1:
        custom["workloadInflationConfig"] = {"ratio": inflation, "seed": 233}
    custom.update(extra or {})
    spec = {"cluster": {"customConfig": cluster}, "customConfig": custom}
    if apps:
        spec["appList"] = [{"name": "yaml-app", "path": app_dir},
                           {"name": "infer", "path": chart_dir,
                            "chart": True}]
    cr = {"apiVersion": "simon/v1alpha1", "kind": "Config",
          "metadata": {"name": "openb-fgd"}, "spec": spec}
    path = os.path.join(root, "cluster-config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cr, f, sort_keys=False)
    return path


def apply_digests(stdout: str, out_dir: str) -> dict:
    """APPLY_SHA256's digests of one apply run: its standard output without
    the [Engine] lines, and each exported file ("absent" if missing)."""
    kept = "".join(line for line in stdout.splitlines(keepends=True)
                   if "[Engine]" not in line)
    out = {"stdout": hashlib.sha256(kept.encode()).hexdigest()}
    for name in list(APPLY_SHA256)[1:]:
        path = os.path.join(out_dir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
        else:
            out[name] = "absent"
    return out


def openb_yaml(root: str) -> str:
    """The openb gpu_node list and default trace as a cluster-config
    directory, written by the port's prepare_input. Returns its path."""
    import contextlib
    import io

    from tpusim_torch.io.data_prep import prepare_input

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    csv_dir = os.path.join(root, "csv")
    os.makedirs(csv_dir, exist_ok=True)
    for name in ("openb_node_list_gpu_node.csv", "openb_pod_list_default.csv"):
        os.symlink(os.path.join(data, name), os.path.join(csv_dir, name))
    with contextlib.redirect_stdout(io.StringIO()):
        (made,) = prepare_input(csv_dir, os.path.join(root, "input"))
    return str(made)


def check_app_replay(applier, device, card: str) -> dict:
    """The first app's replay, from the placed cluster's state after the
    main replay: `replay` and `replay_blocked` each against its plain
    version on CPU copies of the inputs, tolerance 0 (outputs, stats, the
    final tables and block summaries). The launches are comparisons, past
    the wrappers: not counted. Returns each kernel's largest error."""
    import torch

    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.queues import app_queue
    from tpusim_torch.sim.table_engine import build_pod_types

    sim = applier.sim
    name, pods = applier._load_apps(sim.node_names)[0]
    pods = app_queue(pods, sim.nodes, applier.options.use_greed)
    trace = sim.prepare_pods()  # the main replay again: its final state
    state = sim.run_events(sim.init_state,
                           pods_to_specs(trace, sim.node_index, device),
                           *build_events(trace)).state
    specs = pods_to_specs(pods, sim.node_index, device)
    types = build_pod_types(specs)
    evk, evp = (torch.as_tensor(a, device=device)
                for a in build_events(pods))
    cfg = fe.make_config(sim.cfg.policies, sim.cfg.gpu_sel_method,
                         sim.cfg.dim_ext_method, sim.cfg.norm_method)
    errors = {}
    for kernel in ("replay", "replay_blocked"):
        st, rank = state, sim.rank
        if kernel == "replay_blocked":
            st, rank = pad_nodes(state, rank, 128)
        ready = fe.prepare_init_tables(st, types, sim.typical, cfg)
        fe.launch(ready)
        tables = ready.finish()
        errors[kernel] = against_plain(
            kernel, (st, specs, types, evk, evp, sim.typical, rank, tables),
            cfg, plain_on_cpu=True)
        print(f"check apply {name} {kernel}: E={len(pods)} from the placed "
              f"state of {st.num_nodes} nodes, max_abs_err="
              f"{errors[kernel]} against the plain version on CPU copies "
              f"(tolerance 0)")
    if any(errors.values()):
        raise SmokeFailure(f"the first app's replay disagrees with its plain "
                           f"version: {errors}")
    return errors


def apply_path(device, card: str):
    """Phase 6: `python -m tpusim_torch.cli apply`'s path (Applier.run) on
    the openb bundle of write_apply_bundle, per-event reports and the
    report tables on, once with table_residency "auto" and once with "hbm":
    the launch counts set to 0 before each run and read after it (each of
    the residency's kernels launched once a replay stage: the main replay,
    the inflation, each app; the other replay kernel never), the standard
    output and the exported files held to APPLY_SHA256, the stages timed.
    Then the first app's replay against the plain versions. Returns
    ({run label: counts}, the errors)."""
    import contextlib
    import io
    import tempfile

    import torch

    from tpusim_torch.apply import Applier, ApplyOptions
    from tpusim_torch.sim import fused_engine as fe

    launches, errors = {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cluster = openb_yaml(root)
        prep_s = time.perf_counter() - t0
        from tpusim_torch.io.k8s_yaml import load_cluster_from_dir

        pinned = min(n.name for n in load_cluster_from_dir(cluster).nodes)
        for setting, tier in (("auto", "vmem"), ("hbm", "hbm")):
            label = "apply" if setting == "auto" else "apply/hbm"
            run_dir = os.path.join(root, setting)
            cr = write_apply_bundle(run_dir, cluster, pinned)
            applier = Applier(ApplyOptions(
                simon_config=cr, default_scheduler_config=os.path.join(
                    os.path.dirname(os.path.abspath(__file__)),
                    APPLY_SCHEDULER),
                extended_resources=["gpu"], report_tables=True,
                device=device.type, table_residency=setting))
            buf = io.StringIO()
            fe.reset_launch_counts()
            with contextlib.redirect_stdout(buf):
                applier.run(out=buf)
            torch.cuda.synchronize()
            counts = run_counts()
            sim = applier.sim
            stages = len(sim.replay_times)
            want = {name: (stages if name in RESIDENCY_KERNELS[tier] else 0)
                    for name in counts}
            if counts != want or sim.last_residency != tier:
                raise SmokeFailure(f"{label}: launches {counts} over {stages} "
                                   f"replay stages (want {want}), residency "
                                   f"{sim.last_residency} (want {tier})")
            launches[label] = counts
            got = apply_digests(buf.getvalue(), os.path.join(run_dir, "out"))
            if got != APPLY_SHA256:
                raise SmokeFailure(f"{label}: the standard output or an "
                                   f"exported file differs from the JAX "
                                   f"reference: {got}")
            t = applier.timings
            walls = ", ".join(
                f"{r['events']} events {r['replay_ms']:.2f} + "
                f"{r['report_ms']:.1f} ms" for r in sim.replay_times)
            stages_ms = ", ".join(f"{k[:-3]} {v:.1f}" for k, v in t.items())
            print(f"apply {label}: {sim.last_engine} ({tier}), launches "
                  f"{counts} over {stages} replay stages (main, inflation, "
                  f"each app), stdout ({buf.getvalue().count(chr(10))} lines)"
                  f" and the 3 exported files match the JAX reference; "
                  f"prepare_input {prep_s:.1f} s (once); stages (ms) "
                  f"{stages_ms}; each replay (replay + report tail, ms; "
                  f"main, inflation, apps) {walls} (host clock) on {card}")
            if setting == "auto":
                errors = check_app_replay(applier, device, card)
    launches["apply/default-profile"] = apply_default_profile(device, card)
    return launches, errors


# sha256 of the standard output, without its [Engine] lines, of `python -m
# tpusim apply -f example/test-cluster-config.yaml` (no scheduler config:
# the built-in six-policy profile) on the CPU. tests/test_torch_apply.py
# pins it against tpusim.
APPLY_DEFAULT_SHA256 = (
    "d914aa3e3cbea002bc64f8df57367a6cb43e708e3c945a247e70fb122acb2f3f"
)
APPLY_DEFAULT_CR = os.path.join("example", "test-cluster-config.yaml")


def apply_default_profile(device, card: str) -> dict:
    """`python -m tpusim_torch.cli apply -f example/test-cluster-config.yaml`
    with no scheduler config (the built-in profile: Simon, BestFit, Random,
    DotProduct, FGD and PWR at weight 1), through the CLI's own option
    parsing, the launch counts set to 0 before and read after: the flat
    kernels launched once (the profile draws per event), the standard
    output held to APPLY_DEFAULT_SHA256. Returns the counts."""
    import contextlib
    import io

    import torch

    from tpusim_torch.apply import Applier
    from tpusim_torch.cli import apply_options, build_parser
    from tpusim_torch.sim import fused_engine as fe

    root = os.path.dirname(os.path.abspath(__file__))
    args = build_parser().parse_args(
        ["apply", "-f", os.path.join(root, APPLY_DEFAULT_CR),
         "--base-dir", root])
    applier = Applier(apply_options(args))
    buf = io.StringIO()
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        applier.run(out=buf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    stages = len(applier.sim.replay_times)
    want = {name: (stages if name in RESIDENCY_KERNELS["vmem"] else 0)
            for name in counts}
    got = apply_digests(buf.getvalue(), root)["stdout"]
    if counts != want or got != APPLY_DEFAULT_SHA256:
        raise SmokeFailure(f"apply with the built-in profile: launches "
                           f"{counts} (want {want}), stdout sha256 {got}")
    print(f"apply default-profile: {applier.sim.last_engine}, launches "
          f"{counts} over {stages} replay stages, stdout "
          f"({buf.getvalue().count(chr(10))} lines) matches the JAX "
          f"reference; {wall * 1e3:.1f} ms (host clock) on {card}")
    return counts


PHASES = ("check", "clocks", "main", "apply", "scale")


def scale_inputs(device):
    """The scale run's set-up (tpusim_torch.bench_scale at SCALE_NODES
    nodes, residency auto)."""
    from tpusim_torch import bench_scale as bs

    t0 = time.perf_counter()
    nodes = bs.synth_cluster(SCALE_NODES, SCALE_SEED)
    pods = bs.synth_pods(SCALE_PODS, SCALE_SEED + 1)
    auto = bs.ScaleRun(nodes, pods, bs.scale_config(SCALE_SEED, "auto"),
                       device)
    print(f"scale setup: {SCALE_NODES} nodes, {SCALE_PODS} pods, "
          f"K={auto.types.num_types}, T={auto.sim.typical.size}, "
          f"{time.perf_counter() - t0:.1f} s on the host")
    return nodes, pods, auto


def scale_clocks(auto, device, card: str):
    """The phase split of both replay kernels on the first SCALE_PREFIX
    events of the scale stream, from the cluster's initial state."""
    import torch

    evk = torch.as_tensor(auto.ev_kind[:SCALE_PREFIX], device=device)
    evp = torch.as_tensor(auto.ev_pod[:SCALE_PREFIX], device=device)
    return phase_clocks(device, card, (
        auto.sim.init_state, auto.specs, auto.types, evk, evp,
        auto.sim.typical, auto.sim.rank), f"scale-{SCALE_NODES}",
        ("06-FGD",), ("replay", "replay_blocked"))


AB_OUT = os.path.join("chiprun_out", "kernel_ab.json")


def replay_digest(result) -> str:
    """sha256 of a replay's placements, device masks and per-event nodes."""
    h = hashlib.sha256()
    for x in (result.placed_node, result.dev_mask, result.event_node):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def tables_digest(tables) -> str:
    """sha256 of the (score, sdev, feas) tables."""
    h = hashlib.sha256()
    for x in tables:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ab_timed(ready, state, tables, repeats, warmup=True):
    """Median ms of `repeats` launches of a prepared replay, each from the
    initial state and tables; returns (ms, digest of the last launch)."""
    ms = kernel_ms(ready, repeats, reset_of(ready, state, tables),
                   warmup=warmup)
    result = ready.finish()
    if isinstance(result, tuple) and not hasattr(result, "_fields"):
        result = result[0]  # replay_blocked's (result, stats)
    return ms, replay_digest(result)


def replay_wall(row, nodes, pods, device) -> float:
    """Host milliseconds of the warm Simulator.run_events of a METHODS row
    over the prepared openb trace, residency "auto": the main phase's
    replay wall, min of 5 after one untimed run."""
    from tpusim_torch.__main__ import method_config
    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.sim.driver import Simulator

    sim = Simulator(nodes, method_config(*row[1:5]), device=device)
    sim.set_workload_pods(pods)
    sim.set_typical_pods()
    trace = sim.prepare_pods()
    specs = pods_to_specs(trace, sim.node_index, device)
    evk, evp = build_events(trace)
    sim.run_events(sim.init_state, specs, evk, evp)
    return min(wall_ms(lambda: sim.run_events(sim.init_state, specs, evk,
                                              evp))[0] for _ in range(5))


def ab_turn(tree: str) -> dict:
    """One turn of --ab: every measurement of the checkout at `tree`, whose
    tpusim_torch this process imports (its sys.path leads with `tree`)."""
    import torch

    from tpusim_torch import bench_scale as bs
    from tpusim_torch import kernels
    from tpusim_torch.io.trace import load_node_csv, load_pod_csv
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    if not os.path.abspath(kernels.__file__).startswith(
            os.path.abspath(tree) + os.sep):
        raise SmokeFailure(f"--ab: imported {kernels.__file__}, not {tree}'s")
    device = torch.device("cuda")
    log = kernels.build().log
    ptxas = [line.strip() for line in log.splitlines()
             if "entry function" in line or "registers" in line
             or "stack frame" in line]
    out = dict(tree=tree, card=card_line(), ptxas=ptxas, rows={}, scale={})
    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    padded, rank_p = pad_nodes(state, rank, 128)
    data = os.path.join(tree, "data", "csv")
    nodes = load_node_csv(os.path.join(data, "openb_node_list_gpu_node.csv"))
    pods = load_pod_csv(os.path.join(data, "openb_pod_list_default.csv"))
    for row in METHODS:
        label = row[0]
        try:
            cfg = fe.make_config(*row[1:5])
        except NotImplementedError:  # a checkout from before the row
            print(f"[{tree}] openb {label}: not run by this checkout",
                  flush=True)
            continue
        rec, kw = {}, {}
        kernels_run = [("replay", state, rank, fe.prepare_replay),
                       ("replay_blocked", padded, rank_p,
                        he.prepare_replay_blocked)]
        if label in RANDOMIZED_ROWS:  # the flat replay, from the root key
            kernels_run, kw = kernels_run[:1], dict(key=OPENB_KEY)
            rec["replay_blocked"] = float("nan")
        for name, st, rk, prep in kernels_run:
            init = fe.prepare_init_tables(st, types, tp, cfg)
            if name == "replay":
                rec["init_tables"] = kernel_ms(init, 20)
            else:
                fe.launch(init)
            tables = init.finish()
            rec["init_tables_digest" if name == "replay"
                else "init_tables_hbm_digest"] = tables_digest(tables)
            rec[name], rec[f"{name}_digest"] = ab_timed(
                prep(st, specs, types, evk, evp, tp, rk, tables, cfg, **kw),
                st, tables, 3)
        rec["wall"] = replay_wall(row, nodes, pods, device)
        out["rows"][label] = rec
        print(f"[{tree}] openb {label}: init_tables "
              f"{rec['init_tables']:.4f} ms, replay {rec['replay']:.3f} ms, "
              f"replay_blocked {rec['replay_blocked']:.3f} ms, replay wall "
              f"{rec['wall']:.3f} ms", flush=True)

    auto = bs.ScaleRun(bs.synth_cluster(SCALE_NODES, SCALE_SEED),
                       bs.synth_pods(SCALE_PODS, SCALE_SEED + 1),
                       bs.scale_config(SCALE_SEED, "auto"), device)
    cfg = fe.make_config(list(auto.sim.cfg.policies),
                         auto.sim.cfg.gpu_sel_method)
    st, rk = pad_nodes(auto.sim.init_state, auto.sim.rank, 128)
    evk = torch.as_tensor(auto.ev_kind[:SCALE_CHUNK], device=device)
    evp = torch.as_tensor(auto.ev_pod[:SCALE_CHUNK], device=device)
    init = fe.prepare_init_tables(st, auto.types, auto.sim.typical, cfg)
    init_ms = kernel_ms(init, 3)
    tables = init.finish()
    ms, dig = ab_timed(he.prepare_replay_blocked(
        st, auto.specs, auto.types, evk, evp, auto.sim.typical, rk, tables,
        cfg), st, tables, 1, warmup=False)
    out["scale"] = dict(init_tables=init_ms, replay_blocked=ms,
                        init_tables_digest=tables_digest(tables),
                        replay_blocked_digest=dig, events=SCALE_CHUNK)
    print(f"[{tree}] scale first chunk ({SCALE_CHUNK} events, "
          f"{SCALE_NODES} nodes): init_tables {init_ms:.4f} ms, "
          f"replay_blocked {ms:.3f} ms", flush=True)
    return out


def ab_main(trees) -> int:
    """--ab: one ab_turn process per tree, in the order given; the turns'
    table, and whether their outputs agree."""
    turns = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--ab-turn", tree], capture_output=True,
                              text=True)
        lines = proc.stdout.strip().splitlines()
        sys.stdout.write("".join(f"{line}\n" for line in lines[:-1]))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            print(f"chip_smoke --ab: the turn of {tree} failed",
                  file=sys.stderr)
            return 1
        turns.append(json.loads(lines[-1]))

    bad = []
    # the rows every turn ran (an older checkout lacks the newer ones)
    rows = [r for r in turns[0]["rows"] if all(r in t["rows"] for t in turns)]
    for label in rows + ["scale"]:
        for name in ("init_tables", "init_tables_hbm", "replay",
                     "replay_blocked"):
            key = f"{name}_digest"
            recs = [t["scale"] if label == "scale" else t["rows"][label]
                    for t in turns]
            if key in recs[0] and len({r[key] for r in recs}) != 1:
                bad.append(f"{label} {name}")
    names = [os.path.basename(os.path.normpath(t["tree"])) for t in turns]
    print(f"card: {turns[0]['card']}; turns: {', '.join(names)}")
    for label in rows:
        for name in ("init_tables", "replay", "replay_blocked", "wall"):
            vals = " ".join(f"{t['rows'][label][name]:10.4f}" for t in turns)
            print(f"{label:20s} {name:15s} {vals} ms")
    for name in ("init_tables", "replay_blocked"):
        vals = " ".join(f"{t['scale'][name]:10.3f}" for t in turns)
        print(f"{'scale chunk':20s} {name:15s} {vals} ms")
    for name, t in zip(names, turns):
        for line in t["ptxas"]:  # a turn that reused a build has none
            print(f"ptxas [{name}]: {line}")
    os.makedirs(os.path.dirname(AB_OUT), exist_ok=True)
    with open(AB_OUT, "w") as f:
        json.dump(dict(turns=turns, differing=bad), f, indent=1)
    if bad:
        print(f"chip_smoke --ab: the turns' outputs differ: {bad}",
              file=sys.stderr)
        return 1
    print("chip_smoke --ab: every turn's outputs agree")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", choices=PHASES,
                    help="run only these phases (repeatable); without it "
                    "every phase runs and the kernels line is printed")
    ap.add_argument("--ab", nargs="+", metavar="TREE",
                    help="time the kernels of these checkouts in turns, in "
                    "this order, instead of the phases")
    ap.add_argument("--ab-turn", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = set(args.only or PHASES)
    if args.ab_turn:
        # this process imports the checkout's tpusim_torch, not its own
        sys.path.insert(0, os.path.abspath(args.ab_turn))
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
    if args.ab:
        return ab_main(args.ab)
    if args.ab_turn:
        try:
            print(json.dumps(ab_turn(args.ab_turn)))
        except SmokeFailure as err:
            print(f"chip_smoke --ab: FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    device = torch.device("cuda")
    try:
        card = card_line()
        print(f"card: {card}")
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda}")

        t0 = time.perf_counter()
        infos = kernels.build_all(tuple(kernels.VARIANTS))
        print(f"build: {len(infos)} variants, one nvcc each, in parallel: "
              f"{time.perf_counter() - t0:.1f} s")
        for variant, info in infos.items():
            print(f"build [{variant or 'main'}]: {info.seconds:.1f} s -> "
                  f"{info.path}")
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line or \
                        "Function" in line:
                    print(f"ptxas [{variant or 'main'}]: {line.strip()}")
        print(f"kernels: {', '.join(kernels.KERNELS)} "
              f"(route cuda, {SOURCE})")
        kernels.library()
        from tpusim_torch import native

        t1 = time.perf_counter()
        path = native.build()
        print(f"build [bellman]: g++, {time.perf_counter() - t1:.1f} s -> "
              f"{path}")

        launches, clocks = {}, []
        errors = dict.fromkeys(kernels.KERNELS, 0)
        if "check" in phases:
            measured, worst = check_kernels(device, card)
            blocked, err = check_blocked(device, card)
            worst["replay_blocked"] = max(worst["replay_blocked"], err)
            errors.update(worst)
            print(f"phase check done at {time.perf_counter() - t0:.1f} s")
        if "clocks" in phases:
            clocks += phase_clocks(device, card, openb_inputs(device),
                                   "openb", CLOCK_ROWS,
                                   ("replay", "replay_blocked"))
            print(f"phase clocks done at {time.perf_counter() - t0:.1f} s")
        if "main" in phases:
            launches = main_path(device, card)
            print(f"phase main done at {time.perf_counter() - t0:.1f} s")
        if "apply" in phases:
            counts, app_err = apply_path(device, card)
            launches.update(counts)
            for name, err in app_err.items():
                errors[name] = max(errors[name], err)
            print(f"phase apply done at {time.perf_counter() - t0:.1f} s")
        if "scale" in phases or "clocks" in phases:
            setup = scale_inputs(device)
            if "scale" in phases:
                launches["scale"], scale = scale_path(device, card, *setup)
                for name, err in scale.pop("errors").items():
                    errors[name] = max(errors[name], err)
            if "clocks" in phases:
                clocks += scale_clocks(setup[2], device, card)
            print(f"phase scale done at {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1

    if clocks:
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "phase_clocks.json"), "w") as f:
            json.dump(dict(card=card, runs=clocks), f, indent=1)
    if phases == set(PHASES):
        print(json.dumps({"kernels": kernel_rows(
            kernels.KERNELS, measured, blocked, launches, scale, errors)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_rows(names, measured, blocked, launches, scale, errors):
    """The kernels line's rows: 06-FGD's numbers at openb, with every
    measured configuration and the scale run under "configs"."""
    for label, m in blocked.items():
        measured.setdefault(label, {})["replay_blocked"] = m
    rows = []
    for name in names:
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
    return rows


if __name__ == "__main__":
    sys.exit(main())
