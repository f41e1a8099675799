"""Smoke run of the PyTorch/CUDA port (tpusim_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only clocks    # phases by name, repeatable
    python3 chip_smoke.py --only sweep     # the lanes kernels' phase
    python3 chip_smoke.py --only evict     # descheduling and faults
    python3 chip_smoke.py --only lane      # the in-scan fault lane
    python3 chip_smoke.py --only seq       # the sequential oracle
    python3 chip_smoke.py --only ckpt      # chunks, resume, forks, cache
    python3 chip_smoke.py --only obs       # decisions, series, spans
    python3 chip_smoke.py --only learn     # the learned policy, tune, imitate

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. card    the card's name and power limit (nvidia-smi); a CUDA device is
           required.
2. build   the port's CUDA kernels, compiled from tpusim_torch/kernels/*.cu:
           the main library, an nvcc a source, all in parallel, then a
           link; the variants of kernels.VARIANTS (the clocked build) the
           same way while the check phase runs, waited for after it.
3. check   each kernel against its plain PyTorch version on the same inputs,
           tolerance zero (exact equality), for every policy configuration
           the kernels cover: init_tables on the full openb tables of each
           (flat and padded), on seeded random and type-shape cases, and on
           partly used clusters of INIT_NODES nodes under INIT_ROWS (1, 2,
           3 and 8 distinct device values a node, CPU-only nodes, share
           types that fit no device, Sub picks over unequal values,
           typical pods of frequency 0), beside an empty launch's time;
           replay on seeded random clusters (256 nodes, ~320 events for
           RANDOM_ROWS, ~200 for the other rows, DotProduct pairs,
           FGD/worst and the MIXES of RandomScore,
           gpu_sel random and Simon; the randomized ones through the
           randomized instantiation, from a root key) and on the openb
           trace over its first 1,000 events under FGD and its first 500
           under Simon, the six-policy profile, FGD/worst and 01-Random
           (PREFIX_ROWS, PREFIX_EVENTS; the kernel timed on the same
           prefix), and
           replay_blocked on seeded random
           clusters of five 128-node blocks for every method row's
           configuration that draws nothing per event, FGD/worst and
           Simon+FGD, of 17 and 513 blocks for BestFit
           and PWR+FGD, and on the openb trace (FGD's and Simon's
           prefixes), its plain version on CPU copies of the
           inputs; both replay kernels on the type
           shapes of SHAPE_CASES over the first quarter of each case's
           events (share items past a round of the block's
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
           must match the row's JAX digests (FGD_WORST's for FGD/worst),
           and the bounds count refreshes from those placements.
4. clocks  the phase split of both replay kernels through the clocked
           build (each run's outputs held to the main build's) for 06-FGD,
           05-BestFit, 08 and 01-Random (replay only) at openb and, in the
           scale phase, on the first
           1,000 events at 100k nodes; written to
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
           the first chunk must give identical outputs. Both kernels are
           timed. At the scale width init_tables and both replay kernels
           are held to their plain versions (CPU copies) over 500
           events from the state after the first chunk, for FGD, BestFit
           and PWR+FGD, tolerance 0 with stats and final tables; then both
           replay kernels are timed on 5,000 events at 10k, 30k and 100k
           nodes for 06-FGD, 05-BestFit and 08, beside the tier auto picks
           there.
8. sweep   the lanes kernels `replay_lanes` and `replay_blocked_lanes` (a
           block a lane, one launch) on their paths, the launch counts set
           to 0 before each run and read after it (init_tables and the
           residency's lanes kernel once each): the seed batch, 06-FGD
           under tuning seeds 42-57 through dispatch_run_batch and
           finish_run_batch with reports on (every lane equal to its
           standalone kernel run, lanes 42-45 to the JAX digests, lane
           42's log and CSVs to REPORT_SHA256); the reference's acceptance
           weight grid over FGDScore + BestFitScore (16 rows) through
           Simulator.run_sweep under "auto" and "hbm", and 01-Random under
           seeds 42-57, each lane equal to its standalone kernel run with
           its row and seed in the configuration; both lanes kernels
           against their plain versions, tolerance 0 with final states,
           tables and summaries, on a 256-node random cluster (4 lanes)
           and at the main path's shape, openb over its first 500
           events (2 lanes: the grid's first and last rows through both
           kernels, 01-Random under two keys and ranks);
           both lanes kernels alone and the whole schedule_pods_sweep call
           timed at 1, 16, 64, 132 and 264 lanes for 06-FGD and the
           FGD+BestFit grid under both residencies, beside the bound and a
           standalone warm replay (a lane's marginal cost at 16 lanes must
           stay within 1/5 of it, the reference's sweep bound), run_batch
           at 1 and 16 seeds, and `python -m tpusim_torch.sweep --methods
           06-FGD --seeds 4` against the 4 experiments one by one (every
           directory's files equal).
9. evict   eviction and rescheduling on their paths, the launch counts
           set to 0 before each run and read after it. The descheduler
           through `python -m tpusim_torch`'s experiment stages
           (run_experiment) on openb, 06-FGD (tune 1.3, seeds 42), -r
           0.1 under -p cosSim, fragOnePod and fragMultiPod, and
           fragOnePod with --workload-inflation-ratio 1.1
           (DescheduleInflation): init_tables and replay once for the
           main replay, once for the victims and once for each inflation
           run; the final placements, masks, creation ranks, unscheduled
           pods, simon.log and CSVs held to the JAX digests
           (DESCHED_SHA256); the deschedule stage timed. Then
           Simulator.run_with_faults with the README's fault schedule
           (FAULT_FLAGS) under 06-FGD with residency "auto" and "hbm" and
           01-Random: one init_tables and one replay (or replay_blocked)
           launch a segment; results, disruption metrics, log and CSVs
           held to FAULT_SHA256; segments, launches and the wall printed.
           Then `apply` with the README's fault command on the example
           bundle (APPLY_FAULT_SHA256). Last, the kernels on clusters with
           failed nodes: init_tables, replay and replay_blocked against
           their plain versions (CPU copies), tolerance 0 with final
           states, tables and summaries, on the 06-FGD fault run's first
           segment after a node failure and on a 256-node random cluster
           with a quarter of its nodes down under 06-FGD, the six-policy
           profile (flat only: it draws per event) and 05-BestFit.

10. lane  the in-scan fault lane on the replays' fault forms
           (replay_faults, replay_blocked_faults and their lanes forms):
           each against its plain version on CPU copies, tolerance 0 with
           outputs, the steps' outputs (the recover frags bit for bit),
           the final carry, tables and summaries, on the openb merged
           stream's first LANE_PREFIX steps (FAULT_FLAGS under 06-FGD; one
           launch, and 4 equal lanes held to it) and on a LANE_CASE random
           cluster with the LANE_CASE_FLAGS schedule under LANE_ROWS (one
           launch, and 4 lanes of their own schedules, ranks and keys; the
           six-policy profile flat only), each timed beside its plain
           version and bound; the whole openb lane's launch timed. Then
           run_with_faults with FAULT_FLAGS on openb, reports off, under
           06-FGD with residency "auto" and "hbm" and 01-Random under
           fault_mode scan: one init_tables and one fault-form launch
           each, results and disruption metrics held to
           FAULT_SCAN_SHA256, the plan's compile, the launch, the fetch
           and the host tail timed apart; the segmented host loop on the
           same run timed beside it. Then the chaos sweep: 8 lanes of
           FAULT_FLAGS under fault seeds 1-8 (replay_lanes_faults, one
           launch), each equal to its standalone lane run and seed 7's to
           FAULT_SCAN_SHA256, its first 4 under "hbm"
           (replay_blocked_lanes_faults) equal to them, and `apply
           --sweep-faults` with the README's faults.json on the example
           bundle, held to CHAOS_APPLY_SHA256. Writes
           chiprun_out/lane_phase.json.
11. seq   the sequential oracle (Simulator(engine="sequential"), the host
           loop of tpusim_torch.sim.step's cycle over tensors on the card,
           no tables and no replay kernel) against the JAX package's
           sequential engine: the whole openb trace under 06-FGD with
           per-event reports on (placements, masks, simon.log and CSVs held
           to SEQ_SHA256, which is also compared with the replay kernel's
           METHODS and REPORT_SHA256 digests; no replay kernel may launch),
           its replay timed with the host's busy share; every other method
           row, Simon and the six-policy profile over the first SEQ_PREFIX
           events (SEQ_PREFIX_SHA256), the flat replay kernel on the same
           events held to the oracle's outputs and final state; the
           oracle's fault form over the first SEQ_FAULT_STEPS steps of
           FAULT_FLAGS' openb merged stream (SEQ_FAULT_SHA256), replay_faults
           held to it; the extender host loop on EXTENDER_CASE against a
           stub extender on 127.0.0.1 (SEQ_EXTENDER_SHA256). Writes
           chiprun_out/seq_phase.json.
12. ckpt  chunked replay through the chunk surface (table_engine: an
           init_tables and a replay launch a chunk, each chunk started from
           the carried state, placements and key, the kernel writing the
           chain's key after its last event) at openb, the launch counts
           set to 0 before each run and read after it: Simulator.run()
           with checkpoint_every CKPT_EVERY (11 chunks) under 06-FGD with
           residency "auto" (replay) and "hbm" (replay_blocked) and under
           01-Random (the key chain across chunks), each held to METHODS
           and REPORT_SHA256, its warm replay wall beside the one-launch
           wall, and one chunk boundary's parts timed (init_tables, the
           carry's fetch, the checkpoint write); a 06-FGD run in a child
           process killed with SIGKILL once its checkpoint at event
           CKPT_KILL_AT is on disk, then run again here: it resumes there
           and matches the same digests (the log without its [Checkpoint]
           line); schedule_pods_fork at CKPT_FORK_EVENT with FORK_TAIL,
           warm from a base run's kept ladder and cold, both held to
           FORK_SHA256, beside a one-launch replay of the spliced stream;
           the table cache, a miss then a hit (no init_tables launch), the
           hit's load timed against init_tables' launch. Writes
           chiprun_out/ckpt_phase.json.
13. obs   the record forms of the replay kernels (replay_records.cu and
           replay_blocked_records.cu: counters, decisions, the series, the
           heartbeat ring) on their
           path, the launch counts set to 0 before each run and read after
           it: Simulator.run() of openb 06-FGD with record_decisions and
           series_every OBS_EVERY under residency "auto"
           (`replay_record`) and "hbm" (`replay_blocked_record`): one
           init_tables and one record launch each, placements and masks
           held to METHODS, the decisions (INVARIANT_FIELDS), the series
           and the counters to tpusim's table engine (DECISIONS_SHA256,
           SERIES_SHA256, OBS_COUNTERS), the blocked block column to the
           JAX blocked engine's (BLOCK_SHA256); the sequential oracle's
           decisions over the first OBS_PREFIX events on the card equal
           the kernel's; `diff` of 06-FGD's decision file against
           05-BestFit's (exit 1, DIFF_FIRST_EVENT) and `explain` of that
           event; a profiled run (profile=True, reports on): its spans,
           its JSONL, Prometheus and Chrome files parsed back; each record
           form alone against its plain version (CPU copies, tolerance 0)
           over the first OBS_KERNEL_EVENTS openb events and on a random
           cluster of a normalised configuration with pinned pods and
           carried counters, timed (CUDA events, median of 3) beside the
           form that records nothing; the heartbeat over the scale phase's
           first chunk (OBS_HEARTBEAT_EVENTS events at 100k nodes) with
           its exact tick count. Writes chiprun_out/obs_phase.json.
14. learn the learned policy (tpusim_torch.learn) on the learned
           instantiations of the replay kernels (replay_learned.cu,
           replay_blocked_learned.cu, replay_learned_records.cu,
           replay_learned_faults.cu, replay_blocked_learned_faults.cu) and
           the teacher-forced form (replay_forced.cu), the launch counts
           set to 0 before each run and read after it: Simulator.run() of
           the openb linear family at LEARN_THETA and the bucketed one at
           LEARN_THETA_B under "vmem" and "hbm" against tpusim's digests
           (LEARN_SHA256); each learned kernel against its plain version
           (CPU copies, tolerance 0) over the first LEARN_PREFIX events,
           the record forms (LEARN_RECORD_EVENTS), both lanes forms
           (LEARN_LANES_EVENTS, two weight vectors) and the fault forms
           (LEARN_FAULT_STEPS merged steps of the lane phase's schedule),
           timed beside 06-FGD's; a record run's per-feature sums against
           every create's total; an 8-vector sweep against standalone
           runs; the openb learned fault lane and a chaos sweep; `tune`
           through the CLI (LEARN_TUNE_FLAGS) against tpusim's log and
           output (TUNE_LOG_SHA256, TUNE_STDOUT_SHA256), one generation
           timed; the FGD teacher of tpusim's 400-pod acceptance prefix
           recorded on the card (TEACHER_SHA256) and imitated through
           replay_forced (IMITATE_THETA, IMITATE_HOLDOUT); replay_forced
           against its plain version (FORCED_PREFIX events). Writes
           chiprun_out/learn_phase.json.

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

import concurrent.futures
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
# FGD with gpu_sel worst, the one-FGD configuration through the general
# kernel, as a METHODS row: the digests of the JAX package's
# Simulator.run() of it on openb, as above. tests/test_torch_driver.py
# pins them against tpusim.
FGD_WORST = ("FGD-worst", [("FGDScore", 1000)], "worst", "share", "max",
             "28021787b25d21b0126b0fcea28b45342593adde91e4d5742eab15d8b58f282b",
             "991292f9f1c3b11035bda2f1f111dcf581cf477a38ecea304aab648a28427b80")
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
# the state after the first chunk; FGD's plain table build on the first
# SCALE_INIT_COLUMNS nodes (it takes ~33 s of host time over all of them)
SCALE_PREFIX = 500
SCALE_INIT_COLUMNS = 12_800
# the clocks phase's split at 100k nodes: the stream's first events
SCALE_CLOCK_EVENTS = 1_000
# where auto's choice is measured: both replay kernels alone on the first
# CROSSOVER_EVENTS events of the stream at each width, for these rows
CROSSOVER_NODES = (10_000, 30_000, 100_000)
CROSSOVER_EVENTS = 5_000
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
            "replay_blocked": "tpusim/sim/pallas_engine.py:1346",
            "replay_lanes": "tpusim/sim/pallas_engine.py:780",
            "replay_blocked_lanes": "tpusim/sim/pallas_engine.py:1346",
            "replay_faults": "tpusim/sim/pallas_engine.py:780",
            "replay_lanes_faults": "tpusim/sim/pallas_engine.py:780",
            "replay_blocked_faults": "tpusim/sim/pallas_engine.py:1346",
            "replay_blocked_lanes_faults":
                "tpusim/sim/pallas_engine.py:1346"}
# the kernels each residency's replay launches
RESIDENCY_KERNELS = {"vmem": ("init_tables", "replay"),
                     "hbm": ("init_tables", "replay_blocked")}
# rows whose replay is checked on ~320-event random clusters (of
# RANDOM_ROW_PODS pods; FGD's three seeds too); the other configurations
# get ~200 events (OTHER_ROW_PODS pods)
RANDOM_ROW_PODS = 240
OTHER_ROW_PODS = 150
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
# version, beside the kernel, over the first PREFIX_EVENTS (else
# PLAIN_PREFIX) events, the kernel timed again on the same prefix: the
# paper's FGD row, Simon, the six-policy profile, FGD/worst and 01-Random.
# Their whole runs are held to the JAX digests (METHODS, FGD_WORST; the
# key chain also by the sweep phase's lanes); their plain versions take
# 30-160 s of host time each over the whole trace
PREFIX_ROWS = ("06-FGD", "Simon", "default-profile", "FGD-worst",
               "01-Random")
PLAIN_PREFIX = 500
PREFIX_EVENTS = {"06-FGD": 1_000}
DIM_EXT = ("merge", "share", "divide", "extend")
NORM = ("node", "pod", "max")
# node counts of the wide random blocked cases: 17 blocks (more than the
# block's 16 warps) and 513 (more than its 512 threads)
WIDE_BLOCKED = (2100, 65_600)
# their pods (the five-block cases have 300)
WIDE_PODS = 150
SOURCE = "tpusim_torch/kernels/replay.cu"
LANES_SOURCE = "tpusim_torch/kernels/replay_lanes.cu"
# the chunk forms of replay and replay_blocked (the ckpt phase's launches)
CHUNK_SOURCE = "tpusim_torch/kernels/replay_chunks.cu"
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
    state and tables it starts from, and its per-pod outputs (every lane's
    copies of a lanes launch)."""
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


def shape_errors(label: str, row: str, device, events: int = None) -> dict:
    """Each kernel's largest error against its plain version on the
    SHAPE_CASES case `label` under the method row `row` (init_tables on
    the case's nodes and on them padded to 128), over the case's first
    `events` events (all of them by default)."""
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe

    i = [c[0] for c in SHAPE_CASES].index(label)
    _, ks, kw, t, nodes, num_pods, num_events = SHAPE_CASES[i]
    state, pods, types, evk, evp, tp, rank = typed_case(
        200 + i, nodes, ks, kw, t, num_pods, device, events or num_events)
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
    the SHAPE_CASES under the SHAPE_ROWS configurations, over the first
    quarter of each case's events, and past the staged limits
    (past_limit_errors). Returns the largest error of each kernel."""
    worst = dict(init_tables=0, replay=0, replay_blocked=0)
    for label, *_, events in SHAPE_CASES:
        for row in SHAPE_ROWS:
            errs = shape_errors(label, row, device, events // 4)
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
                        RANDOM_ROW_PODS if mid in RANDOM_ROWS
                        else OTHER_ROW_PODS))
    for dim_ext in DIM_EXT:
        for norm in NORM:
            if (dim_ext, norm) != ("merge", "max"):
                out.append((f"DotProd-{dim_ext}-{norm}", fe.make_config(
                    [("DotProductScore", 1000)], "DotProductScore", dim_ext,
                    norm), OTHER_ROW_PODS))
    out.append((FGD_WORST[0], fe.make_config(*FGD_WORST[1:5]),
                OTHER_ROW_PODS))
    out += [(label, fe.make_config(policies, gpu_sel), OTHER_ROW_PODS)
            for label, policies, gpu_sel in MIXES]
    return out


def check_random(device):
    """Both kernels against their plain versions on seeded random
    clusters of 256 nodes, for every checked configuration. Returns the
    largest error of each kernel."""
    from tpusim_torch.sim import fused_engine as fe

    worst = {"init_tables": 0, "replay": 0}
    fgd = [(f"06-FGD seed={seed}", fe.make_config(
        [("FGDScore", 1000)], "FGDScore" if seed != 3 else "best"),
        RANDOM_ROW_PODS)
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
            + [(FGD_WORST[0], fe.make_config(*FGD_WORST[1:5]))]
            + [(label, fe.make_config(policies, gpu_sel))
               for label, policies, gpu_sel in MIXES if label == "Simon+FGD"])


def check_random_blocked(device) -> int:
    """replay_blocked against plain_replay_blocked, which runs on CPU
    copies of the same inputs, on seeded random clusters: of 600 nodes
    (five 128-node blocks once padded) for every method row's configuration
    and FGD/worst, and for the normalised BestFit and PWR+FGD rows also of
    WIDE_BLOCKED nodes (WIDE_PODS pods), where a warp rebuilds several
    blocks of a summary row and the select and drift loops stride over
    more blocks than the block has threads. Outputs, stats, final tables
    and summaries, tolerance 0. Returns the largest error."""
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
            100 + i, nodes, 300 if nodes == 600 else WIDE_PODS, device)
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
    methods = {row[0]: row for row in METHODS + [FGD_WORST]}
    tp_bytes = 5 * t * 4
    type_bytes = 5 * k * 4
    state_bytes = n * (1 + 1 + 1 + 1 + 8 + 9 + 1 + 1) * 4
    measured = {}
    # FGD/worst runs the one-FGD configuration through the general kernel:
    # what the runtime policy switch costs beside 06-FGD's specialised one
    timed = rows + [(FGD_WORST[0], fe.make_config(*FGD_WORST[1:5]))]
    for label, cfg in timed:
        init_ms, plain_init_ms, tables = plain_init[label]
        ready, reset = prepared(cfg, tables)
        replay_ms = kernel_ms(ready, 3, reset)
        got = ready.finish()  # the last timed launch ran from the reset state
        plain_replay_ms = None
        check_digests(f"replay {label}", got, *methods[label][5:7])
        refreshes = placed_refreshes(kinds, pods, got.placed_node)
        prefix = {}
        if label in PREFIX_ROWS:  # beside the plain version
            keep, m = {}, PREFIX_EVENTS.get(label, PLAIN_PREFIX)
            ek, ep = evk[:m], evp[:m]
            cmp_ready = fe.prepare_replay(state, specs, types, ek, ep, tp,
                                          rank, tables, cfg, key=OPENB_KEY)
            prefix = dict(prefix_events=m, prefix_ms=kernel_ms(
                cmp_ready, 3, reset_of(cmp_ready, state, tables)))
            cmp_got = cmp_ready.finish()
            ms_p, want = wall_ms(lambda: fe.plain_replay(
                state, specs, types, ek, ep, tp, rank, tables, cfg,
                keep=keep, key=OPENB_KEY))
            prefix["plain_prefix_ms"] = ms_p
            if label == "06-FGD":  # the kernels line's plain_ms
                plain_replay_ms = ms_p
            err = max(max_abs_err(cmp_got, want),
                      final_errors(cmp_ready, cmp_got, keep, types, tp, cfg))
            print(f"check openb replay {label} E={m} P={p}: "
                  f"max_abs_err={err} with final tables (tolerance 0); plain "
                  f"{ms_p:.1f} ms, the kernel on the same prefix "
                  f"{prefix['prefix_ms']:.3f} ms")
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
        if prefix:
            measured[label]["replay"]["plain_note"] = (
                "plain_replay over the first prefix_events events, the "
                "kernel on the same events prefix_ms")
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
        if label in PREFIX_ROWS:  # beside the plain version
            keep, m = {}, PREFIX_EVENTS.get(label, PLAIN_PREFIX)
            ek, ep = evk[:m], evp[:m]
            cmp_ready, cmp_reset = prepared(cfg, tables, ek, ep)
            prefix = dict(prefix_events=m,
                          prefix_ms=kernel_ms(cmp_ready, 3, cmp_reset))
            cmp_got = cmp_ready.finish()
            ms_p, want = wall_ms(lambda: he.plain_replay_blocked(
                *to_cpu((state, specs, types, ek, ep, tp, rank, tables)),
                cfg, keep=keep))
            prefix["plain_prefix_ms"] = ms_p
            if label == "06-FGD":  # the kernels line's plain_ms
                plain_ms = ms_p
            err = max(max_abs_err(to_cpu(cmp_got), want),
                      final_errors(cmp_ready, cmp_got, keep, types, tp, cfg))
            print(f"check openb replay_blocked {label} E={m} P={p} "
                  f"N={n}: max_abs_err={err} with final tables and summaries "
                  f"(tolerance 0, stats {cmp_got[1].tolist()}); plain "
                  f"{ms_p:.1f} ms on the CPU, the kernel on the same prefix "
                  f"{prefix['prefix_ms']:.3f} ms")
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
        if prefix:
            measured[label]["plain_note"] = (
                "plain_replay_blocked on CPU copies of the inputs over the "
                "first prefix_events events, the kernel on the same events "
                "prefix_ms")
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
    the flat replay over the first chunk, each kernel alone on the first
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

    # the flat replay over the first chunk (a comparison: not counted)
    flat = bs.ScaleRun(nodes, pods, bs.scale_config(SCALE_SEED, "vmem"),
                       device)
    wall_f, (_, results_f, _, _) = wall_ms(
        lambda: flat.replay(SCALE_CHUNK, SCALE_CHUNK))
    err = max_abs_err(results[0], results_f[0])
    print(f"check scale: {flat.sim.last_engine} against replay_blocked over "
          f"the first chunk: max_abs_err={err} (tolerance 0); wall "
          f"{wall_f / 1e3:.3f} s, {wall_f * 1e3 / SCALE_CHUNK:.3f} us an "
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
                                 else wall_f) / 1e3,
                         wall_events=(SCALE_EVENTS if name == "replay_blocked"
                                      else SCALE_CHUNK), **bound)
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
    scale configuration (init_tables launched at N = 100,096 and held on
    its first SCALE_INIT_COLUMNS columns, replay_blocked at N = 100,096,
    replay at 100,000) and the normalised 05-BestFit and 08 rows
    (replay_blocked; init_tables for BestFit on every column, its plain
    table build being cheap). The plain versions run on CPU copies of the
    same inputs; the
    kernels launch past their wrappers. Tables, outputs and stats,
    tolerance 0. Returns the largest error of each kernel."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.types import NodeState

    sim, types, tp, specs = auto.sim, auto.types, auto.sim.typical, auto.specs
    lo, hi = SCALE_CHUNK, SCALE_CHUNK + SCALE_PREFIX
    evk = torch.as_tensor(auto.ev_kind[lo:hi], device=device)
    evp = torch.as_tensor(auto.ev_pod[lo:hi], device=device)
    padded, rank_p = pad_nodes(state, sim.rank, 128)
    rows = {row[0]: row for row in METHODS}
    worst = dict(init_tables=0, replay=0, replay_blocked=0)
    for label, kernels, init_cols in (
            ("06-FGD", ("replay", "replay_blocked"), SCALE_INIT_COLUMNS),
            ("05-BestFit", ("replay_blocked",), padded.num_nodes),
            ("08-PWR_500_FGD_500", ("replay_blocked",), 0)):
        cfg = fe.make_config(*rows[label][1:5])
        tables = {}
        for st in (state, padded):
            init = fe.prepare_init_tables(st, types, tp, cfg)
            fe.launch(init)
            tables[st.num_nodes] = init.finish()
        if init_cols:
            # a table column is a function of its node's row alone
            t0 = time.perf_counter()
            want = fe.plain_init_tables(*to_cpu((NodeState(*(
                x[:init_cols] for x in padded)), types, tp)), cfg)
            plain_s = time.perf_counter() - t0
            err = max_abs_err(to_cpu(tuple(
                x[..., :init_cols] for x in tables[padded.num_nodes])), want)
            print(f"check scale init_tables {label} [{len(cfg.policies)}x"
                  f"{types.num_types}, {padded.num_nodes}] from the state "
                  f"after the first chunk, its first {init_cols} columns: "
                  f"max_abs_err={err} (tolerance 0); plain {plain_s:.1f} s "
                  f"on the CPU")
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


# The sweep phase: the seed batch (06-FGD, tuning seeds SWEEP_SEEDS), the
# reference's acceptance weight grid over FGDScore + BestFitScore (gpu_sel
# FGDScore, tpusim's tests/test_sweep.py test_openb_sweep_acceptance), the
# 01-Random lanes, the lane counts timed, and the digests of the JAX
# package's Simulator.run() of 06-FGD with tuning seed and seed 43, 44 and
# 45 (CPU, table engine; seed 42's are OPENB_*): sha256 of placed_node as
# int32 and of dev_mask as uint8. tests/test_torch_sweep.py pins them
# against tpusim (slow-marked).
SWEEP_SEEDS = tuple(range(42, 58))
# the seeds of the sweep CLI's run (`--seeds 4` takes the first four)
SWEEP_CLI_SEEDS = SWEEP_SEEDS[:4]
SWEEP_POLICIES = (("FGDScore", 1000), ("BestFitScore", 500))
SWEEP_GRID = tuple((1000 - 37 * i, 100 + 60 * i) for i in range(16))
SWEEP_LANES = (1, 16, 64, 132, 264)
# the lanes kernels against their plain versions at openb: this many events
SWEEP_PREFIX = 500
SEED_SHA256 = {
    43: ("395e8fc46d577f098be8df35c5b9552dc4c78db13c9025a82773425b161c94c2",
         "9440794d38479db4ce797205de08d8f393465501d205dbf103d91f00e0cbcdb3"),
    44: ("707276776f452dc046b617831fecd8abff5980b9d417ea8fcdca5cd897d0f56e",
         "f375172749953e64afe9f2183062aca2b7f6513b8e83fe2945331ea251dab803"),
    45: ("0d3c5e935973db6e2ae4d47638f0445fe053a6b458a6c19645dfcf2fccb2b613",
         "40d0b8bef75b89b811a8815e7624e267fba13ecf86d24516e80959672d2e82a2"),
}
# report_digest of experiments/run.py's 06-FGD experiment as
# experiments/sweep.py runs it (tune 1.3, tuning seed 42, shuffled, the
# typical pods of run.py's flags: popularity 95, step 1), on the CPU.
# tests/test_torch_sweep.py pins it against experiments/run.py.
SWEEP_CLI_SHA256 = (
    "9a0b3d93e4381a71cac4b653b412c612299505f4344b6ce6cb5bab3ab42f563a"
)
# the card's streaming multiprocessors: a lanes launch runs a lane a block,
# one block an SM, so past this many lanes it takes more than one wave
H100_SMS = 132
# the reference's sweep bound: a lane's marginal cost at B = 16, report
# off, against a standalone warm replay
MARGINAL_BOUND = 0.2
LANE_KERNELS = ("replay_lanes", "replay_blocked_lanes")


def same_replay(label: str, got, want) -> None:
    """A lane's placements, masks, failures and final state against its
    standalone run's, exactly."""
    import torch

    pairs = [("placed_node", got.placed_node, want.placed_node),
             ("dev_mask", got.dev_mask, want.dev_mask),
             ("ever_failed", got.ever_failed, want.ever_failed)]
    pairs += [(f"state.{f}", a, b) for f, a, b in
              zip(want.state._fields, got.state, want.state)]
    for name, a, b in pairs:
        if not torch.equal(torch.as_tensor(np.asarray(a)).cpu(),
                           torch.as_tensor(np.asarray(b)).cpu()):
            raise SmokeFailure(f"{label}: {name} differs from the "
                               "standalone kernel run")


def lane_counts(label: str, counts: dict, kernel: str) -> None:
    """A lanes run launched init_tables once, `kernel` once and no other
    replay kernel."""
    want = {name: (1 if name in ("init_tables", kernel) else 0)
            for name in counts}
    if counts != want:
        raise SmokeFailure(f"{label}: launches {counts} (want {want})")


def lanes_bound(chains, b: int, table_set_bytes: int):
    """(bound ms, what bounds it) of a lanes launch of b lanes: the
    longest lane's serial chain, once per wave of H100_SMS lanes, against
    the bytes of b table sets at the memory rate."""
    chain = max(chains) * -(-b // H100_SMS)
    by_bytes = b * table_set_bytes / PEAK_BYTES_PER_S * 1e3
    return (chain, "operations") if chain >= by_bytes else (by_bytes,
                                                            "bytes")


def sweep_seed_batch(device, nodes, pods, card):
    """The seed batch: 06-FGD under SWEEP_SEEDS through dispatch_run_batch
    and finish_run_batch, reports on. Returns the run's launch counts."""
    import types

    import torch

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.sim import driver as drv
    from tpusim_torch.sim import fused_engine as fe

    row = dict((r[0], r) for r in METHODS)["06-FGD"]
    sims = []
    for seed in SWEEP_SEEDS:
        sim = drv.Simulator(nodes, method_config(*row[1:5], tune_seed=seed),
                            device=device)
        sim.set_workload_pods(pods)
        sims.append(sim)
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    handle = drv.dispatch_run_batch(sims)
    t1 = time.perf_counter()
    results = drv.finish_run_batch(handle)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    ran = f"{sims[0].last_engine} ({sims[0].last_residency})"
    lane_counts("sweep seed batch", counts, "replay_lanes")
    csv_ms = check_report("sweep seed batch lane 42", sims[0], "06-FGD",
                          row_meta(*row[1:3], row[3]))
    want = {42: (OPENB_PLACED_SHA256, OPENB_DEV_MASK_SHA256), **SEED_SHA256}
    for sim, res in zip(sims, results):
        seed = sim.cfg.seed
        if seed in want and (digest(res.placed_node, np.int32),
                             digest(res.dev_mask, np.uint8)) != want[seed]:
            raise SmokeFailure(f"sweep seed batch lane {seed}: differs from "
                               "the JAX reference's digests")
        trace = sim.prepare_pods()
        specs = pods_to_specs(trace, sim.node_index, device)
        evk, evp = build_events(trace)
        alone = sim.run_events(sim.init_state, specs, evk, evp)
        same_replay(f"sweep seed batch lane {seed}", types.SimpleNamespace(
            placed_node=res.placed_node, dev_mask=res.dev_mask,
            ever_failed=sim.last_ever_failed, state=res.state),
            type(alone)(*to_cpu(tuple(alone))))
    print(f"sweep seed batch 06-FGD seeds {SWEEP_SEEDS[0]}-{SWEEP_SEEDS[-1]}"
          f" (B={len(sims)}, reports on): {ran}, launches {counts}; every "
          f"lane equals "
          f"its standalone kernel run, lanes 42-45 match the JAX digests, "
          f"lane 42's log and CSVs match REPORT_SHA256; dispatch "
          f"{(t1 - t0) * 1e3:.1f} ms, run_batch wall {wall:.3f} s (lane 42's "
          f"CSV write {csv_ms:.1f} ms), host clock, on {card}")
    return counts


def sweep_family(device, nodes, pods, card, label, cfg, grid, seeds,
                 setting):
    """One sweep of `grid` (rows in cfg.policies order) and `seeds` through
    Simulator.run_sweep under table_residency `setting`, report off, each
    lane held to its standalone kernel run (the row baked into the
    configuration, the seed as cfg.seed). Returns the run's launch
    counts."""
    import dataclasses

    import torch

    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator

    cfg = dataclasses.replace(cfg, table_residency=setting,
                              report_per_event=False)
    sim = Simulator(nodes, cfg, device=device)
    sim.set_workload_pods(pods)
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    lanes = sim.run_sweep([list(r) for r in grid], seeds=list(seeds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    kernel = sim.last_engine
    lane_counts(f"sweep {label}/{setting}", counts, kernel)
    trace = sim.prepare_pods()
    for row, seed, lane in zip(grid, seeds, lanes):
        alone = Simulator(nodes, dataclasses.replace(
            cfg, seed=seed, policies=tuple(
                (name, int(w)) for (name, _), w in zip(cfg.policies, row))),
            device=device)
        alone.set_workload_pods(pods)
        alone.set_typical_pods()
        specs = pods_to_specs(trace, alone.node_index, device)
        evk, evp = build_events(trace)
        want = alone.run_events(alone.init_state, specs, evk, evp)
        if alone.last_residency != sim.last_residency:
            raise SmokeFailure(f"sweep {label}/{setting}: the standalone run "
                               f"ran {alone.last_residency}, the sweep "
                               f"{sim.last_residency}")
        want = type(want)(*to_cpu(tuple(want)))
        same_replay(f"sweep {label}/{setting} row {row} seed {seed}",
                    lane, want)
    print(f"sweep {label}/{setting} (B={len(lanes)}): {kernel} "
          f"({sim.last_residency}), launches {counts}; every lane equals "
          f"its standalone kernel run; run_sweep wall {wall:.3f} s (host "
          f"clock), on {card}")
    return counts


def lanes_against_plain(name: str, case, cfg, lanes):
    """Lanes kernel `name` over `lanes` from `case` = (state, types,
    typical pods, tables) against its plain version (on CPU copies for
    replay_blocked_lanes), tolerance 0 with outputs, final states, final
    tables and, blocked, summaries. The comparison's launch is not counted.
    Returns (largest error, kernel ms, plain ms, the launch's outputs)."""
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.residency import num_normalized

    state, types, tp, tables = case
    blocked = name == "replay_blocked_lanes"
    prep = (he.prepare_replay_blocked_lanes if blocked
            else fe.prepare_replay_lanes)
    plain = (he.plain_replay_blocked_lanes if blocked
             else fe.plain_replay_lanes)
    ready = prep(state, types, tp, tables, cfg, lanes)
    fe.launch(ready)  # a comparison: past the wrapper, not counted
    got, keep = tuple(ready.finish()), {}
    args = (state, types, tp, tables, cfg, lanes)
    if blocked:
        args = (to_cpu(state), to_cpu(types), to_cpu(tp), to_cpu(tables),
                cfg, [fe.Lane(*to_cpu(tuple(lane[:5])), lane.weights,
                              lane.key) for lane in lanes])
    plain_ms, want = wall_ms(lambda: plain(*args, keep=keep))
    err = max_abs_err(to_cpu(got), to_cpu(tuple(want)))
    t = ready.tensors
    summaries = ("bt", "br", "bn") + (
        ("brmin", "brmax", "slo", "shi")
        if num_normalized(cfg.policies) else ())
    for b in range(len(lanes)):
        err = max(err, max_abs_err(
            to_cpu(tuple(t[f][b] for f in ("score", "sdev", "feas"))),
            to_cpu(tuple(keep["tables"][b]))))
        if blocked:
            summ = keep["summaries"][b]
            err = max(err, max_abs_err(
                to_cpu(tuple(t[f][b] for f in summaries)),
                to_cpu(tuple(getattr(summ, f) for f in summaries))))
    timed = prep(state, types, tp, tables, cfg, lanes)
    ms = kernel_ms(timed, 3, reset_of(timed, state, tables))
    return err, ms, plain_ms, got


def sweep_plain_checks(device, card):
    """Both lanes kernels against their plain versions (lanes_against_plain)
    on a 256-node random cluster, 4 lanes (their own ranks, weights and
    keys): replay_lanes under FGD+BestFit and 01-Random (plain on the
    card), replay_blocked_lanes under FGD+BestFit; then at the main path's
    shape, openb (1213 nodes, 1280 padded for the blocked kernel) over its
    first SWEEP_PREFIX events, 2 lanes: the first and last rows of
    SWEEP_GRID through both kernels' general instantiation, and 01-Random
    under tuning seeds 42 and 43 (their own keys and ranks) through the
    randomized one. Returns {kernel: its row's numbers}."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    out = {}
    cases = (("replay_lanes", list(SWEEP_POLICIES), "FGDScore", "share"),
             ("replay_lanes", [("RandomScore", 1000)], "random", "merge"),
             ("replay_blocked_lanes", list(SWEEP_POLICIES), "FGDScore",
              "share"))
    for i, (name, policies, gpu_sel, dim_ext) in enumerate(cases):
        cfg = fe.make_config(policies, gpu_sel, dim_ext)
        state, pods, types, evk, evp, tp, rank = random_case(
            300 + i, 256, 150, device)
        blocked = name == "replay_blocked_lanes"
        if blocked:
            state, rank = pad_nodes(state, rank, 128)
        n = state.num_nodes
        gen = torch.Generator().manual_seed(i)
        lanes = [fe.Lane(pods, types.type_id, evk, evp,
                         rank if b == 0 else
                         torch.randperm(n, generator=gen).int().to(device),
                         fe.lane_weights(cfg, SWEEP_GRID[b][:len(policies)]),
                         (0, 7 + b) if cfg.randomized else None)
                 for b in range(4)]
        if blocked:
            lanes = [lane._replace(rank=torch.where(
                torch.arange(n, device=device) < 256, lane.rank,
                torch.iinfo(torch.int32).max)) for lane in lanes]
        tables = fe.init_tables(state, types, tp, cfg)
        err, ms, plain_ms, got = lanes_against_plain(
            name, (state, types, tp, tables), cfg, lanes)
        prep = (he.prepare_replay_blocked_lanes if blocked
                else fe.prepare_replay_lanes)
        bound = lanes_case_bound(prep, (state, types, tp, tables, cfg),
                                 lanes, got, pods)
        print(f"check random lanes {name} {'+'.join(p for p, _ in policies)}"
              f" nodes=256 events={evk.shape[0]} B=4: max_abs_err={err} with "
              f"final states, tables{' and summaries' if blocked else ''} "
              f"(tolerance 0); {ms:.3f} ms (plain {plain_ms:.1f} ms"
              f"{' on the CPU' if blocked else ''}), on {card}")
        if err:
            raise SmokeFailure(f"{name} disagrees with its plain version on "
                               f"the random case of {policies}")
        if name not in out:  # the row's numbers: its first case
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound[0], bound_by=bound[1],
                             case=f"random 256 nodes, {evk.shape[0]} "
                             f"events, B=4, {'+'.join(p for p, _ in policies)}")
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)

    # openb: the weight grid's lanes share the rank; the random lanes
    # differ in key and (the second) in rank
    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    ek, ep = evk[:SWEEP_PREFIX], evp[:SWEEP_PREFIX]
    other = rank[torch.randperm(state.num_nodes,
                                generator=torch.Generator().manual_seed(43))
                 .to(device)]
    grid_cfg = fe.make_config(list(SWEEP_POLICIES), "FGDScore", "share")
    random_cfg = fe.make_config(
        *dict((r[0], r) for r in METHODS)["01-Random"][1:5])
    cases = (("replay_lanes", "FGD+BestFit", grid_cfg,
              [(SWEEP_GRID[0], rank), (SWEEP_GRID[-1], rank)]),
             ("replay_lanes", "01-Random", random_cfg,
              [((1000,), rank), ((1000,), other)]),
             ("replay_blocked_lanes", "FGD+BestFit", grid_cfg,
              [(SWEEP_GRID[0], rank), (SWEEP_GRID[-1], rank)]))
    for name, label, cfg, rows in cases:
        blocked = name == "replay_blocked_lanes"
        st = pad_nodes(state, rank, 128)[0] if blocked else state
        lanes = [fe.Lane(specs, types.type_id, ek, ep,
                         pad_nodes(state, rk, 128)[1] if blocked else rk,
                         fe.lane_weights(cfg, row),
                         (0, 42 + b) if cfg.randomized else None)
                 for b, (row, rk) in enumerate(rows)]
        tables = fe.init_tables(st, types, tp, cfg)
        err, ms, plain_ms, _ = lanes_against_plain(
            name, (st, types, tp, tables), cfg, lanes)
        print(f"check openb lanes {name} {label} N={st.num_nodes} "
              f"E={SWEEP_PREFIX} B={len(lanes)} (rows "
              f"{[tuple(r) for r, _ in rows]}): "
              f"max_abs_err={err} with final states, tables"
              f"{' and summaries' if name == 'replay_blocked_lanes' else ''}"
              f" (tolerance 0); {ms:.3f} ms (plain {plain_ms:.1f} ms"
              f"{' on the CPU' if name == 'replay_blocked_lanes' else ''}), "
              f"on {card}", flush=True)
        if err:
            raise SmokeFailure(f"{name} disagrees with its plain version on "
                               f"openb under {label}")
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        out[name].setdefault("openb_prefix", {})[label] = dict(
            events=SWEEP_PREFIX, lanes=len(lanes), max_abs_err=err, ms=ms,
            plain_ms=plain_ms)
    return out


def lanes_case_bound(prep, args, lanes, got, pods):
    """lanes_bound of a lanes launch's run `got` of `lanes` over
    (state, types, typical pods, tables, cfg) = `args`: each lane's chain
    from its own refreshes (and rebuilds and unpinned creates, blocked),
    the step from an all-skip launch of one lane."""
    import torch

    from tpusim_torch.sim.residency import num_normalized

    state, types, tp, tables, cfg = args
    blocked = prep.__name__ == "prepare_replay_blocked_lanes"
    lane = lanes[0]
    skip = prep(state, types, tp, tables, cfg, [lane._replace(
        ev_kind=torch.full_like(lane.ev_kind, 2))])
    e = lane.ev_kind.shape[0]
    step = kernel_ms(skip, 3, reset_of(skip, state, tables)) / e
    kinds = lane.ev_kind.cpu().numpy()
    n, k = state.num_nodes, types.num_types
    n_pol = cfg.num_tables
    chains = []
    for out in got:
        res, stats = out if blocked else (out, None)
        refreshes = refreshes_of(res.event_node.cpu().numpy())
        if blocked:
            pinned = pods.pinned.cpu().numpy()[lane.ev_pod.cpu().numpy()]
            unpinned = int(((kinds == 0) & (pinned < 0)).sum())
            chains.append(chain_blocked_ms(
                step, kinds, unpinned, n, k, refreshes, n_pol,
                num_normalized(cfg.policies), int(stats[2])))
        else:
            chains.append(chain_ms(step, kinds, n, k, refreshes, n_pol))
    return lanes_bound(chains, len(got), (n_pol + 2) * k * n * 4)


def sweep_times(device, nodes, pods, card):
    """Both lanes kernels alone (CUDA events, median of 2 after a warm-up)
    and the whole schedule_pods_sweep call (host clock around a
    synchronise, min of 2 after a warm-up) at SWEEP_LANES lanes, report
    off, under "auto" (the flat kernel at openb) and "hbm", for 06-FGD
    (rows 1000 - i) and the FGD+BestFit grid (SWEEP_GRID, repeated past 16
    lanes), beside each lane count's bound and a standalone warm replay
    (Simulator.run_events, min of 3); the marginal cost of a lane,
    (w_B - w_1) / (B - 1), must stay within MARGINAL_BOUND of the
    standalone replay at B = 16 under "auto". Then run_batch (06-FGD,
    report off, min of 2) at 1 and 16 seeds beside a standalone warm
    run(). Returns {kernel: {label: numbers}}."""
    import dataclasses

    import torch

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import driver as drv
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.table_engine import build_pod_types

    rows = {name: {} for name in LANE_KERNELS}
    families = (("06-FGD", (("FGDScore", 1000),),
                 lambda b: [(1000 - i,) for i in range(b)]),
                ("FGD+BestFit", SWEEP_POLICIES,
                 lambda b: [SWEEP_GRID[i % len(SWEEP_GRID)]
                            for i in range(b)]))
    for label, policies, grid_of in families:
        for setting in ("auto", "hbm"):
            cfg = dataclasses.replace(
                method_config(policies, "FGDScore"), table_residency=setting,
                report_per_event=False)
            sim = drv.Simulator(nodes, cfg, device=device)
            sim.set_workload_pods(pods)
            sim.set_typical_pods()
            trace = sim.prepare_pods()
            specs = pods_to_specs(trace, sim.node_index, device)
            evk_h, evp_h = build_events(trace)
            sim.run_events(sim.init_state, specs, evk_h, evp_h)
            standalone = min(wall_ms(lambda: sim.run_events(
                sim.init_state, specs, evk_h, evp_h))[0] for _ in range(3))
            blocked = sim.last_residency == "hbm"
            name = "replay_blocked_lanes" if blocked else "replay_lanes"
            rc = sim._replay.config
            types = build_pod_types(specs)
            evk, evp = (torch.as_tensor(a, device=device)
                        for a in (evk_h, evp_h))
            state, rank = sim.init_state, sim.rank
            if blocked:
                state, rank = pad_nodes(state, rank, 128)
            tables = fe.init_tables(state, types, sim.typical, rc)
            prep = (he.prepare_replay_blocked_lanes if blocked
                    else fe.prepare_replay_lanes)
            walls = {}
            for b in SWEEP_LANES:
                grid = grid_of(b)
                lanes = [fe.Lane(specs, types.type_id, evk, evp, rank,
                                 fe.lane_weights(rc, row)) for row in grid]
                ready = prep(state, types, sim.typical, tables, rc, lanes)
                ms = kernel_ms(ready, 2, reset_of(ready, state, tables))
                bound = lanes_case_bound(prep, (state, types, sim.typical,
                                                tables, rc), lanes,
                                         ready.finish(), specs)
                del ready
                drv.schedule_pods_sweep(sim, trace, grid)
                walls[b] = min(wall_ms(lambda: drv.schedule_pods_sweep(
                    sim, trace, grid))[0] for _ in range(2))
                marginal = ((walls[b] - walls[1]) / (b - 1) if b > 1
                            else None)
                rows[name][f"openb {label}/{setting} B={b}"] = dict(
                    ms=ms, bound_ms=bound[0], bound_by=bound[1],
                    sweep_wall_ms=walls[b], standalone_wall_ms=standalone,
                    marginal_ms=marginal)
                print(f"time sweep {label}/{setting} B={b}: {name} {ms:.3f} "
                      f"ms alone (bound {bound[0]:.3f} ms by {bound[1]}), "
                      f"schedule_pods_sweep {walls[b]:.2f} ms"
                      + (f", marginal {marginal:.3f} ms a lane = "
                         f"{marginal / standalone:.4f} of the standalone "
                         f"warm replay {standalone:.2f} ms"
                         if marginal is not None else
                         f" (standalone warm replay {standalone:.2f} ms)")
                      + f", on {card}", flush=True)
                if b == 16 and setting == "auto" and \
                        marginal > MARGINAL_BOUND * standalone:
                    raise SmokeFailure(
                        f"sweep {label}: a lane's marginal cost at B=16 is "
                        f"{marginal:.3f} ms, more than {MARGINAL_BOUND} of "
                        f"the standalone warm replay's {standalone:.3f} ms")

    row = dict((r[0], r) for r in METHODS)["06-FGD"]
    batch = {}
    for b in (1, 16):
        sims = []
        for seed in SWEEP_SEEDS[:b]:
            sim = drv.Simulator(nodes, dataclasses.replace(
                method_config(*row[1:5], tune_seed=seed),
                report_per_event=False), device=device)
            sim.set_workload_pods(pods)
            sims.append(sim)
        drv.run_batch(sims)
        batch[b] = min(wall_ms(lambda: drv.run_batch(sims))[0]
                       for _ in range(2))
    alone = sims[0]
    alone.run()
    run_ms = min(wall_ms(alone.run)[0] for _ in range(2))
    print(f"time run_batch 06-FGD (report off): 1 seed {batch[1]:.1f} ms, "
          f"16 seeds {batch[16]:.1f} ms, marginal "
          f"{(batch[16] - batch[1]) / 15:.2f} ms a seed, against a "
          f"standalone warm run() {run_ms:.1f} ms (host clock), on {card}",
          flush=True)
    rows["replay_lanes"]["run_batch 06-FGD"] = dict(
        wall_1_ms=batch[1], wall_16_ms=batch[16],
        marginal_ms=(batch[16] - batch[1]) / 15, standalone_run_ms=run_ms)
    return rows


def sweep_cli(device, card):
    """`python -m tpusim_torch.sweep --methods 06-FGD --seeds 4` (in this
    process) against the same 4 experiments run one by one
    (tpusim_torch.experiment.run_experiment): each directory's simon.log
    and CSVs must agree, and seed 42's must match REPORT_SHA256. Returns
    (the sweep's wall, the standalone experiments' wall), host seconds."""
    import contextlib
    import io
    import tempfile

    from tpusim_torch import experiment
    from tpusim_torch import sweep as sweep_cli_mod

    with tempfile.TemporaryDirectory() as root:
        flags = ["--methods", "06-FGD", "--seeds", str(len(SWEEP_CLI_SEEDS)),
                 "--traces", "openb_pod_list_default", "--device",
                 device.type]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            sweep_cli_mod.main(["--out-root", f"{root}/sweep"] + flags)
        batched = time.perf_counter() - t0
        method = dict((m[0], m) for m in sweep_cli_mod.METHODS)["06-FGD"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            for seed in SWEEP_CLI_SEEDS:
                argv = sweep_cli_mod.experiment_argv(
                    f"{root}/alone", "openb_pod_list_default", method, 1.3,
                    seed, False, device.type)[0]
                experiment.run_experiment(experiment.get_args(argv))
        alone = time.perf_counter() - t0
        for seed in SWEEP_CLI_SEEDS:
            a, b = (report_digest(f"{root}/{kind}/openb_pod_list_default/"
                                  f"06-FGD/1.3/{seed}")
                    for kind in ("sweep", "alone"))
            if a != b:
                raise SmokeFailure(f"tpusim_torch.sweep seed {seed}: the "
                                   "files differ from the standalone "
                                   "experiment's")
            if seed == 42 and a != SWEEP_CLI_SHA256:
                raise SmokeFailure(f"tpusim_torch.sweep seed 42: the files "
                                   f"differ from experiments/run.py's: "
                                   f"{report_digests(f'{root}/sweep/openb_pod_list_default/06-FGD/1.3/42')}")
    print(f"time python -m tpusim_torch.sweep --methods 06-FGD --seeds "
          f"{len(SWEEP_CLI_SEEDS)}: {batched:.2f} s against {alone:.2f} s "
          f"for the {len(SWEEP_CLI_SEEDS)} experiments one by one "
          f"({alone / batched:.2f}x), every directory's log and CSVs "
          f"equal, seed 42's match SWEEP_CLI_SHA256 (host clock), on {card}",
          flush=True)
    return batched, alone


def sweep_path(device, card: str):
    """Phase 8: the lanes kernels' paths (module docstring). Returns
    ({run label: launch counts}, {lanes kernel: its row's numbers, with
    "configs"})."""
    from tpusim_torch.__main__ import method_config
    from tpusim_torch.io.trace import load_node_csv, load_pod_csv

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    nodes = load_node_csv(os.path.join(data, "openb_node_list_gpu_node.csv"))
    pods = load_pod_csv(os.path.join(data, "openb_pod_list_default.csv"))
    launches = {"sweep seed batch": sweep_seed_batch(device, nodes, pods,
                                                     card)}
    grid_cfg = method_config(SWEEP_POLICIES, "FGDScore")
    random_row = dict((r[0], r) for r in METHODS)["01-Random"]
    for setting in ("auto", "hbm"):
        launches[f"sweep FGD+BestFit/{setting}"] = sweep_family(
            device, nodes, pods, card, "FGD+BestFit", grid_cfg, SWEEP_GRID,
            [grid_cfg.seed] * len(SWEEP_GRID), setting)
    launches["sweep 01-Random"] = sweep_family(
        device, nodes, pods, card, "01-Random",
        method_config(*random_row[1:5]), [(1000,)] * len(SWEEP_SEEDS),
        SWEEP_SEEDS, "auto")
    rows = sweep_plain_checks(device, card)
    configs = sweep_times(device, nodes, pods, card)
    for name in LANE_KERNELS:
        rows[name]["configs"] = configs[name]
    batched, alone = sweep_cli(device, card)
    rows["replay_lanes"]["configs"]["python -m tpusim_torch.sweep"] = dict(
        methods="06-FGD", seeds=len(SWEEP_CLI_SEEDS), wall_s=batched,
        standalone_wall_s=alone)
    return launches, rows


# The evict phase: descheduling through `python -m tpusim_torch`'s path
# and the fault host loop, on openb. DESCHED_CASES: (deschedule policy,
# workload inflation ratio), each an experiment with `-d DIR`,
# DESCHED_FLAGS and `-p POLICY` (and the ratio when it is above 1).
# FAULT_FLAGS: the README's schedule (apply's --fault-mtbf 500
# --fault-mttr 800 --fault-evict-every 1000 --fault-seed 7
# --fault-max-retries 3), replayed by Simulator.run_with_faults under each
# FAULT_ROWS method row (tune 1.3, tuning seed 42, seed 42, shuffled,
# per-event reports on). DESCHED_SHA256 and FAULT_SHA256 are the digests
# of the JAX package's runs of the same on the CPU (experiments/run.py's
# run_experiment stages; Simulator.run_with_faults under its default
# fault_mode, then finish() and experiments/analysis.py analyze_sim with
# row_meta): result_digests of the final result, the experiment's
# report_digest and, for a fault run, disruption_digest.
# APPLY_FAULT_SHA256: sha256 of the standard output, without its [Engine]
# lines, of `python -m tpusim apply` with APPLY_FAULT_ARGS (the README's
# fault command). tests/test_torch_deschedule.py and
# tests/test_torch_faults.py pin them against tpusim (slow-marked).
DESCHED_FLAGS = ("-FGD", "1000", "-gpusel", "FGDScore", "-tune", "1.3",
                 "-tuneseed", "42", "--shuffle-pod", "true", "-r", "0.1")
DESCHED_CASES = (("cosSim", 1.0), ("fragOnePod", 1.0), ("fragMultiPod", 1.0),
                 ("fragOnePod", 1.1))
DESCHED_SHA256 = {
    "cosSim": {
        "placed":
            "4dfa90febc8239e3d74af19cdfeafbaabd2767a4a055bbee8babd6dea3384dd1",
        "dev_mask":
            "3ae56752136b340114b95872f8c729f7748b447aa8cfdd6ae5c37150a1e7a678",
        "creation_rank":
            "ff2322e06ca9a140a718fd73b100345f6ff954ed9bfcbf72cba137fe8aaf67ac",
        "unscheduled":
            "a992cb13ddac26665099de049f3f023300d7a70e9c6591e11d62ffd3c64d1553",
        "report":
            "bc2934388186b2d00c9057ad4f2261b99fd6fbe2ca68126d88d16cd8e895940d",
    },
    "fragOnePod": {
        "placed":
            "6eb6f3a11f7cc208fd114cc7465d436758a725fe67d4b1537ecbd8811466ebbd",
        "dev_mask":
            "0a60dbbe7dbda7d0877732992b610c394119f331c7edd26c1cd38f2060ec79ae",
        "creation_rank":
            "e4302724f7f9356a826914e64af210ae5946da2621a146c3aac37abf420bb277",
        "unscheduled":
            "380736e224d13b6dad42a1cca4b388ce41029b3813bfe614828f4d574d74bf8e",
        "report":
            "f08251e8dde8279c26c646bb83f29a04145ab4e2af8a2a0803bd9575d36cac7f",
    },
    "fragMultiPod": {
        "placed":
            "6eb6f3a11f7cc208fd114cc7465d436758a725fe67d4b1537ecbd8811466ebbd",
        "dev_mask":
            "0a60dbbe7dbda7d0877732992b610c394119f331c7edd26c1cd38f2060ec79ae",
        "creation_rank":
            "e4302724f7f9356a826914e64af210ae5946da2621a146c3aac37abf420bb277",
        "unscheduled":
            "380736e224d13b6dad42a1cca4b388ce41029b3813bfe614828f4d574d74bf8e",
        "report":
            "25b5a3c1bd47661befe16fd784ba511987af46adc04382a2d79fafe461ec93c8",
    },
    "fragOnePod+inflation1.1": {
        "placed":
            "6eb6f3a11f7cc208fd114cc7465d436758a725fe67d4b1537ecbd8811466ebbd",
        "dev_mask":
            "0a60dbbe7dbda7d0877732992b610c394119f331c7edd26c1cd38f2060ec79ae",
        "creation_rank":
            "e4302724f7f9356a826914e64af210ae5946da2621a146c3aac37abf420bb277",
        "unscheduled":
            "380736e224d13b6dad42a1cca4b388ce41029b3813bfe614828f4d574d74bf8e",
        "report":
            "bbc6d86fdad340be0a370a57144b3cc1fef2de803d3e340df80e69959333671a",
    },
}
FAULT_FLAGS = dict(mtbf_events=500, mttr_events=800, evict_every_events=1000,
                   seed=7, max_retries=3)
FAULT_ROWS = ("06-FGD", "01-Random")
FAULT_SHA256 = {
    "06-FGD": {
        "placed":
            "81b5dca6778e580ce155e83bf9df7ea59dfafe1e21c9a89d6aa1859da361673b",
        "dev_mask":
            "9923e24a5eceb0ed987ba1e70a81e3d1d9cb3f089e25ade49f2ff6b99fee2e9f",
        "creation_rank":
            "80a4461cfbd2f9e8d7fe661cf790a4fe7349ae54f5d735775b363bfd6ac1aa7f",
        "unscheduled":
            "cc773af87c9da70358c3c9ab7f3aa4b7ff08c240134d1dae1eb9926beb098992",
        "disruption":
            "07240ca8197716ebd8ac73ee21e960bcc091f006178aa37c88883df733a1741c",
        "report":
            "b08c2f3b9421cfb1173bad8485137465d13c6b9150bc920813c049e803369e5a",
    },
    "01-Random": {
        "placed":
            "b90bc2c39f70a11581a71612406625807d6e070c29c746f4b86564bd68a75b45",
        "dev_mask":
            "fcacc4e55a22fc7ccbf86aef41f28dc628cc8973676f84998b86ad7ab314465b",
        "creation_rank":
            "f47800ee4a64c3dd05c652979129853f0d5bcb14e6ac9c5b78c70a2a06dbac64",
        "unscheduled":
            "b5692bd168dd3522eead77da22e860b6e2a2938d2e2eaeaddec66b15daeda81c",
        "disruption":
            "90e8eef5abd04c8863313da1ec466746a68023ec927744e4bf62496e0b40a060",
        "report":
            "9aa69e10f4c24e16b39e035f3b85b69ab23ed173f741cfbb52ea5a72b6015468",
    },
}
APPLY_FAULT_ARGS = ("-f", APPLY_DEFAULT_CR, "-s", APPLY_SCHEDULER,
                    "--fault-mtbf", "500", "--fault-mttr", "800",
                    "--fault-evict-every", "1000", "--fault-seed", "7",
                    "--fault-max-retries", "3")
APPLY_FAULT_SHA256 = (
    "3a2ade9d0c2b2c248cb967368fc2fd31bd71c5628a198ad341a7a875ffe10675"
)
# The lane phase: the in-scan fault lane on the replays' fault forms.
# FAULT_SCAN_SHA256 are the digests (result_digests and disruption_digest)
# of the JAX package's lane runs of FAULT_FLAGS on openb with per-event
# reports off, each row under FAULT_SCAN_MODES' fault_mode (06-FGD's
# "auto" takes the lane there; 01-Random opts in with "scan");
# tests/test_torch_fault_lane.py pins them (slow-marked). CHAOS_FAULTS is
# the README's faults.json; CHAOS_APPLY_SHA256 the sha256 of chaos_stdout
# of `python -m tpusim apply` with CHAOS_APPLY_ARGS (the faults file at
# index 5). CHAOS_SEEDS: the fault seeds of the openb chaos sweep's lanes.
FAULT_SCAN_MODES = {"06-FGD": "auto", "01-Random": "scan"}
FAULT_SCAN_SHA256 = {
    "06-FGD": {
        "placed":
            "81b5dca6778e580ce155e83bf9df7ea59dfafe1e21c9a89d6aa1859da361673b",
        "dev_mask":
            "9923e24a5eceb0ed987ba1e70a81e3d1d9cb3f089e25ade49f2ff6b99fee2e9f",
        "creation_rank":
            "80a4461cfbd2f9e8d7fe661cf790a4fe7349ae54f5d735775b363bfd6ac1aa7f",
        "unscheduled":
            "cc773af87c9da70358c3c9ab7f3aa4b7ff08c240134d1dae1eb9926beb098992",
        "disruption":
            "07240ca8197716ebd8ac73ee21e960bcc091f006178aa37c88883df733a1741c",
    },
    "01-Random": {
        "placed":
            "c808011e45a86e746da63e2108bcee75ee5ddb86df94712ec537d15ed141b908",
        "dev_mask":
            "ac55779821f0aae1e615c8ddb0ca8634e835aec8c006b119355809b7ee238d78",
        "creation_rank":
            "1bf38c8a7bf905a9e6265c44ba21ec10d506cafe5b5e38061ac0eb3a19f72820",
        "unscheduled":
            "7892573a36f44cbb01bd8483a61864a100b857d792c38588653915514c3075a3",
        "disruption":
            "1cfcd14bdc07c38b695fd042623c9993404ca2d642e86b2a41fdb266432da446",
    },
}
CHAOS_FAULTS = {"faults": [
    {"mtbf_events": 400, "mttr_events": 700, "seed": 1},
    {"mtbf_events": 400, "mttr_events": 700, "seed": 2},
    {"mtbf_events": 150, "evict_every_events": 300, "seed": 3,
     "queue_capacity": 32},
]}
CHAOS_APPLY_ARGS = ("-f", APPLY_DEFAULT_CR, "-s", APPLY_SCHEDULER,
                    "--sweep-faults", "faults.json")
CHAOS_APPLY_SHA256 = (
    "0156298eb8268f41b55bcd75ba30cd8723b4c608d9339156ec733d24bca75643"
)
CHAOS_SEEDS = tuple(range(1, 9))


def digest_text(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def chaos_stdout(text: str) -> str:
    """An `apply --sweep-faults` standard output without its [Engine] lines
    and with the [Chaos] line cut before the engine it names (the port
    names its kernel, tpusim its compiled scan)."""
    out = []
    for line in text.splitlines(keepends=True):
        if "[Engine]" in line:
            continue
        if line.startswith("[Chaos]"):
            line = line[:line.index(" in one ")] + "\n"
        out.append(line)
    return "".join(out)


# the failed-node checks' random cluster: its nodes, its pods, and the
# rows whose configurations it runs (a quarter of its nodes down)
DOWN_CASE = (256, 600)
DOWN_ROWS = ("06-FGD", "default-profile", "05-BestFit")


def desched_label(policy: str, inflation: float) -> str:
    return policy if inflation <= 1 else f"{policy}+inflation{inflation}"


def desched_argv(exp_dir: str, policy: str, inflation: float) -> list:
    """The experiment flags of a DESCHED_CASES case (experiments/run.py's
    and python -m tpusim_torch's)."""
    argv = ["-d", exp_dir, *DESCHED_FLAGS, "-p", policy]
    if inflation > 1:
        argv += ["--workload-inflation-ratio", str(inflation)]
    return argv


def result_digests(result) -> dict:
    """sha256 of a result's placed_node (int32), dev_mask (uint8),
    creation_rank (int64) and unscheduled pods (a line each: name and
    reason)."""
    unsched = "".join(f"{u.pod.name} {u.reason}\n"
                      for u in result.unscheduled_pods)
    return {"placed": digest(result.placed_node, np.int32),
            "dev_mask": digest(result.dev_mask, np.uint8),
            "creation_rank": digest(result.creation_rank, np.int64),
            "unscheduled": hashlib.sha256(unsched.encode()).hexdigest()}


def disruption_digest(dm) -> str:
    """sha256 of a DisruptionMetrics: its summary and both of its lists, as
    sorted JSON with every float as its repr."""
    doc = dict(dm.as_dict(), latency=list(dm.reschedule_latency_events),
               frag_delta=[repr(float(x)) for x in dm.post_recovery_frag_delta])
    doc = {k: (repr(v) if isinstance(v, float) else v) for k, v in doc.items()}
    return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()


def experiment_report_digest(sim, exp_dir: str, meta: dict, analyze) -> str:
    """finish(), then simon.log and the CSVs of `analyze` (an analyze_sim)
    into exp_dir; returns their report_digest."""
    sim.finish()
    with open(os.path.join(exp_dir, "simon.log"), "w") as f:
        f.write(sim.log.dump())
    analyze(sim, exp_dir, meta)
    return report_digest(exp_dir)


def evict_counts(label: str, counts: dict, want: int, tier: str) -> None:
    """The run launched init_tables and its residency's replay kernel
    `want` times each, and nothing else."""
    names = RESIDENCY_KERNELS[tier]
    expect = {name: (want if name in names else 0) for name in counts}
    if counts != expect:
        raise SmokeFailure(f"{label}: launches {counts}, want {expect}")


def evict_deschedule(device, card: str) -> dict:
    """The descheduler through run_experiment's stages (the experiment's
    Simulator, run(), then _post_run: inflation, deschedule_cluster,
    PostDeschedule, DescheduleInflation, the log and the CSVs) for each
    DESCHED_CASES case, the launch counts set to 0 before each run and
    read after it: init_tables and replay once for the main replay, once
    for the victims and once for each inflation run. The final result and
    the files are held to DESCHED_SHA256; the deschedule stage is timed.
    Returns {label: counts}."""
    import tempfile

    import torch

    from tpusim_torch import experiment
    from tpusim_torch.io.trace import pods_to_specs
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.deschedule import eviction_scores

    launches = {}
    for policy, inflation in DESCHED_CASES:
        name = desched_label(policy, inflation)
        label = f"deschedule {name}"
        stage = {}
        with tempfile.TemporaryDirectory() as d:
            args = experiment.get_args(desched_argv(d, policy, inflation))
            fe.reset_launch_counts()
            t0 = time.perf_counter()
            sim, outdir, pod_csv, policies = experiment._build_sim(args)
            sim.run()
            stage_of = sim.deschedule_cluster

            def deschedule_timed():
                before = len(sim.replay_times)
                t = time.perf_counter()
                failed = stage_of()
                torch.cuda.synchronize()
                stage["ms"] = (time.perf_counter() - t) * 1e3
                # the victims' replay, if there were victims
                stage["victims"] = (sim.replay_times[-1]
                                    if len(sim.replay_times) > before
                                    else dict(events=0, replay_ms=0.0,
                                              report_ms=0.0))
                return failed

            sim.deschedule_cluster = deschedule_timed
            experiment._post_run(sim, args, outdir, pod_csv, policies, t0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = run_counts()
            got = dict(result_digests(sim.last_result),
                       report=report_digest(d))
        vict = stage["victims"]
        evict_counts(label, counts, 1 + (vict["events"] > 0)
                     + 2 * (inflation > 1), "vmem")
        launches[label] = counts
        if got != DESCHED_SHA256[name]:
            raise SmokeFailure(f"{label}: differs from the JAX reference: "
                               f"{got}")
        res = sim.last_result
        specs = pods_to_specs(res.pods, None, device)
        state = sim._placed_state()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eviction_scores(state, specs, res.placed_node, res.dev_mask,
                        sim.typical)
        end.record()
        torch.cuda.synchronize()
        print(f"evict {label}: {vict['events']} victims, launches {counts}; "
              f"deschedule_cluster {stage['ms']:.1f} ms, of which the "
              f"victims' replay {vict['replay_ms']:.2f} ms and its report "
              f"tail {vict['report_ms']:.2f} ms (host clock), "
              f"eviction_scores {start.elapsed_time(end):.3f} ms (card, "
              f"CUDA events, on the final state of {len(res.pods)} pods); "
              f"experiment {wall:.2f} s (host clock); placements, masks, "
              f"ranks, unscheduled pods, log and CSVs match the JAX "
              f"reference on {card}")
    return launches


def evict_faults(device, card: str):
    """Simulator.run_with_faults with FAULT_FLAGS for each FAULT_ROWS row,
    06-FGD under table_residency "auto" and "hbm", the launch counts set
    to 0 before each run and read after it (init_tables and the residency's
    replay kernel once a segment); results, disruption metrics, log and
    CSVs held to FAULT_SHA256. Returns ({label: counts}, the first segment
    of the 06-FGD run that starts with a node down: (state, ev_kind,
    ev_pod), its Simulator)."""
    import dataclasses
    import tempfile

    import torch

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.analysis import analyze_sim
    from tpusim_torch.io.trace import load_node_csv, load_pod_csv
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator
    from tpusim_torch.sim.faults import FaultConfig

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    nodes = load_node_csv(os.path.join(data, "openb_node_list_gpu_node.csv"))
    pods = load_pod_csv(os.path.join(data, "openb_pod_list_default.csv"))
    rows = dict((r[0], r) for r in METHODS)
    launches, captured = {}, {}
    for mid, setting in (("06-FGD", "auto"), ("06-FGD", "hbm"),
                         ("01-Random", "auto")):
        label = f"faults {mid}" + ("/hbm" if setting == "hbm" else "")
        policies, gpu_sel, dim_ext, norm = rows[mid][1:5]
        tier = "hbm" if setting == "hbm" and mid not in RANDOMIZED_ROWS \
            else "vmem"
        cfg = dataclasses.replace(
            method_config(policies, gpu_sel, dim_ext, norm),
            table_residency=setting)
        sim = Simulator(nodes, cfg, device=device)
        sim.set_workload_pods(pods)
        if label == "faults 06-FGD":
            run_events = sim.run_events
            captured["sim"] = sim

            def capture(state, specs, ev_kind, ev_pod, **kw):
                if "state" not in captured and \
                        bool((state.mem_left < 0).any()):
                    captured.update(state=state, ev_kind=ev_kind,
                                    ev_pod=ev_pod, specs=specs)
                return run_events(state, specs, ev_kind, ev_pod, **kw)

            sim.run_events = capture
        fe.reset_launch_counts()
        t0 = time.perf_counter()
        res = sim.run_with_faults(FaultConfig(**FAULT_FLAGS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = run_counts()
        segments = len(sim.replay_times)
        evict_counts(label, counts, segments, tier)
        launches[label] = counts
        with tempfile.TemporaryDirectory() as d:
            got = dict(result_digests(res),
                       disruption=disruption_digest(sim.last_disruption),
                       report=experiment_report_digest(
                           sim, d, row_meta(policies, gpu_sel, dim_ext),
                           analyze_sim))
        if got != FAULT_SHA256[mid]:
            raise SmokeFailure(f"{label}: differs from the JAX reference: "
                               f"{got}")
        replay_ms = sum(t["replay_ms"] for t in sim.replay_times)
        report_ms = sum(t["report_ms"] for t in sim.replay_times)
        dm = sim.last_disruption
        print(f"evict {label}: {segments} segments over {res.events} events "
              f"({sim.last_engine}, {sim.last_residency}), launches "
              f"{counts}; node failures {dm.node_failures}, recoveries "
              f"{dm.node_recoveries}, evicted {dm.evicted_pods}, "
              f"rescheduled {dm.rescheduled_pods}, unscheduled after "
              f"retries {dm.unscheduled_after_retries}; run_with_faults "
              f"{wall:.2f} s, of which the segments' replays "
              f"{replay_ms:.1f} ms and their report tails {report_ms:.1f} "
              f"ms (host clock); placements, masks, ranks, unscheduled "
              f"pods, disruption metrics, log and CSVs match the JAX "
              f"reference on {card}")
    if "state" not in captured:
        raise SmokeFailure("the 06-FGD fault run had no segment after a "
                           "node failure")
    return launches, captured


def evict_apply(device, card: str) -> dict:
    """`python -m tpusim_torch.cli apply` with APPLY_FAULT_ARGS through the
    CLI's option parsing, the launch counts set to 0 before and read after
    (init_tables and replay once a segment); the standard output held to
    APPLY_FAULT_SHA256. Returns the counts."""
    import contextlib
    import io

    import torch

    from tpusim_torch.apply import Applier
    from tpusim_torch.cli import apply_options, build_parser
    from tpusim_torch.sim import fused_engine as fe

    root = os.path.dirname(os.path.abspath(__file__))
    argv = ["apply", *APPLY_FAULT_ARGS, "--base-dir", root]
    argv[2] = os.path.join(root, argv[2])
    argv[4] = os.path.join(root, argv[4])
    applier = Applier(apply_options(build_parser().parse_args(argv)))
    buf = io.StringIO()
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        applier.run(out=buf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    segments = len(applier.sim.replay_times)
    evict_counts("apply with faults", counts, segments, "vmem")
    got = apply_digests(buf.getvalue(), root)["stdout"]
    if got != APPLY_FAULT_SHA256:
        raise SmokeFailure(f"apply with faults: stdout sha256 {got}")
    print(f"evict apply {' '.join(APPLY_FAULT_ARGS)}: launches {counts} "
          f"over {segments} segments, stdout "
          f"({buf.getvalue().count(chr(10))} lines) matches the JAX "
          f"reference; {wall * 1e3:.1f} ms (host clock) on {card}")
    return counts


def down_checks(label: str, args, cfg, blocked: bool) -> dict:
    """init_tables, replay and (unless `blocked` is False) replay_blocked
    against their plain versions on args = (state, pods, types, ev_kind,
    ev_pod, typical pods, rank), tolerance 0 with final states, tables and
    summaries. Returns each kernel's error."""
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe

    state, pods, types, evk, evp, tp, rank = args
    errs = {"init_tables": 0}
    cases = [("replay", state, rank)]
    if blocked:
        cases.append(("replay_blocked", *pad_nodes(state, rank, 128)))
    for name, st, rk in cases:
        prep = fe.prepare_init_tables(st, types, tp, cfg)
        fe.launch(prep)  # a comparison: past the wrapper, not counted
        tables = prep.finish()
        errs["init_tables"] = max(errs["init_tables"], max_abs_err(
            tables, fe.plain_init_tables(st, types, tp, cfg)))
        errs[name] = against_plain(
            name, (st, pods, types, evk, evp, tp, rk, tables), cfg,
            plain_on_cpu=True)
    down = int((state.mem_left < 0).sum())
    print(f"evict check {label}: {down} of {state.num_nodes} nodes down, "
          f"events={evk.shape[0]}: max_abs_err "
          + " ".join(f"{k}={v}" for k, v in errs.items())
          + " with final states, tables and summaries (tolerance 0)")
    if any(errs.values()):
        raise SmokeFailure(f"a kernel disagrees with its plain version on "
                           f"the failed-node case {label}")
    return errs


def evict_kernel_checks(device, captured) -> dict:
    """Each kernel against its plain version on clusters with nodes down:
    the 06-FGD fault run's first segment after a node failure, from its
    start state, and a DOWN_CASE random cluster with a quarter of its
    nodes failed under each DOWN_ROWS configuration (replay_blocked for
    those that do not draw per event). Returns each kernel's largest
    error."""
    import torch

    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.faults import fail_node
    from tpusim_torch.sim.table_engine import build_pod_types

    rows = dict((r[0], r) for r in METHODS)
    worst = dict.fromkeys(("init_tables", "replay", "replay_blocked"), 0)
    sim = captured["sim"]
    specs = captured["specs"]
    args = (captured["state"], specs, build_pod_types(specs),
            torch.as_tensor(captured["ev_kind"], device=device),
            torch.as_tensor(captured["ev_pod"], device=device), sim.typical,
            sim.rank)
    cfgs = [("06-FGD fault segment", sim._replay.config, args, True)]
    n, p = DOWN_CASE
    state, pods, types, evk, evp, tp, rank = random_case(77, n, p, device)
    down = np.random.default_rng(77).choice(n, n // 4, replace=False)
    for node in down.tolist():
        state = fail_node(state, node)
    for mid in DOWN_ROWS:
        cfg = fe.make_config(*rows[mid][1:5])
        cfgs.append((f"{mid} random {n} nodes", cfg,
                     (state, pods, types, evk, evp, tp, rank),
                     mid not in RANDOMIZED_ROWS))
    for label, cfg, case, blocked in cfgs:
        for name, err in down_checks(label, case, cfg, blocked).items():
            worst[name] = max(worst[name], err)
    return worst


def evict_path(device, card: str):
    """Phase 9: the descheduler and the fault host loop on their paths,
    then the kernels on failed-node states (module docstring). Returns
    ({run label: launch counts}, {kernel: largest error})."""
    launches = evict_deschedule(device, card)
    counts, captured = evict_faults(device, card)
    launches.update(counts)
    launches["apply with faults"] = evict_apply(device, card)
    return launches, evict_kernel_checks(device, captured)


# The lane phase: the in-scan fault lane on the replays' fault forms
# (replay_faults.cu, replay_blocked_faults.cu). LANE_PREFIX: the steps of
# the openb merged stream (FAULT_FLAGS under 06-FGD) the kernel checks
# take; LANE_CASE / LANE_CASE_FLAGS: the random cluster's nodes and pods
# and its schedule (dense enough that failures, recoveries, evictions,
# overflowing retries and flush rounds all occur in ~1k steps); LANE_ROWS
# its configurations (the profile flat only: it draws per event).
LANE_PREFIX = 2_000
LANE_CASE = (256, 300)
LANE_CASE_FLAGS = dict(mtbf_events=80, mttr_events=150,
                       evict_every_events=30, max_retries=2,
                       queue_capacity=16)
LANE_ROWS = ("06-FGD", "05-BestFit", "default-profile")
FAULT_KERNELS = ("replay_faults", "replay_blocked_faults",
                 "replay_lanes_faults", "replay_blocked_lanes_faults")
FAULT_SOURCES = {
    "replay_faults": "tpusim_torch/kernels/replay_faults.cu",
    "replay_lanes_faults": "tpusim_torch/kernels/replay_faults.cu",
    "replay_blocked_faults": "tpusim_torch/kernels/replay_blocked_faults.cu",
    "replay_blocked_lanes_faults":
        "tpusim_torch/kernels/replay_blocked_faults.cu",
}


def cut_plan(plan, steps: int):
    """The first `steps` steps of a plan's merged stream, as a plan."""
    from tpusim_torch.sim.engine import EV_NODE_RECOVER

    cut = {f: getattr(plan, f)[:steps] for f in ("kind", "idx", "pos", "arg",
                                                 "aux")}
    return plan._replace(**cut, has_recover=bool(
        (cut["kind"] == EV_NODE_RECOVER).any()))


def float_bits(x):
    """A result with its float32 tensors as their int32 bits (max_abs_err
    then compares them bit for bit)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    if isinstance(x, tuple):
        parts = [float_bits(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def fault_reset(ready, state, tables, lane):
    """reset_of's, and the fault form's carry, outputs and snapshots back to
    `lane`'s initial values."""
    base = reset_of(ready, state, tables)
    t = ready.tensors
    c = lane.carry

    def reset():
        base()
        for name in ("q_ready", "q_seq", "q_pod", "q_att", "q_era"):
            t[name].copy_(getattr(c, name))
        for name in ("attempts", "evicted_at", "down_at", "dctr"):
            t[f"f_{name}"].copy_(getattr(c, name))
        t["f_dead"].copy_(c.dead.int())
        t["f_seq"].fill_(int(c.seq))
        for name in ("rpod", "lat", "vpod", "vnode"):
            t[f"y_{name}"].fill_(-1)
        t["y_nvict"].zero_()
        t["y_rec"].zero_()
        t["snap_node"].fill_(-1)
    return reset


def fault_against_plain(name: str, case, cfg, plan, key=CHECK_KEY,
                        repeats: int = 3):
    """Fault form `name` ("replay_faults" or "replay_blocked_faults") on
    `case` = (state, pods, types, typical pods, rank, tables) over `plan`'s
    merged stream, launched past its wrapper (a comparison: not counted),
    against its plain version on CPU copies, tolerance 0: outputs, the
    steps' outputs (the recover frags bit for bit), the final carry,
    tables and, blocked, summaries and stats. Returns (error, kernel ms
    (median of `repeats`, state restored), plain ms, the launch's
    result, (the plain result, what the plain version kept))."""
    import torch

    from tpusim_torch.sim import fault_lane as fl
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.residency import num_normalized

    state, pods, types, tp, rank, tables = case
    dev = state.cpu_left.device
    blocked = name == "replay_blocked_faults"
    lane = fl.lane_of(plan, state, int(pods.cpu.shape[0]))
    kinds = torch.as_tensor(plan.kind, device=dev)
    idx = torch.as_tensor(plan.idx, device=dev)
    prep = he.prepare_replay_blocked_faults if blocked \
        else fe.prepare_replay_faults
    plain = he.plain_replay_blocked if blocked else fe.plain_replay
    kw = {} if blocked else dict(key=key)
    args = (state, pods, types, kinds, idx, tp, rank, tables, cfg, lane)
    ready = prep(*args, **kw)
    fe.launch(ready)
    got, keep = ready.finish(), {}
    cpu = to_cpu(args[:-2])
    plain_ms, want = wall_ms(lambda: plain(*cpu, cfg, keep=keep,
                                           faults=to_cpu(lane), **kw))
    err = max_abs_err(float_bits(to_cpu(got)), float_bits(want))
    t = ready.tensors
    err = max(err, max_abs_err(
        to_cpu(tuple(t[f] for f in ("score", "sdev", "feas"))),
        keep["tables"]))
    if blocked:
        names = ("bt", "br", "bn") + (("brmin", "brmax", "slo", "shi")
                                      if num_normalized(cfg.policies) else ())
        err = max(err, max_abs_err(
            to_cpu(tuple(t[f] for f in names)),
            tuple(getattr(keep["summaries"], f) for f in names)))
    timed = prep(*args, **kw)
    ms = kernel_ms(timed, repeats, fault_reset(timed, state, tables, lane))
    return err, ms, plain_ms, got, (want, keep)


def fault_lanes_reset(ready, state, tables, lanes):
    """fault_reset for a lanes launch, lane by lane: each lane's tensors
    (its views of the lanes' state, tables and outputs, and its fault
    operands) back to their initial values."""
    resets = [fault_reset(ready._replace(tensors=t), state, tables,
                          lane.faults)
              for t, lane in zip(ready.tensors["lanes"], lanes)]

    def reset():
        for r in resets:
            r()
    return reset


def fault_lanes_against_plain(name: str, case, cfg, lanes, wants=None,
                              first=None):
    """Lanes fault form `name` over `lanes` (fused_engine.Lane with their
    faults) from `case` = (state, types, typical pods, tables), launched
    past its wrapper, against its plain version on CPU copies, tolerance 0
    as fault_against_plain: outputs and each lane's final tables (and
    summaries, blocked). `wants`, where given, are the lanes' results
    already held to the plain version (lanes with equal inputs); `first`,
    where given, is fault_against_plain's (plain result, kept) of inputs
    equal to lane 0's, which the plain version then does not run again.
    Returns (error, plain ms, the launch's results)."""
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.residency import num_normalized

    state, types, tp, tables = case
    blocked = name == "replay_blocked_lanes_faults"
    prep = he.prepare_replay_blocked_lanes_faults if blocked \
        else fe.prepare_replay_lanes_faults
    plain = he.plain_replay_blocked_lanes if blocked \
        else fe.plain_replay_lanes
    ready = prep(state, types, tp, tables, cfg, lanes)
    fe.launch(ready)
    got = tuple(ready.finish())
    if wants is not None:
        return (max_abs_err(float_bits(to_cpu(got)), float_bits(tuple(wants))),
                0.0, got)
    rest = lanes[1:] if first else lanes
    keep = {}
    plain_ms, wants = wall_ms(lambda: plain(
        to_cpu(state), to_cpu(types), to_cpu(tp), to_cpu(tables), cfg,
        [to_cpu(lane) for lane in rest], keep=keep))
    kept = [dict(tables=t) for t in keep["tables"]]
    if blocked:
        for k, summ in zip(kept, keep["summaries"]):
            k["summaries"] = summ
    if first:
        wants, kept = [first[0]] + list(wants), [first[1]] + kept
    err = max_abs_err(float_bits(to_cpu(got)), float_bits(tuple(wants)))
    t = ready.tensors
    names = ("bt", "br", "bn") + (("brmin", "brmax", "slo", "shi")
                                  if num_normalized(cfg.policies) else ())
    for b, k in enumerate(kept):
        err = max(err, max_abs_err(to_cpu(tuple(
            t[f][b] for f in ("score", "sdev", "feas"))),
            tuple(k["tables"])))
        if blocked:
            err = max(err, max_abs_err(
                to_cpu(tuple(t[f][b] for f in names)),
                tuple(getattr(k["summaries"], f) for f in names)))
    return err, plain_ms, got


def fault_chain(name, case, cfg, plan, got, step_ms: float):
    """(bound ms, what bounds it) of a fault form's run `got` over `plan`:
    the merged stream's serial chain, each step at least `step_ms` (this
    run's all-skip replay per event) plus its bytes, as chain_ms and
    chain_blocked_ms count them, with the creates the retry slots ran,
    and beside them each retry slot's scan of the queue (its ready, seq,
    pod and era) and each fault step's two passes over the pods'
    placements."""
    import torch

    from tpusim_torch.sim.engine import EV_CREATE, EV_RETRY, EV_SKIP
    from tpusim_torch.sim.residency import num_normalized

    state, pods, types, tp, rank, tables = case
    result, fout = (got[0], got[-1])
    ys = fout.ys
    rpod = ys.rpod.cpu().numpy()
    kinds = plan.kind.copy()
    kinds[(kinds == EV_RETRY) & (rpod >= 0)] = EV_CREATE
    kinds[kinds > EV_SKIP] = EV_SKIP
    n, k, p = state.num_nodes, types.num_types, int(pods.cpu.shape[0])
    refreshes = refreshes_of(result.event_node.cpu().numpy())
    n_pol = cfg.num_tables
    if name == "replay_blocked_faults":
        pinned = pods.pinned.cpu().numpy()
        idx = np.where(rpod >= 0, rpod, plan.idx)
        unpinned = int(((kinds == EV_CREATE) & (pinned[idx] < 0)).sum())
        chain = chain_blocked_ms(step_ms, kinds, unpinned, n, k, refreshes,
                                 n_pol, num_normalized(cfg.policies),
                                 int(got[1][2]))
    else:
        chain = chain_ms(step_ms, kinds, n, k, refreshes, n_pol)
    slots = int((plan.kind == EV_RETRY).sum())
    faults = int((plan.kind > EV_SKIP).sum()) - slots
    extra = slots * 4 * 4 * plan.capacity + faults * 2 * 4 * p
    return chain + extra / PEAK_BYTES_PER_S * 1e3, "operations"


def skip_step_ms(name: str, case, cfg, e: int) -> float:
    """Per-event milliseconds of an all-skip replay (replay or
    replay_blocked, by the fault form's name) of `e` events on `case`."""
    import torch

    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    state, pods, types, tp, rank, tables = case
    dev = state.cpu_left.device
    skips = torch.full((e,), 2, dtype=torch.int32, device=dev)
    zeros = torch.zeros((e,), dtype=torch.int32, device=dev)
    if name.startswith("replay_blocked"):
        ready = he.prepare_replay_blocked(state, pods, types, skips, zeros,
                                          tp, rank, tables, cfg)
    else:
        ready = fe.prepare_replay(state, pods, types, skips, zeros, tp, rank,
                                  tables, cfg, key=CHECK_KEY)
    return kernel_ms(ready, 3, reset_of(ready, state, tables)) / e


def lane_tables(state, types, tp, cfg):
    """init_tables past its wrapper (a comparison: not counted)."""
    from tpusim_torch.sim import fused_engine as fe

    prep = fe.prepare_init_tables(state, types, tp, cfg)
    fe.launch(prep)
    return prep.finish()


def lane_kernel_checks(device, card: str):
    """Each fault form against its plain version (CPU copies), tolerance 0
    with outputs, the steps' outputs, the final carry, tables and
    summaries: on the openb merged stream's first LANE_PREFIX steps
    (FAULT_FLAGS under 06-FGD), one launch and 4 lanes of it; then on a
    LANE_CASE random cluster with the LANE_CASE_FLAGS schedule under each
    LANE_ROWS row (replay_blocked* for those that draw nothing per event),
    one launch and 4 lanes of their own schedules, ranks and keys. Times
    each kernel beside its plain version and bound. Returns ({kernel: its
    row's numbers}, the openb plan and its compile's host ms)."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes, pad_rank
    from tpusim_torch.sim import fault_lane as fl
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.faults import FaultConfig, generate_fault_schedule

    rows = dict((r[0], r) for r in METHODS)
    out = {}

    def note(name, err, ms, plain_ms, bound, label):
        row = out.setdefault(name, dict(max_abs_err=0, cases={}))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["cases"][label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        if bound is not None and "ms" not in row:  # the row's numbers
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                       bound_by=bound[1], case=label)
        if err:
            raise SmokeFailure(f"{name} disagrees with its plain version on "
                               f"{label}")

    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    n, p = state.num_nodes, int(specs.cpu.shape[0])
    fcfg = FaultConfig(**FAULT_FLAGS)
    t0 = time.perf_counter()
    plan = fl.compile_fault_plan(evk.cpu().numpy(), evp.cpu().numpy(),
                                 generate_fault_schedule(n, evk.shape[0],
                                                         fcfg),
                                 fcfg, n, p)
    plan_ms = (time.perf_counter() - t0) * 1e3
    cut = cut_plan(plan, LANE_PREFIX)
    cfg = fe.make_config(*rows["06-FGD"][1:5])
    for name, lanes_name in (("replay_faults", "replay_lanes_faults"),
                             ("replay_blocked_faults",
                              "replay_blocked_lanes_faults")):
        st, rk = (pad_nodes(state, rank, 128)
                  if name == "replay_blocked_faults" else (state, rank))
        tables = lane_tables(st, types, tp, cfg)
        case = (st, specs, types, tp, rk, tables)
        err, ms, plain_ms, got, _ = fault_against_plain(name, case, cfg,
                                                        cut)
        bound = fault_chain(name, case, cfg, cut, got,
                            skip_step_ms(name, case, cfg, LANE_PREFIX))
        label = f"openb 06-FGD first {LANE_PREFIX} steps"
        note(name, err, ms, plain_ms, bound, label)
        print(f"lane check {name} {label} N={st.num_nodes} (steps by kind "
              f"{np.bincount(cut.kind, minlength=7).tolist()}): "
              f"max_abs_err={err} with the steps' outputs, carry, tables"
              f"{' and summaries' if 'blocked' in name else ''} (tolerance "
              f"0); {ms:.3f} ms, plain {plain_ms:.1f} ms on the CPU, bound "
              f"{bound[0]:.3f} ms; on {card}", flush=True)
        # 4 lanes of the same inputs, each held to the single launch (held
        # to the plain version above)
        lane = fe.Lane(specs, types.type_id,
                       torch.as_tensor(cut.kind, device=device),
                       torch.as_tensor(cut.idx, device=device), rk,
                       cfg.weights, None,
                       fl.lane_of(cut, st, p))
        lerr, _, _ = fault_lanes_against_plain(
            lanes_name, (st, types, tp, tables), cfg, [lane] * 4,
            wants=[to_cpu(got)] * 4)
        note(lanes_name, lerr, None, None, None, label + ", 4 equal lanes")
        print(f"lane check {lanes_name} {label}, 4 equal lanes: "
              f"max_abs_err={lerr} against the checked launch (tolerance 0)",
              flush=True)

    nn, pp = LANE_CASE
    base = random_case(91, nn, pp, device)
    for mid in LANE_ROWS:
        cfg = fe.make_config(*rows[mid][1:5])
        names = (("replay_faults", "replay_lanes_faults"),)
        if mid not in RANDOMIZED_ROWS:
            names += (("replay_blocked_faults", "replay_blocked_lanes_faults"),)
        state, pods, types, evk, evp, tp, rank = base
        plans = []
        for b in range(4):
            fc = FaultConfig(**LANE_CASE_FLAGS, seed=11 + b)
            plans.append(fl.compile_fault_plan(
                evk.cpu().numpy(), evp.cpu().numpy(),
                generate_fault_schedule(nn, evk.shape[0], fc), fc, nn, pp))
        gen = torch.Generator().manual_seed(5)
        ranks = [rank] + [torch.randperm(nn, generator=gen).int().to(device)
                          for _ in range(3)]
        for name, lanes_name in names:
            blocked = "blocked" in name
            st = pad_nodes(state, rank, 128)[0] if blocked else state
            rks = [pad_rank(r, 128) if blocked else r for r in ranks]
            tables = lane_tables(st, types, tp, cfg)
            case = (st, pods, types, tp, rks[0], tables)
            err, ms, plain_ms, got, first = fault_against_plain(
                name, case, cfg, plans[0])
            label = f"random {nn} nodes {mid}"
            note(name, err, ms, plain_ms, None, label)
            lanes = [fe.Lane(pods, types.type_id,
                             torch.as_tensor(pl.kind, device=device),
                             torch.as_tensor(pl.idx, device=device), rks[b],
                             cfg.weights,
                             (0, 7 + b) if cfg.randomized else None,
                             fl.lane_of(pl, st, pp))
                     for b, pl in enumerate(plans)]
            lerr, lplain, lgot = fault_lanes_against_plain(
                lanes_name, (st, types, tp, tables), cfg, lanes, first=first)
            bound = None
            lms = None
            if mid == LANE_ROWS[0]:  # the lanes rows' numbers
                prep = (he.prepare_replay_blocked_lanes_faults if blocked
                        else fe.prepare_replay_lanes_faults)
                timed = prep(st, types, tp, tables, cfg, lanes)
                lms = kernel_ms(timed, 3, fault_lanes_reset(timed, st, tables,
                                                            lanes))
                step = skip_step_ms(name, case, cfg, 1000)
                chains = [fault_chain(name, (st, pods, types, tp, rks[b],
                                             tables), cfg, pl, lgot[b],
                                      step)[0]
                          for b, pl in enumerate(plans)]
                bound = lanes_bound(chains, len(lanes),
                                    (cfg.num_tables + 2) * types.num_types
                                    * st.num_nodes * 4)
            note(lanes_name, lerr, lms, plain_ms + lplain, bound,
                 label + ", 4 lanes")
            print(f"lane check {name} and {lanes_name} {label} (steps "
                  f"{[int(pl.kind.shape[0]) for pl in plans]}, by kind "
                  f"{np.bincount(plans[0].kind, minlength=7).tolist()}): "
                  f"max_abs_err={err} one launch, {lerr} 4 lanes (tolerance "
                  f"0); {ms:.3f} ms, plain {plain_ms:.1f} ms, lanes 1-3's "
                  f"plain {lplain:.1f} ms on the CPU; on {card}", flush=True)
    return out, plan, plan_ms


def lane_sim(mid: str, setting: str, mode: str, device, pods):
    """A Simulator of a METHODS row on openb (tune 1.3, seeds 42, shuffled),
    per-event reports off, with `mode` as fault_mode and residency
    `setting`."""
    import dataclasses

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.io.trace import load_node_csv
    from tpusim_torch.sim.driver import Simulator

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    row = dict((r[0], r) for r in METHODS)[mid]
    cfg = dataclasses.replace(method_config(*row[1:5]), report_per_event=False,
                              fault_mode=mode, table_residency=setting)
    sim = Simulator(load_node_csv(os.path.join(
        data, "openb_node_list_gpu_node.csv")), cfg, device=device)
    sim.set_workload_pods(pods)
    return sim


def fault_counts(label: str, counts: dict, want: dict) -> None:
    """The run launched exactly `want`'s kernels as many times each."""
    expect = {name: want.get(name, 0) for name in counts}
    if counts != expect:
        raise SmokeFailure(f"{label}: launches {counts}, want {expect}")


def lane_runs(device, card: str):
    """The lane on its paths at openb, per-event reports off, the launch
    counts set to 0 before each run and read after it: run_with_faults
    with FAULT_FLAGS under 06-FGD with residency "auto" (replay_faults)
    and "hbm" (replay_blocked_faults), fault_mode auto, and 01-Random
    under fault_mode scan: one init_tables and one fault-form launch each,
    results, ranks, unscheduled pods and disruption metrics held to
    FAULT_SCAN_SHA256, the plan's compile, the launch, the fetch and the
    host tail timed apart; the segmented host loop on the same run
    (fault_mode segments) timed beside it, its results held to the same
    digests. Returns ({label: counts}, {label: timings})."""
    import torch

    from tpusim_torch.io.trace import load_pod_csv
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.faults import FaultConfig

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    pods = load_pod_csv(os.path.join(data, "openb_pod_list_default.csv"))
    launches, times = {}, {}
    for mid, setting, mode, kernel in (
            ("06-FGD", "auto", "auto", "replay_faults"),
            ("06-FGD", "hbm", "auto", "replay_blocked_faults"),
            ("01-Random", "auto", "scan", "replay_faults"),
            ("06-FGD", "auto", "segments", "replay")):
        label = (f"lane {mid}" + ("/hbm" if setting == "hbm" else "")
                 + ("/segments" if mode == "segments" else ""))
        sim = lane_sim(mid, setting, mode, device, pods)
        fe.reset_launch_counts()
        t0 = time.perf_counter()
        res = sim.run_with_faults(FaultConfig(**FAULT_FLAGS))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = run_counts()
        segments = len(sim.replay_times)
        fault_counts(label, counts, {"init_tables": segments,
                                    kernel: segments})
        launches[label] = counts
        got = dict(result_digests(res),
                   disruption=disruption_digest(sim.last_disruption))
        if got != FAULT_SCAN_SHA256[mid]:
            raise SmokeFailure(f"{label}: differs from the JAX reference's "
                               f"lane: {got}")
        t = {key: sum(r.get(key, 0.0) for r in sim.replay_times)
             for key in ("plan_ms", "replay_ms", "fetch_ms", "report_ms")}
        t.update(wall_ms=wall, segments=segments, events=res.events)
        times[label] = t
        print(f"lane run {label}: {sim.last_engine} ({sim.last_residency}), "
              f"launches {counts}, {segments} launch(es) of {kernel}; "
              f"{res.events} events; run_with_faults {wall:.1f} ms: plan "
              f"compile {t['plan_ms']:.1f} ms, init_tables + replay up to "
              f"a synchronise {t['replay_ms']:.1f} ms, fetch "
              f"{t['fetch_ms']:.1f} ms, host tail {t['report_ms']:.1f} ms "
              f"(host clock); matches FAULT_SCAN_SHA256 on {card}",
              flush=True)
    return launches, times


def chaos_runs(device, card: str):
    """The chaos sweep at openb: run_sweep(faults=) with 8 lanes of
    FAULT_FLAGS under fault seeds CHAOS_SEEDS (06-FGD, reports off,
    residency auto: init_tables and replay_lanes_faults once each), each
    lane equal to its standalone lane run (run_with_faults, fault_mode
    scan) and seed 7's to FAULT_SCAN_SHA256; then its first 4 lanes under
    "hbm" (replay_blocked_lanes_faults), equal to the same lanes; then
    `python -m tpusim_torch.cli apply` with CHAOS_APPLY_ARGS (the README's
    faults.json), its chaos_stdout held to CHAOS_APPLY_SHA256. Returns
    ({label: counts}, {label: timings})."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import torch

    from tpusim_torch.apply import Applier
    from tpusim_torch.cli import apply_options, build_parser
    from tpusim_torch.io.trace import load_pod_csv
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.faults import FaultConfig

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    pods = load_pod_csv(os.path.join(data, "openb_pod_list_default.csv"))
    launches, times = {}, {}
    specs = [FaultConfig(**dict(FAULT_FLAGS, seed=s)) for s in CHAOS_SEEDS]
    lanes_of = {}
    for setting, b, kernel in (("auto", len(specs), "replay_lanes_faults"),
                               ("hbm", min(4, len(specs)),
                                "replay_blocked_lanes_faults")):
        label = f"chaos {b} lanes" + ("/hbm" if setting == "hbm" else "")
        sim = lane_sim("06-FGD", setting, "scan", device, pods)
        fe.reset_launch_counts()
        t0 = time.perf_counter()
        lanes = sim.run_sweep([[1000]] * b, faults=specs[:b])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = run_counts()
        fault_counts(label, counts, {"init_tables": 1, kernel: 1})
        launches[label] = counts
        lanes_of[setting] = lanes
        times[label] = dict(wall_ms=wall, lanes=b)
        print(f"lane {label}: {sim.last_engine} ({sim.last_residency}), "
              f"launches {counts}; run_sweep {wall:.1f} ms (host clock, the "
              f"lanes' plan compiles included) on {card}", flush=True)
    for i, ln in enumerate(lanes_of["hbm"]):
        same_replay(f"chaos lane {i} hbm", ln, lanes_of["auto"][i])
        if disruption_digest(ln.disruption) != disruption_digest(
                lanes_of["auto"][i].disruption):
            raise SmokeFailure(f"chaos lane {i} hbm: disruption differs")
    sim = lane_sim("06-FGD", "auto", "scan", device, pods)
    solo_ms = []
    for i, (spec, ln) in enumerate(zip(specs, lanes_of["auto"])):
        t0 = time.perf_counter()
        res = sim.run_with_faults(spec)
        solo_ms.append((time.perf_counter() - t0) * 1e3)
        dm = disruption_digest(sim.last_disruption)
        if not (np.array_equal(ln.placed_node, res.placed_node)
                and np.array_equal(ln.dev_mask, res.dev_mask)
                and ln.events == res.events
                and disruption_digest(ln.disruption) == dm):
            raise SmokeFailure(f"chaos lane {i} (fault seed {spec.seed}) "
                               "differs from its standalone lane run")
        if spec.seed == 7:
            want = FAULT_SCAN_SHA256["06-FGD"]
            if (digest(ln.placed_node, np.int32) != want["placed"]
                    or digest(ln.dev_mask, np.uint8) != want["dev_mask"]
                    or dm != want["disruption"]):
                raise SmokeFailure("chaos lane of fault seed 7 differs from "
                                   "FAULT_SCAN_SHA256")
    times["chaos standalone"] = dict(runs=len(solo_ms),
                                     median_ms=float(np.median(solo_ms)))
    print(f"lane chaos: every lane equals its standalone lane run (median "
          f"{np.median(solo_ms):.1f} ms a run, host clock), fault seed 7's "
          f"matches FAULT_SCAN_SHA256; the 4 hbm lanes equal the auto ones",
          flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "faults.json")
        with open(path, "w") as f:
            json.dump(CHAOS_FAULTS, f)
        argv = ["apply", *CHAOS_APPLY_ARGS, "--base-dir", root]
        for i in (2, 4):
            argv[i] = os.path.join(root, argv[i])
        argv[6] = path
        applier = Applier(apply_options(build_parser().parse_args(argv)))
        buf = io.StringIO()
        fe.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            applier.run(out=buf)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = run_counts()
    fault_counts("apply --sweep-faults", counts,
                {"init_tables": 1, "replay_lanes_faults": 1})
    launches["apply --sweep-faults"] = counts
    got = digest_text(chaos_stdout(buf.getvalue()))
    if got != CHAOS_APPLY_SHA256:
        raise SmokeFailure(f"apply --sweep-faults: chaos stdout sha256 {got}")
    times["apply --sweep-faults"] = dict(wall_ms=wall)
    print(f"lane apply {' '.join(CHAOS_APPLY_ARGS)}: launches {counts}, "
          f"stdout matches CHAOS_APPLY_SHA256; {wall:.1f} ms (host clock) on "
          f"{card}", flush=True)
    return launches, times


def lane_full_ms(device, plan) -> dict:
    """The fault forms' kernel ms (CUDA events, median of 3, state restored)
    over the whole openb merged stream of `plan` under 06-FGD."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fault_lane as fl
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    cfg = fe.make_config(*dict((r[0], r) for r in METHODS)["06-FGD"][1:5])
    kinds = torch.as_tensor(plan.kind, device=device)
    idx = torch.as_tensor(plan.idx, device=device)
    out = {}
    for name in ("replay_faults", "replay_blocked_faults"):
        st, rk = (pad_nodes(state, rank, 128)
                  if name == "replay_blocked_faults" else (state, rank))
        tables = lane_tables(st, types, tp, cfg)
        lane = fl.lane_of(plan, st, int(specs.cpu.shape[0]))
        prep = he.prepare_replay_blocked_faults \
            if name == "replay_blocked_faults" else fe.prepare_replay_faults
        ready = prep(st, specs, types, kinds, idx, tp, rk, tables, cfg, lane)
        out[name] = kernel_ms(ready, 3, fault_reset(ready, st, tables, lane))
    return out


def lane_path(device, card: str):
    """Phase 10: the in-scan fault lane (module docstring). Returns
    ({run label: launch counts}, {fault kernel: its row's numbers})."""
    rows, plan, plan_ms = lane_kernel_checks(device, card)
    full = lane_full_ms(device, plan)
    print(f"lane openb merged stream ({plan.kind.shape[0]} steps, by kind "
          f"{np.bincount(plan.kind, minlength=7).tolist()}, draw table "
          f"{plan.draws.shape}): host plan compile {plan_ms:.1f} ms; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in full.items())
          + f" (CUDA events) on {card}", flush=True)
    launches, times = lane_runs(device, card)
    counts, chaos = chaos_runs(device, card)
    launches.update(counts)
    times.update(chaos)
    for name, ms in full.items():
        rows[name]["openb_ms"] = ms
    rows["replay_faults"]["plan_ms"] = plan_ms
    rows["replay_faults"]["runs"] = times
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "lane_phase.json"), "w") as f:
        json.dump(dict(card=card, rows=rows, launches=launches), f, indent=1)
    return launches, rows


# The seq phase: the sequential oracle (tpusim_torch.sim.engine make_replay;
# Simulator(engine="sequential")) on the card, against the digests of the
# JAX package's sequential engine on the CPU, which
# tests/test_torch_sequential.py pins (slow-marked). SEQ_SHA256: the whole
# openb run of 06-FGD with per-event reports on, as METHODS and
# REPORT_SHA256 hold the kernels' (placed_node, dev_mask, report_digest).
# SEQ_PREFIX_SHA256: every other METHODS row's run_events over the first
# SEQ_PREFIX events of the prepared openb trace, from the initial state and
# PRNGKey(42). SEQ_FAULT_SHA256: fault_steps_digest of the fault form over
# the first SEQ_FAULT_STEPS steps of FAULT_FLAGS' openb merged stream under
# 06-FGD. SEQ_EXTENDER_SHA256: the extender host loop's run of
# EXTENDER_CASE (the first openb nodes and pods, the paper's FGD untuned,
# reports on) against ExtenderStub on 127.0.0.1.
SEQ_PREFIX = 400
SEQ_FAULT_STEPS = 2_000
EXTENDER_CASE = (120, 300)
SEQ_SHA256 = {
    "placed":
        "ab2bdf81ba2e44defba6b5cc760450efcf35317501034aa82b552e71c4bcd30a",
    "dev_mask":
        "6e208732b4dc66047e6d8ebf604514bf5ff51df84b89c314d13147237065b749",
    "report":
        "572dff81f444275e1a8d87e0dcfdcd7ba886b931a90654bdc00d8f5bf828e968",
}
SEQ_PREFIX_SHA256 = {
    "01-Random": {
        "placed":
            "f161df020f046638d87485f9b974473f89e8e975c43aa5ff71f3f2355e7757f2",
        "dev_mask":
            "4fa8d82b53f2bfa7d610b099c56315e0b736f7755a1086d3a32bc9aa5d5f7ea3",
    },
    "02-DotProd": {
        "placed":
            "5d0408e9940b0916db25d442a50b857d8af94eefdb8e53bbd0072fc986709a78",
        "dev_mask":
            "5b58ee31c18668e7d9a36eb43f5967839bae98b43d69af6312025f8a1d3618c3",
    },
    "03-GpuClustering": {
        "placed":
            "f43f04de0e08d0fe8b7be7f2a4aa5cb616a70d0a66f4e4b7b470abbc4b7d5f32",
        "dev_mask":
            "5a7288365ab02a85313478b0fbf5d6ed57db84f333e4d6e59e05dd6f4c0c6c0b",
    },
    "04-GpuPacking": {
        "placed":
            "2a9a1ff06aff33914d12b1496aea8da2854b129473cbf6182d08d94eb0094b05",
        "dev_mask":
            "34d4e5a48ce38a542e0e24677e6b977a320f70c6923232d9dd5120e7b7b466cf",
    },
    "05-BestFit": {
        "placed":
            "081f18a568018d7e2f0342f78a3e44bde43801ca2a24fa8156acbd95fbdaaaa5",
        "dev_mask":
            "ed0be88d49dfe40c1e2adfbfa3b5b2866687e145886aca4f80e036b2935d63d0",
    },
    "07-PWR": {
        "placed":
            "b55cc7b1541ffbefac9d6232059ed6fb0dd04357f708fc4ca768c07b8c401f8c",
        "dev_mask":
            "e4309f586deb76f377bd35cac3e18168642a64678123d9c1cb04811c364e6db6",
    },
    "08-PWR_500_FGD_500": {
        "placed":
            "b514f9633e881f943eb19f1c764885dbcb92d35e10bacd2152cda9eda5b3a7bd",
        "dev_mask":
            "f7c5a1a6c6c4462e7c96e42bd8e49d865827e89e64a5990a40dc56f1d14a98b9",
    },
    "11-PWR_100_FGD_900": {
        "placed":
            "cf1637fc48a889e42d4eb02a6a673eab9a058f4c23836724c45810689897fe4a",
        "dev_mask":
            "3e0d1658d5dbb98e1d6d14a81815f076615df4975090aec4ba824817b8eed493",
    },
    "12-PWR_50_FGD_950": {
        "placed":
            "3858450c9e55c7330919b7618449b86a27684d458d0c6566a98758e6ea757f4b",
        "dev_mask":
            "190149f8eaacd729ecb244b329ab13357d455166b60f6ed9b90d1a93bd9230c0",
    },
    "Simon": {
        "placed":
            "15d82dcc61d87ef40edfbdf12a8d9297d1d4805e92ea5faf74450363641d9fdf",
        "dev_mask":
            "6844f28b0f83a4fac4c5e4543a6e45f75ae4c7aa18a3356a93770f583b480ab7",
    },
    "default-profile": {
        "placed":
            "276b01fb36376bdb320318a56c3338557fbf075d2b98fea181123877d8d82e47",
        "dev_mask":
            "524aef58f928e2261248c2d6b942f23dfcc8cd5ae67f62d345d06cdcf1d9fb47",
    },
}
SEQ_FAULT_SHA256 = (
    "35fb0b987a1e09908626ab52e609cf78b9282e4018745b2dcb17bdd6e304e1e0"
)
SEQ_EXTENDER_SHA256 = {
    "placed":
        "bddc21efb0e286f396bba1c446d389fbb577b6adec498ab81aaabb7711a0ad8d",
    "dev_mask":
        "390fb028b220eb93a709a15a82bb4b04e9320e407f0ae50ceb65cfc446984040",
    "log":
        "14702237337874eebdc3d118025669da9397806a937243d7755dcbe9729fb86f",
}


class ExtenderStub:
    """A deterministic scheduler extender served on 127.0.0.1 (loopback
    only) while the `with` block runs: its filter drops the nodes whose
    name ends in 3, its prioritize scores a node by its name's last digit
    (0-9). `url` is its address."""

    def __enter__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                names = body.get("nodenames")
                if names is None:
                    names = [it["metadata"]["name"]
                             for it in body["nodes"]["items"]]
                if self.path.endswith("/filter"):
                    keep = [n for n in names if not n.endswith("3")]
                    resp = ({"nodenames": keep} if "nodenames" in body else
                            {"nodes": {"items": [{"metadata": {"name": n}}
                                                 for n in keep]}})
                else:
                    resp = [{"host": n, "score": int(n[-1]) % 10
                             if n[-1].isdigit() else 0} for n in names]
                data = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def extender_config(url: str):
    """The SimulatorConfig of EXTENDER_CASE: the paper's FGD untuned,
    reports on, one extender at `url` that filters and prioritizes
    (weight 2)."""
    import dataclasses

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.sim.extender import ExtenderConfig

    return dataclasses.replace(method_config(), tuning_ratio=0.0, extenders=(
        ExtenderConfig(url, "filter", "prioritize", weight=2),))


def fault_steps_digest(placed, dev_mask, event_node, ys: dict,
                       dctr) -> str:
    """sha256 of a fault-form run: placed_node, dev_mask, each merged
    step's event node, the steps' rpod, lat, vpod, vnode, nvict and rec,
    and the final disruption counters (numpy arrays)."""
    h = hashlib.sha256()
    for a, dtype in ((placed, np.int32), (dev_mask, np.uint8),
                     (event_node, np.int32)):
        h.update(np.ascontiguousarray(a, dtype).tobytes())
    for name in ("rpod", "lat", "vpod", "vnode", "nvict", "rec"):
        h.update(np.ascontiguousarray(ys[name], np.int32).tobytes())
    h.update(np.ascontiguousarray(dctr, np.int32).tobytes())
    return h.hexdigest()


def log_digest(lines) -> str:
    """sha256 of log lines without their [Engine] lines."""
    return digest_text("".join(f"{line}\n" for line in lines
                               if "[Engine]" not in line))


def openb_rows_port():
    from tpusim_torch.io.trace import load_node_csv, load_pod_csv

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "csv")
    return (load_node_csv(os.path.join(data, "openb_node_list_gpu_node.csv")),
            load_pod_csv(os.path.join(data, "openb_pod_list_default.csv")))


def seq_full(device, card: str, nodes, pods) -> dict:
    """The oracle over the whole openb trace under 06-FGD, reports on,
    through Simulator(engine="sequential").run(): no replay kernel
    launched, the digests held to SEQ_SHA256, the replay timed (wall and
    the host's busy share)."""
    import dataclasses
    import tempfile

    import torch

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.analysis import analyze_sim
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator

    row = dict((r[0], r) for r in METHODS)["06-FGD"]
    cfg = dataclasses.replace(method_config(*row[1:5]), engine="sequential")
    sim = Simulator(nodes, cfg, device=device)
    sim.set_workload_pods(pods)
    stamps = {}
    run_events = sim.run_events

    def timed(*args, **kw):
        t, c = time.perf_counter(), time.process_time()
        out = run_events(*args, **kw)
        torch.cuda.synchronize()
        stamps.update(wall=time.perf_counter() - t,
                      cpu=time.process_time() - c)
        return out

    sim.run_events = timed
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    del sim.run_events  # the timed replay is the run's own
    counts = run_counts()
    if any(counts.values()) or sim.last_engine != "sequential":
        raise SmokeFailure(f"seq 06-FGD: the oracle launched {counts} "
                           f"(last engine {sim.last_engine})")
    with tempfile.TemporaryDirectory() as d:
        report = experiment_report_digest(
            sim, d, row_meta(*row[1:4]), analyze_sim)
    got = {"placed": digest(res.placed_node, np.int32),
           "dev_mask": digest(res.dev_mask, np.uint8), "report": report}
    if res.events != OPENB_EVENTS or got != SEQ_SHA256:
        raise SmokeFailure(f"seq 06-FGD: the oracle's openb run differs from "
                           f"the JAX sequential engine's: {got}")
    kernels_equal = (got["placed"] == row[5] and got["dev_mask"] == row[6]
                     and report == REPORT_SHA256["06-FGD"])
    busy = seq_device_busy(sim)
    wall, cpu = stamps["wall"], stamps["cpu"]
    print(f"seq 06-FGD: the oracle over the whole openb trace "
          f"({res.events} events) on the card matches the JAX sequential "
          f"engine's digests (placements, masks, simon.log and CSVs); they "
          f"{'equal' if kernels_equal else 'DIFFER from'} the replay "
          f"kernel's (METHODS, REPORT_SHA256); no replay kernel launched. "
          f"Replay wall {wall:.3f} s ({res.events / wall:.1f} events/s), "
          f"host busy {cpu:.3f} s = {100 * cpu / wall:.1f}% of it, run() "
          f"{run_s:.3f} s with the report half; {busy['text']}; on {card}",
          flush=True)
    return dict(events=res.events, replay_s=wall, host_cpu_s=cpu,
                host_share=cpu / wall, run_s=run_s, device=busy,
                equals_kernel_digests=kernels_equal, launches=counts)


def seq_device_busy(sim, events: int = 60) -> dict:
    """The card's busy share under the oracle: its kernels' device time
    (torch.profiler, CUDA activity) over the wall of a run_events over the
    first `events` events of the Simulator's prepared trace, both under the
    profiler; "not measured" where the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpusim_torch.io.trace import build_events, pods_to_specs

    trace = sim.prepare_pods()
    specs = pods_to_specs(trace, sim.node_index, sim.device)
    evk, evp = (a[:events] for a in build_events(trace))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_events(sim.init_state, specs, evk, evp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, launches = 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us and getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            device_us += us
            launches += e.count
    if not device_us:
        return dict(text="device busy share not measured (the profiler "
                    "showed no device time)")
    share = device_us / 1e6 / wall
    return dict(events=events, wall_s=wall, device_s=device_us / 1e6,
                busy_share=share, kernels=launches,
                text=f"under the profiler, {events} events: {launches} "
                f"kernels ({launches / events:.1f} an event), device busy "
                f"{device_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall = "
                f"{100 * share:.1f}%")


def seq_prefix(device, card: str, nodes, pods) -> dict:
    """Every other METHODS row over the first SEQ_PREFIX events of the
    prepared openb trace: the oracle (run_events under engine
    "sequential") held to SEQ_PREFIX_SHA256, then the flat replay kernel
    on the same inputs held to the oracle's outputs and final state."""
    import dataclasses

    import torch

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator

    out = {}
    for mid, policies, gpu_sel, dim_ext, norm, _, _ in METHODS:
        if mid == "06-FGD":
            continue
        base = method_config(policies, gpu_sel, dim_ext, norm)
        runs = {}
        for engine in ("sequential", "auto"):
            sim = Simulator(nodes, dataclasses.replace(base, engine=engine),
                            device=device)
            sim.set_workload_pods(pods)
            sim.set_typical_pods()
            trace = sim.prepare_pods()
            specs = pods_to_specs(trace, sim.node_index, device)
            evk, evp = (a[:SEQ_PREFIX] for a in build_events(trace))
            fe.reset_launch_counts()
            t0 = time.perf_counter()
            res = sim.run_events(sim.init_state, specs, evk, evp)
            torch.cuda.synchronize()
            runs[engine] = (res, time.perf_counter() - t0, run_counts())
        res, wall, counts = runs["sequential"]
        got = {"placed": digest(res.placed_node.cpu(), np.int32),
               "dev_mask": digest(res.dev_mask.cpu(), np.uint8)}
        if any(counts.values()) or got != SEQ_PREFIX_SHA256[mid]:
            raise SmokeFailure(f"seq {mid}: the oracle over the first "
                               f"{SEQ_PREFIX} events differs from the JAX "
                               f"sequential engine's ({got}; launches "
                               f"{counts})")
        kres, kwall, _ = runs["auto"]
        same = all(torch.equal(getattr(res, f).cpu(), getattr(kres, f).cpu())
                   for f in ("placed_node", "dev_mask", "ever_failed",
                             "event_node", "event_dev")) and all(
            torch.equal(a.cpu(), b.cpu())
            for a, b in zip(res.state, kres.state))
        if not same:
            raise SmokeFailure(f"seq {mid}: the replay kernel over the first "
                               f"{SEQ_PREFIX} events differs from the oracle")
        print(f"seq {mid}: the oracle over the first {SEQ_PREFIX} openb "
              f"events matches the JAX sequential engine's digests, and the "
              f"replay kernel ({kwall * 1e3:.1f} ms with its host work) "
              f"equals it; oracle wall {wall:.3f} s "
              f"({SEQ_PREFIX / wall:.1f} events/s) on {card}", flush=True)
        out[mid] = dict(oracle_s=wall, kernel_s=kwall)
    return out


def seq_fault(device, card: str) -> dict:
    """The oracle's fault form over the first SEQ_FAULT_STEPS steps of
    FAULT_FLAGS' openb merged stream under 06-FGD, held to
    SEQ_FAULT_SHA256, and the replay_faults kernel on the same steps held
    to it."""
    import torch

    from tpusim_torch.policies import make_policy
    from tpusim_torch.sim import fault_lane as fl
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.engine import make_replay
    from tpusim_torch.sim.faults import FaultConfig, generate_fault_schedule

    row = dict((r[0], r) for r in METHODS)["06-FGD"]
    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    n, p = state.num_nodes, int(specs.cpu.shape[0])
    fcfg = FaultConfig(**FAULT_FLAGS)
    plan = fl.compile_fault_plan(evk.cpu().numpy(), evp.cpu().numpy(),
                                 generate_fault_schedule(n, evk.shape[0],
                                                         fcfg), fcfg, n, p)
    cut = cut_plan(plan, SEQ_FAULT_STEPS)
    replay = make_replay([(make_policy(name), w) for name, w in row[1]],
                         row[2], report=False, faults=True,
                         fault_frag=cut.has_recover)
    lane = fl.lane_of(cut, state, p)
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    out, fout = replay(state, specs, cut.kind, cut.idx, tp, OPENB_KEY, rank,
                       fault_ops=lane.ops, fault_carry0=lane.carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    ys = {f: getattr(fout.ys, f).cpu().numpy() for f in fout.ys._fields}
    got = fault_steps_digest(out.placed_node.cpu(), out.dev_mask.cpu(),
                             out.event_node.cpu(), ys,
                             fout.carry.dctr.cpu())
    if any(counts.values()) or got != SEQ_FAULT_SHA256:
        raise SmokeFailure(f"seq fault form: {got} differs from the JAX "
                           f"sequential engine's (launches {counts})")
    cfg = fe.make_config(*row[1:5])
    kout, kfout = fe.replay_faults(
        state, specs, types, torch.as_tensor(cut.kind, device=device),
        torch.as_tensor(cut.idx, device=device), tp, rank,
        fe.init_tables(state, types, tp, cfg), cfg,
        fl.lane_of(cut, state, p), OPENB_KEY)
    kys = {f: getattr(kfout.ys, f).cpu().numpy() for f in kfout.ys._fields}
    if fault_steps_digest(kout.placed_node.cpu(), kout.dev_mask.cpu(),
                          kout.event_node.cpu(), kys,
                          kfout.carry.dctr.cpu()) != got:
        raise SmokeFailure("seq fault form: replay_faults differs from the "
                           "oracle's fault form")
    kinds = np.bincount(cut.kind, minlength=7).tolist()
    print(f"seq fault form: the oracle over the first {SEQ_FAULT_STEPS} "
          f"steps of the openb merged stream (by kind {kinds}) matches the "
          f"JAX sequential engine's digest, and replay_faults equals it; "
          f"wall {wall:.3f} s on {card}", flush=True)
    return dict(steps=SEQ_FAULT_STEPS, kinds=kinds, oracle_s=wall)


def seq_extender(device, card: str, nodes, pods) -> dict:
    """The extender host loop on EXTENDER_CASE against ExtenderStub on
    127.0.0.1, held to SEQ_EXTENDER_SHA256."""
    import torch

    from tpusim_torch.sim.driver import Simulator

    n, p = EXTENDER_CASE
    with ExtenderStub() as stub:
        sim = Simulator(nodes[:n], extender_config(stub.url), device=device)
        sim.set_workload_pods(pods[:p])
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = {"placed": digest(res.placed_node, np.int32),
           "dev_mask": digest(res.dev_mask, np.uint8),
           "log": log_digest(sim.log.lines)}
    if sim.last_engine != "extender" or got != SEQ_EXTENDER_SHA256:
        raise SmokeFailure(f"seq extender: {got} differs from the JAX "
                           f"extender loop's")
    print(f"seq extender: the extender host loop ({n} openb nodes, {p} pods, "
          f"filter and prioritize over HTTP on 127.0.0.1) matches the JAX "
          f"digests (placements, masks, log); run() {wall:.3f} s on {card}",
          flush=True)
    return dict(nodes=n, pods=p, run_s=wall)


def seq_path(device, card: str):
    """Phase 11: the sequential oracle on the card (module docstring).
    Returns ({run label: launch counts}, the phase's numbers), which
    chiprun_out/seq_phase.json keeps."""
    nodes, pods = openb_rows_port()
    t0 = time.perf_counter()
    full = seq_full(device, card, nodes, pods)
    out = dict(card=card, full=full,
               prefix=seq_prefix(device, card, nodes, pods),
               fault=seq_fault(device, card),
               extender=seq_extender(device, card, nodes, pods))
    out["phase_s"] = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "seq_phase.json"), "w") as f:
        json.dump(out, f, indent=1)
    return {"seq 06-FGD": full["launches"]}, out


# The ckpt phase (12): chunked replay through the chunk surface at openb,
# a checkpoint every CKPT_EVERY events (11 chunks of the 10,811 events)
CKPT_EVERY = 1000
CKPT_ROWS = (("06-FGD", "auto"), ("06-FGD", "hbm"), ("01-Random", "auto"))
# the child run is killed once its checkpoint at this event is on disk
CKPT_KILL_AT = 4000
# how long the child waits there to be killed before it gives up
CKPT_CHILD_WAIT = 300
# the fork: schedule_pods_fork of the prepared openb 06-FGD trace at this
# event with tests/test_fork.py's tail (delete pods 0 and 3, create pod 0
# again; EV_DELETE = 1, EV_CREATE = 0)
CKPT_FORK_EVENT = 5000
FORK_TAIL = ((1, 1, 0), (0, 3, 0))
# sha256 of placed_node (int32) and dev_mask (uint8) of the JAX package's
# replay of the spliced stream (base[:5000] + the tail, 5,003 events) from
# PRNGKey(42) (Simulator.run_events, table engine, CPU).
# tests/test_torch_fork.py pins them against tpusim (slow-marked).
FORK_SHA256 = (
    "dfed3a57522bc26bffac7949824448260ccff55fc7750e581ac83622013fa8f4",
    "b489e188779f237b32d54a80c3dbafe64f41276fcf553adede78a41b566455d8",
)


def nonzero(counts: dict) -> dict:
    """The launch counts of the kernels a run launched."""
    return {name: c for name, c in counts.items() if c}


def check_result_digests(where: str, res, placed_sha: str,
                         mask_sha: str) -> None:
    """A SimulateResult's placements and device masks (numpy) against the
    JAX package's digests of the same run."""
    got = (digest(res.placed_node, np.int32), digest(res.dev_mask, np.uint8))
    if got != (placed_sha, mask_sha):
        raise SmokeFailure(f"{where}: differs from the JAX reference: "
                           f"placed sha256 {got[0]} dev_mask sha256 {got[1]}")


def ckpt_sim(mid: str, setting: str, device, nodes, pods, **knobs):
    """A Simulator of METHODS row `mid` on openb with table_residency
    `setting` and the given SimulatorConfig knobs (checkpoint_every,
    checkpoint_dir, ...), its workload set."""
    import dataclasses

    from tpusim_torch.__main__ import method_config
    from tpusim_torch.sim.driver import Simulator

    row = next(r for r in METHODS if r[0] == mid)
    cfg = dataclasses.replace(method_config(*row[1:5]),
                              table_residency=setting, **knobs)
    sim = Simulator(nodes, cfg, device=device)
    sim.set_workload_pods(pods)
    return sim


def ckpt_check_run(label: str, sim, res, mid: str, counts: dict,
                   tier: str, chunks: int) -> None:
    """A chunked run launched init_tables and its residency's replay once a
    chunk and the other replay kernel not, and its placements, masks, log
    (without [Engine] and [Checkpoint] lines) and CSVs match the JAX
    digests of the row."""
    row = next(r for r in METHODS if r[0] == mid)
    want = dict.fromkeys(RESIDENCY_KERNELS[tier], chunks)
    if nonzero(counts) != want or sim.last_chunks != chunks:
        raise SmokeFailure(f"{label}: launches {counts}, chunks "
                           f"{sim.last_chunks}; want {want}")
    check_result_digests(label, res, row[5], row[6])
    sim.log.lines = [line for line in sim.log.lines
                     if "[Checkpoint]" not in line]
    check_report(label, sim, mid, row_meta(*row[1:4]))


def ckpt_child(ckdir: str) -> int:
    """The child run of the kill-and-resume check (--ckpt-child): openb
    06-FGD chunked into ckdir, stopped once its checkpoint at CKPT_KILL_AT
    is written, to be killed there by the phase."""
    import tpusim_torch.io.storage as storage

    real = storage.save_checkpoint

    def save(cache_dir, digest_, cursor, arrays):
        path = real(cache_dir, digest_, cursor, arrays)
        if cursor >= CKPT_KILL_AT:
            print(f"ckpt child: checkpoint at event {cursor} written, "
                  "waiting to be killed", flush=True)
            time.sleep(CKPT_CHILD_WAIT)
        return path

    storage.save_checkpoint = save
    nodes, pods = openb_rows_port()
    t0 = time.perf_counter()
    sim = ckpt_sim("06-FGD", "auto", "cuda", nodes, pods,
                   checkpoint_every=CKPT_EVERY, checkpoint_dir=ckdir)
    print(f"ckpt child: set up in {time.perf_counter() - t0:.2f} s",
          flush=True)
    sim.run()
    print("ckpt child: ran to the end without being killed", flush=True)
    return 1


def ckpt_chunks(device, card: str, nodes, pods, root: str, launches: dict):
    """The chunked runs of CKPT_ROWS through Simulator.run(), then the warm
    walls chunked and not, and the cost of one chunk boundary."""
    import torch

    from tpusim_torch.io import storage
    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.ops.prng import prng_key
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import table_engine as te

    out = {}
    chunks = -(-OPENB_EVENTS // CKPT_EVERY)
    for mid, setting in CKPT_ROWS:
        label = f"ckpt {mid}" + ("/hbm" if setting == "hbm" else "")
        tier = "hbm" if setting == "hbm" and mid not in RANDOMIZED_ROWS \
            else "vmem"
        ckdir = os.path.join(root, label.replace(" ", "_").replace("/", "_"))
        sim = ckpt_sim(mid, setting, device, nodes, pods,
                       checkpoint_every=CKPT_EVERY, checkpoint_dir=ckdir)
        fe.reset_launch_counts()
        run_ms, res = wall_ms(sim.run)
        counts = run_counts()
        launches[label] = counts
        ckpt_check_run(label, sim, res, mid, counts, tier, chunks)
        counts = nonzero(counts)
        if os.listdir(ckdir):
            raise SmokeFailure(f"{label}: checkpoints left after the run: "
                               f"{os.listdir(ckdir)}")
        trace = sim.prepare_pods()
        specs = pods_to_specs(trace, sim.node_index, device)
        evk, evp = build_events(trace)
        walls, splits = {}, []
        for every in (CKPT_EVERY, 0):
            sim.cfg.checkpoint_every = every
            walls[every] = []
            for _ in range(3):
                walls[every].append(wall_ms(lambda: sim.run_events(
                    sim.init_state, specs, evk, evp))[0])
                if every:
                    splits.append(sim.last_chunk_times)
        sim.cfg.checkpoint_every = CKPT_EVERY
        split = splits[int(np.argmin(walls[CKPT_EVERY]))]
        out[label] = dict(run_ms=run_ms, replay_ms=sim.replay_times[0][
            "replay_ms"], chunked_ms=min(walls[CKPT_EVERY]),
            unchunked_ms=min(walls[0]), kernel=sim.last_engine,
            chunked_split=split)
        print(f"{label}: {chunks} chunks of {CKPT_EVERY} events, "
              f"launches {counts}, digests, log and CSVs match the JAX "
              f"reference; run() {run_ms:.1f} ms (its replay "
              f"{out[label]['replay_ms']:.2f} ms); warm replay wall chunked "
              f"{out[label]['chunked_ms']:.2f} ms (min of 3: "
              f"{', '.join(f'{w:.2f}' for w in walls[CKPT_EVERY])}) against "
              f"one launch {out[label]['unchunked_ms']:.2f} ms (min of 3: "
              f"{', '.join(f'{w:.2f}' for w in walls[0])}); the fastest "
              f"chunked run's host split: run digest "
              f"{split['digest_ms']:.2f} ms, chunk dispatch "
              f"{split['dispatch_ms']:.2f} ms, fetches (each waiting for its "
              f"chunk) {split['fetch_ms']:.2f} ms, checkpoint writes (each "
              f"while the next chunk runs) {split['write_ms']:.2f} ms on "
              f"{card}")
        if label != "ckpt 06-FGD":
            continue
        # one chunk boundary's parts, on the carry after the first chunk
        fn = sim._table_replay()
        types = te.build_pod_types(specs)
        evk_t = torch.as_tensor(evk, device=device)
        evp_t = torch.as_tensor(evp, device=device)
        carry = fn.init_carry(sim.init_state, specs, types, sim.typical,
                              prng_key(sim.cfg.seed), sim.rank)
        carry, (nseg, dseg) = fn.run_chunk(
            carry, specs, types, evk_t[:CKPT_EVERY], evp_t[:CKPT_EVERY],
            sim.typical, sim.rank)
        torch.cuda.synchronize()
        init_ms = kernel_ms(fe.prepare_init_tables(
            carry.state, types, sim.typical, sim._replay.config), 20)
        fetch = sorted(wall_ms(lambda: te.carry_arrays(
            carry, {"n": nseg, "d": dseg}))[0] for _ in range(5))
        arrays = te.carry_arrays(carry, {"event_node": nseg,
                                         "event_dev": dseg})
        writes = []
        for i in range(5):
            t0 = time.perf_counter()
            path = storage.save_checkpoint(os.path.join(root, "cost"),
                                           "c" * 64, CKPT_EVERY + i, arrays)
            writes.append((time.perf_counter() - t0) * 1e3)
        size = os.path.getsize(path)
        out["segment"] = dict(init_tables_ms=init_ms,
                              fetch_ms=float(np.median(fetch)),
                              write_ms=float(np.median(writes)),
                              file_bytes=size)
        print(f"ckpt segment: init_tables {init_ms:.4f} ms (CUDA events, "
              f"median of 20), carry and chunk telemetry fetch "
              f"{np.median(fetch):.3f} ms, checkpoint write "
              f"{np.median(writes):.3f} ms of {size} bytes (host clock, "
              f"median of 5, warm page cache) on {card}")
    return out


def ckpt_kill_resume(device, card: str, nodes, pods, root: str,
                     launches: dict) -> dict:
    """The 06-FGD chunked run in a child process, killed with SIGKILL once
    its checkpoint at CKPT_KILL_AT is on disk, then run again here: it
    must resume there and match the digests."""
    import signal

    from tpusim_torch.sim import fused_engine as fe

    ckdir = os.path.join(root, "kill")
    os.makedirs(ckdir, exist_ok=True)
    mark = f".e{CKPT_KILL_AT:010d}.ckpt.npz"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ckpt-child", ckdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        while not any(f.endswith(mark) for f in os.listdir(ckdir)):
            if proc.poll() is not None:
                raise SmokeFailure(f"ckpt child exited ({proc.returncode}) "
                                   f"before its checkpoint at event "
                                   f"{CKPT_KILL_AT}:\n{proc.stdout.read()}")
            if time.perf_counter() - t0 > 240:
                raise SmokeFailure("ckpt child: no checkpoint at event "
                                   f"{CKPT_KILL_AT} within 240 s")
            time.sleep(0.02)
        t_seen = time.perf_counter() - t0
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    child_out = proc.stdout.read()
    if proc.returncode != -signal.SIGKILL:
        raise SmokeFailure(f"ckpt child ended with {proc.returncode}, not "
                           f"by SIGKILL:\n{child_out}")
    left = sorted(os.listdir(ckdir))
    sim = ckpt_sim("06-FGD", "auto", device, nodes, pods,
                   checkpoint_every=CKPT_EVERY, checkpoint_dir=ckdir)
    fe.reset_launch_counts()
    run_ms, res = wall_ms(sim.run)
    counts = run_counts()
    launches["ckpt resume 06-FGD"] = counts
    resumed = [line for line in sim.log.lines if "[Checkpoint]" in line]
    if not any(f"resumed replay at event {CKPT_KILL_AT}/{OPENB_EVENTS}"
               in line for line in resumed):
        raise SmokeFailure(f"ckpt resume: no resume at event "
                           f"{CKPT_KILL_AT}: {resumed}")
    ckpt_check_run("ckpt resume 06-FGD", sim, res, "06-FGD", counts, "vmem",
                   -(-(OPENB_EVENTS - CKPT_KILL_AT) // CKPT_EVERY))
    counts = nonzero(counts)
    out = dict(child_s=t_seen, files_at_kill=len(left), run_ms=run_ms,
               replay_ms=sim.replay_times[0]["replay_ms"])
    print(f"ckpt kill/resume: the child ({child_out.strip().splitlines()[0]}"
          f") killed with SIGKILL {t_seen:.2f} s after its start, once its "
          f"checkpoint at event {CKPT_KILL_AT} was on disk ({len(left)} "
          f"files); the run again resumed there: launches {counts}, "
          f"digests, log and CSVs match the JAX reference; run() "
          f"{run_ms:.1f} ms, its replay {out['replay_ms']:.2f} ms on {card}")
    return out


def ckpt_fork(device, card: str, nodes, pods, root: str,
              launches: dict) -> dict:
    """The base run with every checkpoint kept, then schedule_pods_fork at
    CKPT_FORK_EVENT with FORK_TAIL, warm (from the base's ladder) and cold
    (an empty directory), held to FORK_SHA256; beside them a one-launch
    replay of the spliced stream."""
    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.sim import fused_engine as fe

    def sim_in(d):
        sim = ckpt_sim("06-FGD", "auto", device, nodes, pods,
                       checkpoint_every=CKPT_EVERY, checkpoint_keep=-1,
                       checkpoint_dir=os.path.join(root, d),
                       report_per_event=False)
        sim.set_typical_pods()
        return sim, sim.prepare_pods()

    base, trace = sim_in("fork")
    base_ms, _ = wall_ms(lambda: base.schedule_pods(trace))
    rungs = len(os.listdir(os.path.join(root, "fork")))
    out = dict(base_ms=base_ms, rungs=rungs)
    for mode in ("warm", "cold"):
        sim, trace = sim_in("fork" if mode == "warm" else "fork-cold")
        fe.reset_launch_counts()
        ms, res = wall_ms(lambda: sim.schedule_pods_fork(
            trace, CKPT_FORK_EVENT, *FORK_TAIL))
        counts = run_counts()
        launches[f"ckpt fork {mode}"] = counts
        check_result_digests(f"ckpt fork {mode}", res, *FORK_SHA256)
        stats = sim.last_fork
        want_cursor = CKPT_FORK_EVENT if mode == "warm" else 0
        if stats["source_cursor"] != want_cursor or \
                stats["degrade"] != (mode == "cold"):
            raise SmokeFailure(f"ckpt fork {mode}: {stats}")
        out[mode] = dict(ms=ms, events_executed=stats["events_executed"],
                         events_total=stats["events_total"],
                         launches=nonzero(counts))
    specs = pods_to_specs(trace, sim.node_index, device)
    evk, evp = build_events(trace)
    evk = np.concatenate([evk[:CKPT_FORK_EVENT], FORK_TAIL[0]])
    evp = np.concatenate([evp[:CKPT_FORK_EVENT], FORK_TAIL[1]])
    sim.cfg.checkpoint_every = 0
    plain = [wall_ms(lambda: sim.run_events(sim.init_state, specs, evk,
                                            evp))[0] for _ in range(3)]
    out["spliced_replay_ms"] = min(plain)
    print(f"ckpt fork: base run {base_ms:.1f} ms ({rungs} checkpoints kept); "
          f"fork at event {CKPT_FORK_EVENT} with the tail {FORK_TAIL}: warm "
          f"from the base's checkpoint at {CKPT_FORK_EVENT}, "
          f"{out['warm']['events_executed']} of "
          f"{out['warm']['events_total']} events executed, launches "
          f"{out['warm']['launches']}, {out['warm']['ms']:.2f} ms; cold "
          f"(no source: a full chunked replay) "
          f"{out['cold']['events_executed']} events, "
          f"{out['cold']['ms']:.2f} ms; one-launch replay of the spliced "
          f"stream {min(plain):.2f} ms (min of 3); both forks match "
          f"FORK_SHA256 on {card}")
    return out


def ckpt_table_cache(device, card: str, nodes, pods, root: str,
                     launches: dict) -> dict:
    """The table cache at openb: a miss (init_tables launched, the tables
    saved), then a hit (no init_tables launch), both replays held to the
    06-FGD digests; the hit's load timed against init_tables' launch."""
    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.table_engine import build_pod_types

    sim = ckpt_sim("06-FGD", "auto", device, nodes, pods,
                   report_per_event=False,
                   table_cache_dir=os.path.join(root, "tables"))
    sim.set_typical_pods()
    trace = sim.prepare_pods()
    specs = pods_to_specs(trace, sim.node_index, device)
    evk, evp = build_events(trace)
    row = next(r for r in METHODS if r[0] == "06-FGD")
    out = {}
    for outcome in ("miss", "hit"):
        fe.reset_launch_counts()
        ms, res = wall_ms(lambda: sim.run_events(sim.init_state, specs, evk,
                                                 evp))
        counts = run_counts()
        launches[f"ckpt table cache {outcome}"] = counts
        check_digests(f"ckpt table cache {outcome}", res, row[5], row[6])
        want = {"init_tables": int(outcome == "miss"), "replay": 1}
        if sim.last_table_cache != outcome or \
                nonzero(counts) != nonzero(want):
            raise SmokeFailure(f"ckpt table cache {outcome}: "
                               f"{sim.last_table_cache}, launches {counts}")
        out[f"{outcome}_replay_ms"] = ms
    types = build_pod_types(specs)
    loads = sorted(wall_ms(lambda: sim._cached_tables(
        sim.init_state, types))[0] for _ in range(5))
    init_ms = kernel_ms(fe.prepare_init_tables(
        sim.init_state, types, sim.typical, sim._replay.config), 20)
    out.update(hit_load_ms=float(np.median(loads)), init_tables_ms=init_ms)
    print(f"ckpt table cache: miss (init_tables launched, tables saved) "
          f"replay wall {out['miss_replay_ms']:.2f} ms, hit (no init_tables "
          f"launch) {out['hit_replay_ms']:.2f} ms, both match the JAX "
          f"digests; a hit's load {np.median(loads):.3f} ms (host clock, "
          f"median of 5, warm page cache) against init_tables' launch "
          f"{init_ms:.4f} ms (CUDA events, median of 20) on {card}")
    return out


def ckpt_path(device, card: str):
    """Phase 12: chunked replay, kill and resume, forks and the table
    cache at openb (module docstring). Returns ({run label: launch
    counts}, the phase's numbers), which chiprun_out/ckpt_phase.json
    keeps."""
    import shutil
    import tempfile

    nodes, pods = openb_rows_port()
    root = tempfile.mkdtemp(prefix="tpusim_ckpt_")
    launches = {}
    t0 = time.perf_counter()
    try:
        out = dict(card=card,
                   chunks=ckpt_chunks(device, card, nodes, pods, root,
                                      launches),
                   kill_resume=ckpt_kill_resume(device, card, nodes, pods,
                                                root, launches),
                   fork=ckpt_fork(device, card, nodes, pods, root, launches),
                   table_cache=ckpt_table_cache(device, card, nodes, pods,
                                                root, launches))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = launches
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ckpt_phase.json"), "w") as f:
        json.dump(out, f, indent=1)
    return launches, out


# ---------------------------------------------------------------------------
# Phase 13: the obs records (--only obs)
# ---------------------------------------------------------------------------

# the record forms of the replay kernels, a source each
RECORD_SOURCES = {
    "replay_record": "tpusim_torch/kernels/replay_records.cu",
    "replay_blocked_record": "tpusim_torch/kernels/replay_blocked_records.cu",
}
RECORD_KERNELS = tuple(RECORD_SOURCES)
OBS_EVERY = 100  # the series' stride of the openb record runs
OBS_PREFIX = 400  # events of the oracle's decisions against the kernels'
OBS_HEARTBEAT = 20_000  # the heartbeat's stride on the scale chunk
OBS_HEARTBEAT_EVENTS = 200_000  # the scale phase's first chunk
# tpusim's table engine on the CPU, openb 06-FGD (METHODS' configuration,
# record_decisions, series_every OBS_EVERY): sha256 of the decision
# stream's INVARIANT_FIELDS (int32, field order, block_size -1), of its
# series (SeriesLog pos..score_lo as int64), of the blocked engine's block
# column (block_size 128), its counters (the run record's, padding
# corrected) and the first event where 05-BestFit's decisions diverge
DECISIONS_SHA256 = (
    "2d199fd57240a9347a0923520de6974507e8bc0968b365a8b6217a93ec439414")
SERIES_SHA256 = (
    "ac4cad5e8676323b81575cc36ef447383b284e8728b77acf9daa75b0253193ea")
BLOCK_SHA256 = (
    "d12a7a9d2f27241d652c6132d59b0f4e54c1a8709a36c7df47230b9e96f56c05")
OBS_SAMPLES = 109
OBS_COUNTERS = {"creates": 10811, "binds": 8350, "fail_creates": 2461,
                "deletes": 0, "skips": 0, "rebuilds": 0}
BLOCKED_REBUILDS = 0
DIFF_FIRST_EVENT = 0
DIFF_DIVERGED = 8345
# the record forms alone against their plain versions: the first events of
# the openb 06-FGD trace (the plain version runs on the host)
OBS_KERNEL_EVENTS = 500


def decisions_digest(records) -> str:
    """sha256 of a DecisionRecord stream's engine-invariant fields."""
    from tpusim_torch.obs.decisions import INVARIANT_FIELDS

    h = hashlib.sha256()
    for f in INVARIANT_FIELDS:
        h.update(np.ascontiguousarray(np.asarray(getattr(records, f)),
                                      np.int32).tobytes())
    return h.hexdigest()


def series_digest(log) -> str:
    """sha256 of a SeriesLog's sample fields (pos..score_lo, int64)."""
    h = hashlib.sha256()
    for f in log._fields[:-1]:
        h.update(np.ascontiguousarray(np.asarray(getattr(log, f)),
                                      np.int64).tobytes())
    return h.hexdigest()


def record_against_plain(name: str, args, cfg, spec, key=CHECK_KEY,
                         n_real: int = None, timed: bool = False):
    """A record form (`replay` or `replay_blocked` with `spec`, a
    records.RecordSpec) launched past its wrapper on `args` = (state, pods,
    types, ev_kind, ev_pod, typical pods, rank, tables), against its plain
    version on CPU copies: the largest error over the outputs and the
    records (counters, decision and sample rows); with `timed`, (that
    error, the plain version's host milliseconds)."""
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    kw = dict(key=key) if name == "replay" else dict(n_real=n_real)
    if name == "replay":
        ready = fe.prepare_replay(*args, cfg, record=spec, **kw)
    else:
        ready = he.prepare_replay_blocked(*args, cfg, record=spec, **kw)
    fe.launch(ready)
    got = ready.finish()
    plain = fe.plain_replay if name == "replay" else he.plain_replay_blocked
    keep = {}
    cpu_spec = spec._replace(ctr=None if spec.ctr is None
                             else spec.ctr.cpu())
    cpu_args = to_cpu(args)
    t0 = time.perf_counter()
    want = plain(*cpu_args, cfg, keep=keep, record=cpu_spec, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    want = (want, keep["records"]) if name == "replay" else \
        (*want, keep["records"])
    err = max_abs_err(to_cpu(got), to_cpu(want))
    return (err, plain_ms) if timed else err


def record_reset(ready, state, tables):
    """reset_of's function for a record launch: also the counters it reads
    and writes back (zeros)."""
    base = reset_of(ready, state, tables)

    def reset():
        base()
        ready.tensors["ctr"].zero_()
    return reset


def obs_runs(device, card: str, nodes, pods) -> dict:
    """The openb 06-FGD record runs through Simulator.run(), residency auto
    (`replay`'s record form) and hbm (`replay_blocked`'s): launches,
    placements against METHODS, decisions, series and counters against
    tpusim's digests; the blocked decisions' block column against the
    JAX blocked engine's."""
    import torch

    from tpusim_torch.obs.counters import INVARIANT_FIELDS
    from tpusim_torch.sim import fused_engine as fe

    row = next(r for r in METHODS if r[0] == "06-FGD")
    out = {}
    for setting, tier in (("auto", "vmem"), ("hbm", "hbm")):
        label = f"obs 06-FGD/{setting}"
        sim = ckpt_sim("06-FGD", setting, device, nodes, pods,
                       report_per_event=False, record_decisions=True,
                       series_every=OBS_EVERY)
        fe.reset_launch_counts()
        ms, res = wall_ms(sim.run)
        counts = run_counts()
        kernel = "replay_record" if tier == "vmem" else \
            "replay_blocked_record"
        if nonzero(counts) != {"init_tables": 1, kernel: 1}:
            raise SmokeFailure(f"{label}: launches {nonzero(counts)}")
        check_result_digests(label, res, row[5], row[6])
        rec = res.decisions.records
        got = dict(decisions=decisions_digest(rec),
                   series=series_digest(res.series),
                   samples=int(len(res.series.pos)),
                   counters=res.telemetry.counters)
        block = np.asarray(rec.block)
        if tier == "hbm":
            got["block"] = digest(block, np.int32)
        elif (block != -1).any():
            raise SmokeFailure(f"{label}: a flat decision carries a block")
        invariant = {k: got["counters"][k] for k in INVARIANT_FIELDS}
        want_ctr = {k: OBS_COUNTERS[k] for k in INVARIANT_FIELDS}
        if (got["decisions"] != DECISIONS_SHA256
                or got["series"] != SERIES_SHA256
                or got["samples"] != OBS_SAMPLES or invariant != want_ctr
                or got.get("block", BLOCK_SHA256) != BLOCK_SHA256):
            raise SmokeFailure(f"{label}: records differ from tpusim's: "
                               f"{got}")
        print(f"obs {label}: {kernel} decisions sha256 {got['decisions']}, "
              f"series sha256 {got['series']} ({got['samples']} samples), "
              f"counters {got['counters']}"
              + (f", block sha256 {got['block']}" if "block" in got else "")
              + f", run {ms:.1f} ms (all equal tpusim's); card {card}")
        out[setting] = dict(got, run_ms=ms, launches=counts, sim=sim,
                            result=res)
    if out["hbm"]["counters"]["rebuilds"] != BLOCKED_REBUILDS:
        raise SmokeFailure(f"obs: replay_blocked's rebuilds "
                           f"{out['hbm']['counters']['rebuilds']}, the JAX "
                           f"blocked engine's {BLOCKED_REBUILDS}")
    torch.cuda.synchronize()
    return out


def obs_oracle(device, card: str, nodes, pods, kernel_res) -> dict:
    """The sequential oracle's decisions over the first OBS_PREFIX events
    of the openb 06-FGD run, on the card, against the kernel's."""
    from tpusim_torch.io.trace import build_events, pods_to_specs
    from tpusim_torch.obs.decisions import INVARIANT_FIELDS

    sim = ckpt_sim("06-FGD", "auto", device, nodes, pods,
                   report_per_event=False, record_decisions=True,
                   engine="sequential")
    sim.set_typical_pods()
    trace = sim.prepare_pods()[:OBS_PREFIX]
    evk, evp = build_events(trace)
    ms, out = wall_ms(lambda: sim.run_events(
        sim.init_state, pods_to_specs(trace, sim.node_index, device), evk,
        evp))
    want = kernel_res.decisions.records
    for f in INVARIANT_FIELDS:
        a = np.asarray(getattr(out.decisions, f).cpu())
        b = np.asarray(getattr(want, f))[:OBS_PREFIX]
        if not np.array_equal(a, b):
            raise SmokeFailure(f"obs oracle: {f} differs from the kernel's "
                               f"at event {int(np.argwhere(a != b)[0][0])}")
    print(f"obs oracle: the sequential oracle's {OBS_PREFIX} decisions on "
          f"the card equal replay_record's ({ms:.0f} ms)")
    return dict(events=OBS_PREFIX, ms=ms)


def obs_diff(device, root: str, nodes, pods, fgd) -> dict:
    """`diff` of 06-FGD's decision file against 05-BestFit's (both from
    record runs on the card): exit code 1 and tpusim's first divergent
    event."""
    import contextlib
    import io

    from tpusim_torch.cli import main as cli_main
    from tpusim_torch.obs.decisions import write_decisions

    paths = {}
    for mid, sim, res in (("06-FGD", fgd["sim"], fgd["result"]),
                          ("05-BestFit", None, None)):
        if sim is None:
            sim = ckpt_sim(mid, "auto", device, nodes, pods,
                           report_per_event=False, record_decisions=True)
            res = sim.run()
        paths[mid] = write_decisions(
            os.path.join(root, f"{mid}.jsonl"), res.decisions,
            list(sim.cfg.policies), sim._telemetry_meta(),
            [p.name for p in res.pods])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli_main(["diff", paths["06-FGD"], paths["05-BestFit"]])
    text = buf.getvalue()
    if code != 1 or f"first divergence at event {DIFF_FIRST_EVENT} " not in \
            text or f"{DIFF_DIVERGED} diverged placements" not in text:
        raise SmokeFailure(f"obs diff: exit {code}, want 1 and event "
                           f"{DIFF_FIRST_EVENT}:\n{text}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli_main(["explain", paths["06-FGD"], "--event",
                         str(DIFF_FIRST_EVENT)])
    if code != 0:
        raise SmokeFailure(f"obs explain: exit {code}")
    print("obs diff (06-FGD vs 05-BestFit):\n" + text.rstrip())
    print("obs explain:\n" + buf.getvalue().rstrip())
    return dict(first=DIFF_FIRST_EVENT, diverged=DIFF_DIVERGED)


def obs_profile(device, card: str, root: str, nodes, pods) -> dict:
    """A profiled openb 06-FGD run (per-event reports on, decisions, the
    series): its spans, and its JSONL, Prometheus and Chrome files written
    and parsed back."""
    from tpusim_torch.obs import emitters
    from tpusim_torch.obs.series import series_to_record, series_tracks

    sim = ckpt_sim("06-FGD", "auto", device, nodes, pods, profile=True,
                   record_decisions=True, series_every=OBS_EVERY)
    ms, res = wall_ms(sim.run)
    tel = sim.run_telemetry()
    series = series_to_record(res.series, OBS_EVERY, ["FGDScore"])
    record = emitters.build_record(tel, series=series)
    tracks = sim.event_counter_series()
    tracks.update(series_tracks(res.series))
    files = dict(jsonl=os.path.join(root, "p.jsonl"),
                 metrics=os.path.join(root, "m.prom"),
                 trace=os.path.join(root, "t.json"))
    emitters.emit_record(record, tel.spans, counter_series=tracks, **files)
    back = emitters.read_jsonl(files["jsonl"])[-1]
    prom = emitters.parse_prometheus_text(open(files["metrics"]).read())
    with open(files["trace"]) as f:
        trace = json.load(f)["traceEvents"]
    names = {s.name for s in tel.spans}
    need = {"typical_pods", "scan", "metrics_postpass", "fetch", "report"}
    if back != json.loads(json.dumps(record)) or not need <= names or \
            prom[("tpusim_events_total", ())] != tel.events or \
            not any(e["ph"] == "C" for e in trace):
        raise SmokeFailure(f"obs profile: spans {sorted(names)}, files do "
                           "not read back")
    spans = {}
    for s in tel.spans:
        d = spans.setdefault(s.name, dict(count=0, dispatch_s=0.0,
                                          block_s=0.0))
        d["count"] += 1
        d["dispatch_s"] += s.dispatch_s
        d["block_s"] += s.block_s
    for name, d in spans.items():
        print(f"obs span {name}: {d['count']}x dispatch "
              f"{d['dispatch_s'] * 1e3:.1f} ms block "
              f"{d['block_s'] * 1e3:.1f} ms")
    print(f"obs profile: {len(prom)} Prometheus series, {len(trace)} trace "
          f"events, run {ms:.0f} ms, wall_s {record['timing']['wall_s']}; "
          f"card {card}")
    return dict(spans=spans, run_ms=ms, prom_series=len(prom),
                trace_events=len(trace))


def obs_heartbeat(device, card: str, auto) -> dict:
    """The heartbeat over the scale phase's first chunk (100k nodes,
    OBS_HEARTBEAT_EVENTS events, `replay_blocked`'s record form): exactly
    one tick a stride crossing, plus the final one, from the mapped ring,
    beside the same chunk without records (host clock); then both kernels
    alone over the chunk's first tenth."""
    from tpusim_torch.obs import heartbeat
    from tpusim_torch.sim import fused_engine as fe

    sim = auto.sim
    e = min(OBS_HEARTBEAT_EVENTS, len(auto.ev_kind))
    args = (sim.init_state, auto.specs, auto.ev_kind[:e], auto.ev_pod[:e],
            auto.types)
    plain_ms, _ = wall_ms(lambda: sim.run_events(*args))
    sim.cfg.heartbeat_every = OBS_HEARTBEAT
    sim._table = None
    lines = []
    try:
        fe.reset_launch_counts()
        real = heartbeat.configure

        def configure(*a, **k):
            real(*a, **dict(k, sink=lines.append))
        heartbeat.configure = configure
        ms, _ = wall_ms(lambda: sim.run_events(*args))
        ticks = heartbeat.tick_count()
    finally:
        heartbeat.configure = real
        sim.cfg.heartbeat_every = 0
        sim._table = None
    counts = nonzero(run_counts())
    want = e // OBS_HEARTBEAT + 1
    if ticks != want or counts.get("replay_blocked_record") != 1:
        raise SmokeFailure(f"obs heartbeat: {ticks} ticks, want {want}; "
                           f"launches {counts}")
    # the kernels alone over the chunk's first tenth (CUDA events, median
    # of 3): the record form counting only (no ring, decision or sample)
    # against the form that records nothing
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.records import RecordSpec

    cut = e // 10
    st, rk = pad_nodes(sim.init_state, sim.rank, 128)
    cfg = sim._replay.config
    tables = fe.init_tables(st, auto.types, sim.typical, cfg)
    kargs = (st, auto.specs, auto.types,
             torch.as_tensor(auto.ev_kind[:cut], device=device),
             torch.as_tensor(auto.ev_pod[:cut], device=device), sim.typical,
             rk, tables)
    rec = he.prepare_replay_blocked(*kargs, cfg, record=RecordSpec(),
                                    n_real=sim.init_state.num_nodes)
    base = he.prepare_replay_blocked(*kargs, cfg)
    rec_ms = kernel_ms(rec, 3, record_reset(rec, st, tables))
    base_ms = kernel_ms(base, 3, reset_of(base, st, tables))
    print(f"obs heartbeat: {ticks} ticks over {e} events at {OBS_HEARTBEAT} "
          f"({len(lines)} lines printed, the rest rate-limited), "
          f"{sim.last_engine}, run_events {ms:.0f} ms against {plain_ms:.0f} "
          f"ms without records (host clock); the kernels alone over {cut} "
          f"events: the record form counting only {rec_ms:.2f} ms, the "
          f"form that records nothing {base_ms:.2f} ms; card {card}")
    return dict(events=e, every=OBS_HEARTBEAT, ticks=ticks, ms=ms,
                plain_ms=plain_ms, lines=len(lines), kernel_events=cut,
                counting_kernel_ms=rec_ms, unrecorded_kernel_ms=base_ms)


def record_bound(n: int, k: int, t: int, p: int, e: int, n_pol: int,
                 creates: int, samples: int, refreshes: int, ops: float):
    """(ms, what bounds it) of a record form as throughput_bound counts the
    replay, plus the records: each decision's four passes read the type's
    feasibility and score rows (4 (n_pol + 1) N bytes each) and do about
    4 n_pol operations a node, each sample reads the cluster's state and
    the type's rows (as a create) and does about 24 operations per (node,
    typical pod) for the frag amounts, and the rows are written."""
    from tpusim_torch.sim.records import dec_cols, ser_cols

    state_bytes = n * (1 + 1 + 1 + 1 + 8 + 1) * 4
    extra = (creates * 4 * 4 * (n_pol + 1) * n
             + samples * (state_bytes + 2 * 4 * (n_pol + 1) * n)
             + e * dec_cols(n_pol) * 4 + samples * ser_cols(n_pol) * 4)
    base_ms, _ = throughput_bound(n, k, t, p, e, n_pol, refreshes, ops,
                                  extra)
    rec_ops = refreshes * ops + creates * 4 * 4 * n_pol * n \
        + samples * 24 * n * t
    by_ops = rec_ops / PEAK_INT32_PER_S * 1e3
    return (by_ops, "operations") if by_ops > base_ms else (base_ms, "bytes")


def obs_kernels(device, card: str) -> dict:
    """Each record form alone against its plain version on the openb
    06-FGD prefix (OBS_KERNEL_EVENTS events; decisions and the series at
    OBS_EVERY): tolerance 0, CUDA events (median of 3) beside the form
    that records nothing, the plain version's host time, the bound; and a
    random blocked case of a normalised configuration."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.records import RecordSpec

    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    e = OBS_KERNEL_EVENTS
    evk, evp = evk[:e], evp[:e]
    cfg = fe.make_config([("FGDScore", 1000)], "FGDScore")
    spec = RecordSpec(True, OBS_EVERY, 0)
    kinds = evk.cpu().numpy()
    rows = {}
    for name in RECORD_KERNELS:
        blocked = name == "replay_blocked_record"
        st, rk = (pad_nodes(state, rank, 128) if blocked else (state, rank))
        tables = fe.init_tables(st, types, tp, cfg)
        args = (st, specs, types, evk, evp, tp, rk, tables)
        n_real = state.num_nodes
        err, plain_ms = record_against_plain(name[:-7], args, cfg, spec,
                                             n_real=n_real, timed=True)
        prep = he.prepare_replay_blocked if blocked else fe.prepare_replay
        kw = dict(n_real=n_real) if blocked else dict(key=CHECK_KEY)
        rec = prep(*args, cfg, record=spec, **kw)
        base = prep(*args, cfg, **kw)
        rec_ms = kernel_ms(rec, 3, record_reset(rec, st, tables))
        base_ms = kernel_ms(base, 3, reset_of(base, st, tables))
        got = rec.finish()
        result = got[0]
        refreshes = refreshes_of(result.event_node.cpu())
        creates = int((kinds == 0).sum())
        samples = int(got[-1].ser.shape[0])
        ops = float(node_ops(cfg, state, types, tp).mean())
        bound, by = record_bound(st.num_nodes, types.num_types, tp.size,
                                 int(specs.cpu.shape[0]), e, 1, creates,
                                 samples, refreshes, ops)
        rows[name] = dict(max_abs_err=err, ms=rec_ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by, events=e,
                          unrecorded_ms=base_ms,
                          record_us_per_event=(rec_ms - base_ms) * 1e3 / e,
                          samples=samples)
        print(f"obs kernel {name}: max_abs_err {err} against its plain "
              f"version, {rec_ms:.3f} ms over {e} openb events "
              f"({base_ms:.3f} ms without records: "
              f"{(rec_ms - base_ms) * 1e3 / e:.2f} us an event to record), "
              f"plain {plain_ms:.0f} ms, bound {bound:.4f} ms ({by}); "
              f"card {card}")
    # a normalised configuration with pinned pods, flat and blocked
    cfg = fe.make_config([("PWRScore", 500), ("BestFitScore", 300),
                          ("FGDScore", 200)], "FGDScore")
    state, pods, types, evk, evp, tp, rank = random_case(47, 300, 150,
                                                         device)
    for name in RECORD_KERNELS:
        blocked = name == "replay_blocked_record"
        st, rk = (pad_nodes(state, rank, 128) if blocked else (state, rank))
        tables = fe.init_tables(st, types, tp, cfg)
        err = record_against_plain(
            name[:-7], (st, pods, types, evk, evp, tp, rk, tables), cfg,
            RecordSpec(True, 7, 0, torch.tensor([3, 3, 0, 0, 4, 0],
                                                dtype=torch.int32,
                                                device=device), 7),
            n_real=state.num_nodes)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        rows[name]["random_err"] = err
    if any(r["max_abs_err"] for r in rows.values()):
        raise SmokeFailure(f"obs kernels: a record form differs from its "
                           f"plain version: {rows}")
    return rows


def obs_path(device, card: str, auto=None):
    """Phase 13: the obs records (module docstring). Returns ({run label:
    launch counts}, the record forms' kernel rows); chiprun_out/
    obs_phase.json keeps the phase's numbers."""
    import shutil
    import tempfile

    nodes, pods = openb_rows_port()
    root = tempfile.mkdtemp(prefix="tpusim_obs_")
    t0 = time.perf_counter()
    try:
        runs = obs_runs(device, card, nodes, pods)
        out = dict(card=card, runs={k: {f: v[f] for f in v
                                        if f not in ("sim", "result")}
                                    for k, v in runs.items()})
        out["oracle"] = obs_oracle(device, card, nodes, pods,
                                   runs["auto"]["result"])
        out["diff"] = obs_diff(device, root, nodes, pods, runs["auto"])
        out["profile"] = obs_profile(device, card, root, nodes, pods)
        out["kernels"] = obs_kernels(device, card)
        if auto is None:
            auto = scale_inputs(device)[2]
        out["heartbeat"] = obs_heartbeat(device, card, auto)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    launches = {f"obs 06-FGD/{k}": v["launches"]
                for k, v in out["runs"].items()}
    print(f"obs phase: {out['phase_s']:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "obs_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return launches, out["kernels"]


def record_kernel_rows(rec_rows, launches):
    """The kernels line's rows of the record forms: their numbers on the
    openb 06-FGD prefix (the record form and its plain version on the same
    inputs), and their launches on the obs phase's runs."""
    rows = []
    for name in RECORD_KERNELS:
        r = dict(rec_rows[name])
        rows.append(dict(
            name=name, route="cuda", source=RECORD_SOURCES[name],
            replaces=REPLACES[name[:-7]],
            launches=sum(c.get(name, 0) for c in launches.values()),
            max_abs_err=r.pop("max_abs_err"), ms=r.pop("ms"),
            plain_ms=r.pop("plain_ms"), bound_ms=r.pop("bound_ms"),
            bound_by=r.pop("bound_by"), library_ms=None, **r))
    return rows


# ---------------------------------------------------------------------------
# Phase 14: the learned policy (tpusim_torch.learn): the learned columns of
# the replay kernels, the teacher-forced form, tune and imitate
# ---------------------------------------------------------------------------

# the parameter vectors of the openb learned runs: the linear family's
# (tests/test_policy_learned.py THETA) and the bucketed family's, every
# entry nonzero
LEARN_THETA = (700, -120, 45, 10, 80, -60, 33, 25, -200, 50)
LEARN_THETA_B = LEARN_THETA + (15, -25, 35, -45, 55, -65, 75, -85, 95, -105)
# the digests of the JAX package's Simulator.run() of each family on openb
# (the METHODS rows' protocol: tune 1.3, tuning seed 42, seed 42, shuffled,
# gpu_sel best; its table engine): placed_node and dev_mask sha256.
# tests/test_torch_learned.py pins them against tpusim.
LEARN_SHA256 = {
    "linear": (
        "8f5829f247ea47ee38f9c5c676d7726329dd64beb5bb65dae8aaafe7afeccf78",
        "26ef58415ec1afd143101abadc53da94f3e839d0b8df8557a26ad0d46316be1c"),
    "bucketed": (
        "e904c709223d484cb91e0112bf5fd9f164d2fd173ccd9e3e0368d33abbf2e6f5",
        "d100a61073e85b6d84758c1174a0fabb1737234944253275216c27764b92ff9f"),
}
# events of each family's kernels held to their plain versions (CPU copies)
LEARN_PREFIX = {"linear": 500, "bucketed": 250}
LEARN_RECORD_EVENTS = 150  # the record forms against their plain versions
LEARN_RECORD_EVERY = 25
LEARN_LANES_EVENTS = 150  # the lanes kernels against their plain versions
# the sweep's 8 parameter vectors
LEARN_SWEEP = tuple(tuple(w + 37 * (i + 1) * (1 - 2 * (j % 2))
                          for j, w in enumerate(LEARN_THETA))
                    for i in range(8))
# tests/test_policy_learned.py's openb acceptance prefix; `tune` through
# the CLI on it, and imitation of its recorded FGD teacher
LEARN_PODS = 400
LEARN_TUNE_FLAGS = ("--max-pods", "400", "--policy", "learned",
                    "--generations", "3", "--popsize", "8", "--sigma", "600",
                    "--lr", "500", "--seed", "11")
# `python -m tpusim tune` with those flags: its tuning log's sha256 and its
# standard output's, the log path written as LOG
TUNE_LOG_SHA256 = (
    "e24dc93f1e85f11db6b3ae269ecdcc7e9a80c1a02930c05176c567d311cc012f")
TUNE_STDOUT_SHA256 = (
    "9daed5620f30b29e868a9b8874320208bad7b876a3a81a24019016519b3868b3")
# tpusim's openb acceptance of imitation: the FGD teacher's decision file,
# the imitated theta and its held-out agreement
TEACHER_SHA256 = (
    "b2b7ec4015ee8b01245ebdff713928eb44c4e66ee74b994bd34c95eb3ae79d0a")
IMITATE_THETA = [25, 0, 0, 0, 0, 0, 0, 0, 0, 0]
IMITATE_HOLDOUT = {"matches": 80, "creates": 80, "agreement": 1.0}
FORCED_PREFIX = 100  # replay_forced against its plain version
# merged steps of the learned fault forms against their plain versions
# (the lane phase's FAULT_FLAGS schedule on openb)
LEARN_FAULT_STEPS = 500
LEARNED_SOURCES = {
    "init_tables_learned": "tpusim_torch/kernels/replay_learned.cu",
    "replay_learned": "tpusim_torch/kernels/replay_learned.cu",
    "replay_blocked_learned": "tpusim_torch/kernels/replay_blocked_learned.cu",
    "replay_lanes_learned": "tpusim_torch/kernels/replay_learned.cu",
    "replay_blocked_lanes_learned":
        "tpusim_torch/kernels/replay_blocked_learned.cu",
    "replay_learned_record": "tpusim_torch/kernels/replay_learned_records.cu",
    "replay_blocked_learned_record":
        "tpusim_torch/kernels/replay_learned_records.cu",
    "replay_learned_faults": "tpusim_torch/kernels/replay_learned_faults.cu",
    "replay_lanes_learned_faults":
        "tpusim_torch/kernels/replay_learned_faults.cu",
    "replay_blocked_learned_faults":
        "tpusim_torch/kernels/replay_blocked_learned_faults.cu",
    "replay_blocked_lanes_learned_faults":
        "tpusim_torch/kernels/replay_blocked_learned_faults.cu",
    "replay_forced": "tpusim_torch/kernels/replay_forced.cu",
}
LEARNED_KERNELS = tuple(LEARNED_SOURCES)
REPLACES.update({
    "init_tables_learned": REPLACES["init_tables"],
    "replay_learned": REPLACES["replay"],
    "replay_blocked_learned": REPLACES["replay_blocked"],
    "replay_lanes_learned": REPLACES["replay"],
    "replay_blocked_lanes_learned": REPLACES["replay_blocked"],
    "replay_learned_record": REPLACES["replay"],
    "replay_blocked_learned_record": REPLACES["replay_blocked"],
    "replay_learned_faults": REPLACES["replay"],
    "replay_lanes_learned_faults": REPLACES["replay"],
    "replay_blocked_learned_faults": REPLACES["replay_blocked"],
    "replay_blocked_lanes_learned_faults": REPLACES["replay_blocked"],
    "replay_forced": REPLACES["replay"],
})


def learn_families() -> dict:
    from tpusim_torch.learn.policy import BUCKETED_FEATURES, learned_policies

    return {"linear": learned_policies(LEARN_THETA),
            "bucketed": learned_policies(LEARN_THETA_B, BUCKETED_FEATURES)}


def learn_config(policies, residency: str, **knobs):
    """The METHODS rows' protocol on openb for a learned family (gpu_sel
    best, per-event reports off)."""
    import dataclasses

    from tpusim_torch.__main__ import method_config

    return dataclasses.replace(
        method_config(policies, gpu_sel="best", report_per_event=False),
        table_residency=residency, **knobs)


def learned_ops(cfg, state, types, tp) -> np.ndarray:
    """node_ops for a learned configuration: frag_delta's column as FGD's;
    the node column's features once a node (its three float32 tree sums
    over the T typical pods, about 12 operations a pod each, and about 60
    integer operations); fit_dev_pct's 10 a type. int64 [N]."""
    from tpusim_torch.sim import fused_engine as fe

    ops = np.zeros(state.num_nodes, np.int64)
    names = [p.name for p in cfg.policies]
    if "LearnedScore[frag_delta]" in names:
        ops += node_ops(fe.make_config([("FGDScore", 1)], "best"), state,
                        types, tp)
    if "LearnedNode" in names:
        ops += 36 * tp.size + 60
    if "LearnedScore[fit_dev_pct]" in names:
        ops += 10 * types.num_types
    return ops


def learn_runs(device, card: str, nodes, pods) -> dict:
    """The full openb trace through Simulator.run() under each family,
    residency vmem and hbm: the launch counts set to 0 before each run and
    read after it (init_tables_learned and the residency's learned replay,
    once each, and no other replay), the placements and masks against the
    JAX package's digests (LEARN_SHA256), the warm replay wall."""
    import torch

    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator

    out = {}
    want = {"vmem": "replay_learned", "hbm": "replay_blocked_learned"}
    for fam, pol in learn_families().items():
        for res in ("vmem", "hbm"):
            label = f"learn {fam}/{res}"
            sim = Simulator(nodes, learn_config(pol, res), device)
            sim.set_workload_pods(list(pods))
            fe.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = sim.run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = nonzero(run_counts())
            if counts != {"init_tables_learned": 1, want[res]: 1}:
                raise SmokeFailure(f"{label}: launches {counts}, want "
                                   f"init_tables_learned and {want[res]} "
                                   "once each")
            got = (digest(np.asarray(r.placed_node), np.int32),
                   digest(np.asarray(r.dev_mask), np.uint8))
            if got != LEARN_SHA256[fam]:
                raise SmokeFailure(f"{label}: differs from the JAX reference:"
                                   f" placed sha256 {got[0]} dev_mask sha256 "
                                   f"{got[1]}")
            warm, _ = wall_ms(lambda: sim.run())
            print(f"learn openb {fam}/{res}: {r.events} events, placements "
                  f"and masks match the JAX digests; launches {counts}; "
                  f"Simulator.run() {wall:.0f} ms cold, {warm:.0f} ms warm, "
                  f"on {card}")
            out[f"{fam}/{res}"] = dict(launches=counts, events=r.events,
                                       cold_ms=wall, warm_ms=warm)
    return out


def learn_kernel_checks(device, card: str) -> dict:
    """init_tables, replay and replay_blocked of each family against their
    plain versions (CPU copies) on the openb trace's first LEARN_PREFIX
    events, tolerance 0 with the final tables and summaries; the kernels
    timed on the whole trace (placements held to LEARN_SHA256) beside
    06-FGD's replay and replay_blocked on the same inputs, and their
    bounds."""
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he

    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    n, k, t = state.num_nodes, types.num_types, tp.size
    e, p = evk.shape[0], specs.cpu.shape[0]
    kinds, pods = evk.cpu().numpy(), evp.cpu().numpy()
    bstate, brank = pad_nodes(state, rank, 128)
    fgd = fe.make_config([("FGDScore", 1000)], "FGDScore")
    fgd_tables = fe.init_tables(state, types, tp, fgd)
    ready = fe.prepare_replay(state, specs, types, evk, evp, tp, rank,
                              fgd_tables, fgd)
    fgd_ms = kernel_ms(ready, 3, reset_of(ready, state, fgd_tables))
    btables = fe.init_tables(bstate, types, tp, fgd)
    ready = he.prepare_replay_blocked(bstate, specs, types, evk, evp, tp,
                                      brank, btables, fgd)
    fgd_blocked_ms = kernel_ms(ready, 3, reset_of(ready, bstate, btables))
    rows = {name: {} for name in ("init_tables_learned", "replay_learned",
                                  "replay_blocked_learned")}
    for fam, pol in learn_families().items():
        cfg = fe.make_config(pol, "best")
        m = LEARN_PREFIX[fam]
        ready = fe.prepare_init_tables(state, types, tp, cfg)
        init_ms = kernel_ms(ready, 5)
        tables = ready.finish()
        plain_init, want = wall_ms(lambda: fe.plain_init_tables(
            *to_cpu((state, types, tp)), cfg))
        err_init = max_abs_err(to_cpu(tables), want)
        ops = learned_ops(cfg, state, types, tp)
        n_pol = cfg.num_tables
        init_bound = bound_ms(
            n * (1 + 1 + 1 + 1 + 8 + 9 + 1 + 1) * 4 + 5 * k * 4 + 5 * t * 4
            + (n_pol + 2) * k * n * 4, int(ops.sum()))
        rows["init_tables_learned"][fam] = dict(
            ms=init_ms, plain_ms=plain_init, max_abs_err=err_init,
            bound_ms=init_bound[0], bound_by=init_bound[1])
        print(f"check openb init_tables_learned {fam} [{n_pol}x{k}, {n}]: "
              f"max_abs_err={err_init} (tolerance 0); {init_ms:.4f} ms "
              f"(plain {plain_init:.1f} ms on the CPU), on {card}")
        btab = fe.init_tables(bstate, types, tp, cfg)
        for name, args in (
                ("replay_learned",
                 (state, specs, types, evk, evp, tp, rank, tables)),
                ("replay_blocked_learned",
                 (bstate, specs, types, evk, evp, tp, brank, btab))):
            base = "replay" if name == "replay_learned" else "replay_blocked"
            prep = fe.prepare_replay if base == "replay" else \
                he.prepare_replay_blocked
            ready = prep(*args, cfg)
            full_ms = kernel_ms(ready, 3, reset_of(ready, args[0], args[7]))
            got = ready.finish()
            check_digests(f"{name} {fam}", got if base == "replay" else
                          got[0], *LEARN_SHA256[fam])
            placed = (got if base == "replay" else got[0]).placed_node
            refreshes = placed_refreshes(kinds, pods, placed)
            cut = tuple(args[:3]) + (evk[:m], evp[:m]) + tuple(args[5:])
            ready = prep(*cut, cfg)
            prefix_ms = kernel_ms(ready, 3, reset_of(ready, args[0], args[7]))
            t0 = time.perf_counter()
            err = against_plain(base, cut, cfg, plain_on_cpu=True)
            both_ms = (time.perf_counter() - t0) * 1e3
            extra = 4 * k * (args[0].num_nodes // 128) * 3 \
                if base == "replay_blocked" else 0
            bound = throughput_bound(args[0].num_nodes, k, t, p, e, n_pol,
                                     refreshes, ops.mean(), extra)
            print(f"check openb {name} {fam} E={m}: max_abs_err={err} with "
                  f"final tables{' and summaries' if extra else ''} "
                  f"(tolerance 0); kernel {prefix_ms:.3f} ms on the prefix "
                  f"(plain and kernel together {both_ms:.0f} ms); whole "
                  f"trace {full_ms:.3f} ms beside 06-FGD's {base} "
                  f"{fgd_ms if base == 'replay' else fgd_blocked_ms:.3f} ms "
                  f"(bound {bound[0]:.5f} ms by {bound[1]}), on {card}")
            if err:
                raise SmokeFailure(f"{name} disagrees with its plain version "
                                   f"on openb under the {fam} family")
            rows[name][fam] = dict(
                ms=full_ms, prefix_events=m, prefix_ms=prefix_ms,
                plain_ms=both_ms, max_abs_err=err, bound_ms=bound[0],
                bound_by=bound[1],
                fgd_ms=fgd_ms if base == "replay" else fgd_blocked_ms)
        for name in ("init_tables_learned", "replay_learned",
                     "replay_blocked_learned"):
            rows[name][fam]["n_pol"] = n_pol
    return rows


def learn_records(device, card: str, nodes, pods) -> dict:
    """A linear-family record run through Simulator.run() (residency vmem
    and hbm): every create's decision holds sum theta x norm == total over
    the family's features; then both learned record forms against their
    plain versions on the openb prefix (decisions and the series at a
    stride), tolerance 0."""
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator
    from tpusim_torch.sim.records import RecordSpec

    pol = learn_families()["linear"]
    theta = np.asarray([w for _, w in pol], np.int64)
    out = {}
    want = {"vmem": "replay_learned_record",
            "hbm": "replay_blocked_learned_record"}
    for res in ("vmem", "hbm"):
        sim = Simulator(nodes, learn_config(pol, res, record_decisions=True),
                        device)
        sim.set_workload_pods(list(pods))
        fe.reset_launch_counts()
        r = sim.run()
        counts = nonzero(run_counts())
        if counts.get(want[res], 0) < 1:
            raise SmokeFailure(f"learn record {res}: launches {counts}")
        rec = r.decisions.records
        node, total = np.asarray(rec.node), np.asarray(rec.total)
        norm = np.asarray(rec.norm, np.int64)
        creates = (np.asarray(r.decisions.ev_kind) == 0) & (node >= 0)
        sums = (norm[creates] @ theta + 2**31) % 2**32 - 2**31
        bad = int((sums != total[creates]).sum())
        got = (digest(np.asarray(r.placed_node), np.int32),
               digest(np.asarray(r.dev_mask), np.uint8))
        if got != LEARN_SHA256["linear"]:
            raise SmokeFailure(f"learn record {res}: differs from the JAX "
                               f"reference: {got}")
        print(f"learn record linear/{res}: {int(creates.sum())} creates, "
              f"sum theta x norm == total on {int(creates.sum()) - bad} "
              f"(mismatches {bad}); launches {counts}")
        if bad:
            raise SmokeFailure(f"learn record {res}: {bad} decisions whose "
                               "per-feature sum is not their total")
        out[res] = dict(creates=int(creates.sum()), launches=counts)
    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    m = LEARN_RECORD_EVENTS
    spec = RecordSpec(decisions=True, series_every=LEARN_RECORD_EVERY)
    cfg = fe.make_config(pol, "best")
    rows = {}
    for name, (st, rk) in (("replay_learned_record", (state, rank)),
                           ("replay_blocked_learned_record",
                            pad_nodes(state, rank, 128))):
        tables = fe.init_tables(st, types, tp, cfg)
        args = (st, specs, types, evk[:m], evp[:m], tp, rk, tables)
        base = "replay" if name == "replay_learned_record" else \
            "replay_blocked"
        err, plain_ms = record_against_plain(
            base, args, cfg, spec, n_real=state.num_nodes, timed=True)
        if base == "replay":
            ready = fe.prepare_replay(*args, cfg, record=spec)
        else:
            from tpusim_torch.sim import hbm_engine as he

            ready = he.prepare_replay_blocked(*args, cfg, record=spec,
                                              n_real=state.num_nodes)
        ms = kernel_ms(ready, 3, record_reset(ready, st, tables))
        creates = int((evk[:m] == 0).sum())
        n, k, t = st.num_nodes, types.num_types, tp.size
        bound = record_bound(
            n, k, t, specs.cpu.shape[0], m, len(cfg.fam), creates,
            m // LEARN_RECORD_EVERY + 1, m,
            learned_ops(cfg, st, types, tp).mean())
        print(f"check openb {name} E={m}: max_abs_err={err} over outputs, "
              f"decision and sample rows (tolerance 0); {ms:.3f} ms (plain "
              f"{plain_ms:.0f} ms on the CPU; bound {bound[0]:.5f} ms by "
              f"{bound[1]}), on {card}")
        if err:
            raise SmokeFailure(f"{name} disagrees with its plain version")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                          events=m, bound_ms=bound[0], bound_by=bound[1])
    out["kernels"] = rows
    return out


def learn_sweep(device, card: str, nodes, pods) -> dict:
    """Simulator.run_sweep over LEARN_SWEEP's 8 parameter vectors (one
    init_tables_learned and one replay_lanes_learned launch), each lane held
    to a standalone run of its vector; the lanes kernels against their
    plain versions (two lanes of different vectors, the first
    LEARN_LANES_EVENTS events)."""
    from tpusim_torch.learn.policy import learned_policies
    from tpusim_torch.ops.prng import prng_key
    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator

    pol = learn_families()["linear"]
    sim = Simulator(nodes, learn_config(pol, "vmem"), device)
    sim.set_workload_pods(list(pods))
    fe.reset_launch_counts()
    wall, lanes = wall_ms(lambda: sim.run_sweep(
        np.asarray(LEARN_SWEEP, np.int32), seeds=[42] * len(LEARN_SWEEP)))
    counts = nonzero(run_counts())
    if counts != {"init_tables_learned": 1, "replay_lanes_learned": 1}:
        raise SmokeFailure(f"learn sweep: launches {counts}")
    for row, lane in zip(LEARN_SWEEP, lanes):
        one = Simulator(nodes, learn_config(learned_policies(row), "vmem"),
                        device)
        one.set_workload_pods(list(pods))
        r = one.run()
        if not (np.array_equal(lane.placed_node, np.asarray(r.placed_node))
                and np.array_equal(lane.dev_mask, np.asarray(r.dev_mask))):
            raise SmokeFailure(f"learn sweep: the lane of {row} differs "
                               "from its standalone run")
    print(f"learn sweep: {len(LEARN_SWEEP)} lanes of the linear family in "
          f"one launch, {wall:.0f} ms run_sweep wall, each lane equal to "
          f"its standalone run; launches {counts}, on {card}")
    # the same sweep under "hbm": replay_blocked_lanes_learned, each lane
    # equal to the flat sweep's
    blocked = Simulator(nodes, learn_config(pol, "hbm"), device)
    blocked.set_workload_pods(list(pods))
    fe.reset_launch_counts()
    bwall, blanes = wall_ms(lambda: blocked.run_sweep(
        np.asarray(LEARN_SWEEP, np.int32), seeds=[42] * len(LEARN_SWEEP)))
    bcounts = nonzero(run_counts())
    if bcounts != {"init_tables_learned": 1,
                   "replay_blocked_lanes_learned": 1}:
        raise SmokeFailure(f"learn sweep hbm: launches {bcounts}")
    for a, b in zip(lanes, blanes):
        if not (np.array_equal(a.placed_node, b.placed_node)
                and np.array_equal(a.dev_mask, b.dev_mask)):
            raise SmokeFailure("learn sweep: an hbm lane differs from its "
                               "vmem lane")
    print(f"learn sweep hbm: {len(LEARN_SWEEP)} lanes in one launch, "
          f"{bwall:.0f} ms, each equal to the vmem lane; launches {bcounts}")
    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    cfg = fe.make_config(pol, "best")
    m = LEARN_LANES_EVENTS
    rows = {}
    for name, (st, rk) in (("replay_lanes_learned", (state, rank)),
                           ("replay_blocked_lanes_learned",
                            pad_nodes(state, rank, 128))):
        tables = fe.init_tables(st, types, tp, cfg)
        lanes_in = [fe.Lane(specs, types.type_id, evk[:m], evp[:m], rk,
                            fe.lane_weights(cfg, row), prng_key(42))
                    for row in LEARN_SWEEP[:2]]
        err, ms, plain_ms, _ = lanes_against_plain(
            name.replace("_learned", ""), (st, types, tp, tables), cfg,
            lanes_in)
        ops = learned_ops(cfg, st, types, tp).mean()
        one = throughput_bound(st.num_nodes, types.num_types, tp.size,
                               specs.cpu.shape[0], m, cfg.num_tables, m, ops)
        bound = (2 * one[0], one[1])
        print(f"check openb {name}: 2 lanes x {m} events, max_abs_err={err}"
              f" with final tables (tolerance 0); {ms:.3f} ms (plain "
              f"{plain_ms:.0f} ms; bound {bound[0]:.5f} ms by {bound[1]}), "
              f"on {card}")
        if err:
            raise SmokeFailure(f"{name} disagrees with its plain version")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                          lanes=2, events=m, bound_ms=bound[0],
                          bound_by=bound[1])
    return dict(wall_ms=wall, launches=counts, hbm_wall_ms=bwall,
                hbm_launches=bcounts, kernels=rows)


def learn_faults(device, card: str, nodes, pods) -> dict:
    """The learned fault forms (kernels/replay_learned_faults.cu) against
    their plain versions (CPU copies) on the openb merged stream's first
    LEARN_FAULT_STEPS steps of the lane phase's schedule under the linear
    family, tolerance 0 with the steps' outputs, the carry, tables and
    summaries: one launch, and two lanes of different weights; then the
    whole openb fault run through Simulator.run_with_faults (fault_mode
    scan) and a 2-lane chaos sweep, each under vmem and hbm, launch counts
    read."""
    import torch

    from tpusim_torch.parallel.sharding import pad_nodes
    from tpusim_torch.sim import fault_lane as fl
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine as he
    from tpusim_torch.sim.driver import Simulator
    from tpusim_torch.sim.faults import FaultConfig, generate_fault_schedule

    state, specs, types, evk, evp, tp, rank = openb_inputs(device)
    n, p = state.num_nodes, int(specs.cpu.shape[0])
    fcfg = FaultConfig(**FAULT_FLAGS)
    plan = fl.compile_fault_plan(evk.cpu().numpy(), evp.cpu().numpy(),
                                 generate_fault_schedule(n, evk.shape[0],
                                                         fcfg), fcfg, n, p)
    cut = cut_plan(plan, LEARN_FAULT_STEPS)
    pol = learn_families()["linear"]
    cfg = fe.make_config(pol, "best")
    ops = learned_ops(cfg, state, types, tp).mean()
    m = len(cut.kind)
    rows = {}
    for name, lanes_name in (("replay_faults", "replay_lanes_faults"),
                             ("replay_blocked_faults",
                              "replay_blocked_lanes_faults")):
        blocked = "blocked" in name
        st, rk = pad_nodes(state, rank, 128) if blocked else (state, rank)
        tables = lane_tables(st, types, tp, cfg)
        case = (st, specs, types, tp, rk, tables)
        err, ms, plain_ms, _, first = fault_against_plain(name, case, cfg,
                                                          cut)
        bound = throughput_bound(st.num_nodes, types.num_types, tp.size, p,
                                 m, cfg.num_tables, m, ops)
        lanes = [fe.Lane(specs, types.type_id,
                         torch.as_tensor(cut.kind, device=device),
                         torch.as_tensor(cut.idx, device=device), rk,
                         fe.lane_weights(cfg, row), None,
                         fl.lane_of(cut, st, p))
                 for row in (LEARN_THETA, LEARN_SWEEP[0])]
        lerr, lplain, _ = fault_lanes_against_plain(
            lanes_name, (st, types, tp, tables), cfg, lanes, first=first)
        prep = he.prepare_replay_blocked_lanes_faults if blocked \
            else fe.prepare_replay_lanes_faults
        ready = prep(st, types, tp, tables, cfg, lanes)
        lms = kernel_ms(ready, 3, fault_lanes_reset(ready, st, tables, lanes))
        print(f"check openb {name} (learned) first {m} steps: "
              f"max_abs_err={err}; {lanes_name} 2 lanes: max_abs_err={lerr}"
              f" with the steps' outputs, carry, tables"
              f"{' and summaries' if blocked else ''} (tolerance 0); "
              f"{ms:.3f} ms (plain {plain_ms:.0f} ms), lanes {lms:.3f} ms "
              f"(plain {lplain:.0f} ms); bound {bound[0]:.5f} ms by "
              f"{bound[1]}, on {card}")
        if err or lerr:
            raise SmokeFailure(f"the learned {name} or {lanes_name} "
                               "disagrees with its plain version")
        learned = name.replace("_faults", "_learned_faults")
        rows[learned] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                             steps=m, bound_ms=bound[0], bound_by=bound[1])
        rows[lanes_name.replace("_faults", "_learned_faults")] = dict(
            ms=lms, plain_ms=lplain, max_abs_err=lerr, lanes=2, steps=m,
            bound_ms=2 * bound[0], bound_by=bound[1])
    runs = {}
    want = {"vmem": "replay_learned_faults",
            "hbm": "replay_blocked_learned_faults"}
    chaos = {"vmem": "replay_lanes_learned_faults",
             "hbm": "replay_blocked_lanes_learned_faults"}
    for res in ("vmem", "hbm"):
        sim = Simulator(nodes, learn_config(pol, res, fault_mode="scan"),
                        device)
        sim.set_workload_pods(list(pods))
        fe.reset_launch_counts()
        wall, r = wall_ms(lambda: sim.run_with_faults(fcfg))
        counts = nonzero(run_counts())
        if counts != {"init_tables_learned": 1, want[res]: 1}:
            raise SmokeFailure(f"learn faults {res}: launches {counts}")
        print(f"learn faults openb linear/{res}: {r.events} events, "
              f"{sim.last_disruption.as_dict()['node_failures']} failures; "
              f"run_with_faults {wall:.0f} ms (fault-lane replay "
              f"{sim.replay_times[-1].get('replay_ms', float('nan')):.1f} "
              f"ms); launches {counts}, on {card}")
        runs[res] = dict(wall_ms=wall, launches=counts)
        # a 2-lane chaos sweep under the same residency
        fe.reset_launch_counts()
        wall, _ = wall_ms(lambda: sim.run_sweep(
            np.asarray(LEARN_SWEEP[:2], np.int32), seeds=[42, 42],
            faults=[fcfg, fcfg]))
        counts = nonzero(run_counts())
        if counts.get(chaos[res], 0) != 1:
            raise SmokeFailure(f"learn chaos sweep {res}: launches {counts}")
        print(f"learn chaos sweep {res}: 2 lanes in {wall:.0f} ms; "
              f"launches {counts}, on {card}")
        runs[f"chaos/{res}"] = dict(wall_ms=wall, launches=counts)
    return dict(runs=runs, kernels=rows)


def learn_tune(device, card: str, root: str) -> dict:
    """`python -m tpusim_torch.cli tune` (ES, popsize 8) on the openb
    acceptance prefix: the tuning log and the standard output against
    tpusim's (TUNE_LOG_SHA256, TUNE_STDOUT_SHA256), a generation's device
    and host time."""
    import contextlib
    import io
    import re

    import torch

    from tpusim_torch.cli import main as cli_main
    from tpusim_torch.io.trace import load_node_csv, load_pod_csv
    from tpusim_torch.learn import LocalRollout, make_family_sim
    from tpusim_torch.learn.policy import learned_policies
    from tpusim_torch.sim import fused_engine as fe

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "csv")
    node_csv = os.path.join(data, "openb_node_list_gpu_node.csv")
    pod_csv = os.path.join(data, "openb_pod_list_default.csv")
    log = os.path.join(root, "tune.jsonl")
    buf = io.StringIO()
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["tune", "--nodes", node_csv, "--pods", pod_csv,
                       *LEARN_TUNE_FLAGS, "--log", log])
    wall = time.perf_counter() - t0
    counts = nonzero(run_counts())
    stdout = re.sub(r"-> \S+tune\.jsonl", "-> LOG", buf.getvalue())
    with open(log, "rb") as f:
        log_sha = hashlib.sha256(f.read()).hexdigest()
    if rc != 0 or log_sha != TUNE_LOG_SHA256:
        raise SmokeFailure(f"tune: exit {rc}, tuning log sha256 {log_sha} "
                           "differs from tpusim's")
    if digest_text(stdout) != TUNE_STDOUT_SHA256:
        raise SmokeFailure(f"tune: standard output differs from tpusim's:\n"
                           f"{stdout}")
    if counts.get("replay_lanes_learned", 0) != 4:  # 3 generations, holdout
        raise SmokeFailure(f"tune: launches {counts}")
    # one generation alone: its device time between events around the
    # rollout (init_tables, the lanes launch, the frag sums) and its host
    # time
    nodes = load_node_csv(node_csv)
    pods = load_pod_csv(pod_csv)[:LEARN_PODS]
    train = pods[:LEARN_PODS - LEARN_PODS // 5]
    pol = learned_policies()
    backend = LocalRollout(make_family_sim(nodes, train, pol), width=8)
    rows = [tuple(r) for r in LEARN_SWEEP]
    backend.rollout(rows, 42)  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    backend.rollout(rows, 42)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3
    device_ms = start.elapsed_time(end)
    print(f"learn tune: 3 generations x 8 lanes, log and stdout equal to "
          f"tpusim's, {wall:.1f} s; launches {counts}; one generation "
          f"{device_ms:.2f} ms between device events, {host_ms:.1f} ms on "
          f"the host (executables {backend.executables()}), on {card}")
    return dict(wall_s=wall, launches=counts, gen_device_ms=device_ms,
                gen_host_ms=host_ms, executables=backend.executables())


def learn_imitate(device, card: str, root: str, nodes, pods) -> dict:
    """The openb acceptance prefix's FGD teacher recorded on the card (its
    decision file against tpusim's, TEACHER_SHA256), imitated through
    TeacherReplay on `replay_forced` (the theta and held-out agreement
    against tpusim's), and replay_forced against its plain version (the
    oracle's step functions, CPU copies) on the first FORCED_PREFIX
    events."""
    import torch

    from tpusim_torch.learn import (
        ImitateConfig,
        TeacherReplay,
        imitate_with_mining,
        load_teacher_log,
    )
    from tpusim_torch.obs import decisions as obs_decisions
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim.driver import Simulator, SimulatorConfig

    prefix = list(pods[:LEARN_PODS])
    sim = Simulator(nodes, SimulatorConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore", seed=42,
        report_per_event=False, record_decisions=True), device)
    sim.set_workload_pods(prefix)
    res = sim.run()
    path = os.path.join(root, "teacher.jsonl")
    obs_decisions.write_decisions(
        path, res.decisions, policies=[("FGDScore", 1000)],
        meta=sim._telemetry_meta(), pod_names=[p.name for p in res.pods])
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    if sha != TEACHER_SHA256:
        raise SmokeFailure(f"imitate: teacher decision file sha256 {sha} "
                           "differs from tpusim's")
    header, rows = load_teacher_log(path)
    replay = TeacherReplay(nodes, sim.prepare_pods(), header, rows,
                           device=device)
    cut = len(rows) - len(rows) // 5
    fe.reset_launch_counts()
    wall, (_, theta, hist) = wall_ms(lambda: imitate_with_mining(
        replay, ImitateConfig(steps=1000, lr=0.3, l2=1e-6), end_event=cut,
        rounds=5))
    counts = nonzero(run_counts())
    held = replay.agreement(theta, start_event=cut)
    if theta != IMITATE_THETA or held != IMITATE_HOLDOUT:
        raise SmokeFailure(f"imitate: theta {theta} held-out {held}, tpusim "
                           f"{IMITATE_THETA} {IMITATE_HOLDOUT}")
    if counts.get("replay_forced", 0) != replay.runs:
        raise SmokeFailure(f"imitate: launches {counts}, runs {replay.runs}")
    print(f"learn imitate: teacher file equal to tpusim's; theta {theta}, "
          f"held-out {held['matches']}/{held['creates']}, equal to tpusim's;"
          f" {replay.runs} teacher-forced replays in {wall:.0f} ms; launches "
          f"{counts}, on {card}")
    # replay_forced alone, and against its plain version
    cfg = fe.with_weights(replay.config, LEARN_THETA)
    tables = replay._tables
    t = replay._t
    gpu_sel = replay.gpu_sel
    args = (replay.state0, replay.specs, replay.types, t["ev_kind"],
            t["ev_pod"], replay.typical, replay.rank, tables)
    ready = fe.prepare_replay_forced(*args, cfg, t["rec_node"],
                                     t["rec_topk"], gpu_sel)
    ms = kernel_ms(ready, 5, reset_of(ready, replay.state0, tables))
    m = FORCED_PREFIX
    cut_args = args[:3] + (t["ev_kind"][:m], t["ev_pod"][:m]) + args[5:]
    ready = fe.prepare_replay_forced(*cut_args, cfg, t["rec_node"][:m],
                                     t["rec_topk"][:m], gpu_sel)
    fe.launch(ready)  # a comparison: past the wrapper, not counted
    got = ready.finish()[1]
    torch.cuda.synchronize()
    plain_ms, want = wall_ms(lambda: fe.plain_replay_forced(
        *to_cpu((replay.state0, replay.specs, t["ev_kind"][:m],
                 t["ev_pod"][:m], replay.typical, replay.rank)), cfg,
        t["rec_node"][:m].cpu(), t["rec_topk"][:m].cpu(), gpu_sel))
    err = max_abs_err(to_cpu(got), want)
    e, p = t["ev_kind"].shape[0], replay.specs.cpu.shape[0]
    st = replay.state0
    ops = learned_ops(cfg, st, replay.types, replay.typical).mean()
    bound = throughput_bound(st.num_nodes, replay.types.num_types,
                             replay.typical.size, p, e, cfg.num_tables, e,
                             ops, e * 4 * (2 + 5 + 4 * len(cfg.fam)))
    print(f"check replay_forced E={m}: max_abs_err={err} over the argmax, "
          f"the feasible counts and the feature rows (tolerance 0); the "
          f"whole {e}-event log {ms:.3f} ms (plain {plain_ms:.0f} ms on the "
          f"prefix; bound {bound[0]:.5f} ms by {bound[1]}), on {card}")
    if err:
        raise SmokeFailure("replay_forced disagrees with plain_replay_forced")
    return dict(wall_ms=wall, runs=replay.runs, launches=counts, kernel=dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err, events=e,
        prefix_events=m, bound_ms=bound[0], bound_by=bound[1]))


def learn_path(device, card: str):
    """Phase 14: the learned policy (module docstring). Returns ({run
    label: launch counts}, the learned kernels' rows); chiprun_out/
    learn_phase.json keeps the phase's numbers."""
    import shutil
    import tempfile

    nodes, pods = openb_rows_port()
    root = tempfile.mkdtemp(prefix="tpusim_learn_")
    t0 = time.perf_counter()
    try:
        out = dict(card=card)
        out["runs"] = learn_runs(device, card, nodes, pods)
        out["kernels"] = learn_kernel_checks(device, card)
        out["records"] = learn_records(device, card, nodes, pods)
        out["sweep"] = learn_sweep(device, card, nodes, pods)
        out["faults"] = learn_faults(device, card, nodes, pods)
        out["tune"] = learn_tune(device, card, root)
        out["imitate"] = learn_imitate(device, card, root, nodes, pods)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"learn phase: {out['phase_s']:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "learn_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    launches = {f"learn {k}": v["launches"] for k, v in out["runs"].items()}
    launches.update({f"learn record/{k}": v["launches"]
                     for k, v in out["records"].items() if k != "kernels"})
    launches["learn sweep"] = out["sweep"]["launches"]
    launches["learn sweep/hbm"] = out["sweep"]["hbm_launches"]
    launches.update({f"learn faults/{k}": v["launches"]
                     for k, v in out["faults"]["runs"].items()})
    launches["learn tune"] = out["tune"]["launches"]
    launches["learn imitate"] = out["imitate"]["launches"]
    rows = {}
    for name in ("init_tables_learned", "replay_learned",
                 "replay_blocked_learned"):
        r = out["kernels"][name]
        rows[name] = dict(r["linear"], configs=r)
    rows.update(out["records"]["kernels"])
    rows.update(out["sweep"]["kernels"])
    rows.update(out["faults"]["kernels"])
    rows["replay_forced"] = out["imitate"]["kernel"]
    idle = [name for name in LEARNED_KERNELS
            if not sum(c.get(name, 0) for c in launches.values())]
    if idle:
        raise SmokeFailure(f"learn: no run of the phase launched {idle}")
    return launches, rows


def learned_kernel_rows(learn_rows, launches):
    """The kernels line's rows of the learned paths: their numbers on the
    openb linear family (the forced form: the imitation's teacher log), the
    bucketed family's under "configs", and their launches on the learn
    phase's runs."""
    rows = []
    for name in LEARNED_KERNELS:
        r = dict(learn_rows[name])
        rows.append(dict(
            name=name, route="cuda", source=LEARNED_SOURCES[name],
            replaces=REPLACES[name],
            launches=sum(c.get(name, 0) for c in launches.values()),
            max_abs_err=r.pop("max_abs_err"), ms=r.pop("ms"),
            plain_ms=r.pop("plain_ms"), bound_ms=r.pop("bound_ms"),
            bound_by=r.pop("bound_by"), library_ms=None, **r))
    return rows


PHASES = ("check", "clocks", "main", "apply", "scale", "sweep", "evict",
          "lane", "seq", "ckpt", "obs", "learn")


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
    """The phase split of both replay kernels on the first SCALE_CLOCK_EVENTS
    events of the scale stream, from the cluster's initial state."""
    import torch

    evk = torch.as_tensor(auto.ev_kind[:SCALE_CLOCK_EVENTS], device=device)
    evp = torch.as_tensor(auto.ev_pod[:SCALE_CLOCK_EVENTS], device=device)
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
    ap.add_argument("--ckpt-child", metavar="DIR", help=argparse.SUPPRESS)
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
    if args.ckpt_child:
        return ckpt_child(args.ckpt_child)
    if args.ab_turn:
        try:
            print(json.dumps(ab_turn(args.ab_turn)))
        except SmokeFailure as err:
            print(f"chip_smoke --ab: FAILED: {err}", file=sys.stderr)
            return 1
        return 0
    device = torch.device("cuda")
    # every run is cold: the Bellman series' disk cache stays off, so the
    # report times compare with earlier calls'
    os.environ["TPUSIM_BELLMAN_CACHE"] = ""
    try:
        card = card_line()
        print(f"card: {card}")
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda}")

        t0 = time.perf_counter()
        infos = kernels.build_all(("",))
        build_s = time.perf_counter() - t0
        print(f"build: the main library, an nvcc a source, in parallel, then "
              f"a link: {build_s:.1f} s")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "build.json"), "w") as f:
            json.dump(dict(card=card, main_s=build_s,
                           sources=len(kernels.SOURCES)), f)
        print_builds(infos)
        # the other variants (the clocks phase's) build while the check
        # phase runs; nothing launches them before they are waited for
        others = concurrent.futures.ThreadPoolExecutor(1).submit(
            kernels.build_all, tuple(v for v in kernels.VARIANTS if v))
        print(f"kernels: {', '.join(kernels.KERNELS)} "
              f"(route cuda, {SOURCE}, the lanes {LANES_SOURCE}, the chunk "
              f"forms of replay and replay_blocked {CHUNK_SOURCE}); fault "
              f"forms {', '.join(kernels.FAULT_KERNELS)} "
              f"({', '.join(sorted(set(FAULT_SOURCES.values())))}); record "
              f"forms {', '.join(kernels.RECORD_KERNELS)} "
              f"({', '.join(RECORD_SOURCES.values())})")
        kernels.library()
        from tpusim_torch import native

        t1 = time.perf_counter()
        path = native.build()
        print(f"build [bellman]: g++, {time.perf_counter() - t1:.1f} s -> "
              f"{path}")

        launches, clocks = {}, []
        errors = dict.fromkeys(kernels.KERNELS, 0)
        fault_rows = {}
        setup = None
        if "check" in phases:
            measured, worst = check_kernels(device, card)
            blocked, err = check_blocked(device, card)
            worst["replay_blocked"] = max(worst["replay_blocked"], err)
            errors.update(worst)
            print(f"phase check done at {time.perf_counter() - t0:.1f} s")
        print_builds(others.result())
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
        if "sweep" in phases:
            counts, lane_rows = sweep_path(device, card)
            launches.update(counts)
            for name in LANE_KERNELS:
                errors[name] = lane_rows[name]["max_abs_err"]
            print(f"phase sweep done at {time.perf_counter() - t0:.1f} s")
        if "evict" in phases:
            counts, evict_err = evict_path(device, card)
            launches.update(counts)
            for name, err in evict_err.items():
                errors[name] = max(errors[name], err)
            print(f"phase evict done at {time.perf_counter() - t0:.1f} s")
        if "lane" in phases:
            counts, fault_rows = lane_path(device, card)
            launches.update(counts)
            print(f"phase lane done at {time.perf_counter() - t0:.1f} s")
        if "seq" in phases:
            counts, _ = seq_path(device, card)
            launches.update(counts)
            print(f"phase seq done at {time.perf_counter() - t0:.1f} s")
        if "ckpt" in phases:
            counts, _ = ckpt_path(device, card)
            launches.update(counts)
            print(f"phase ckpt done at {time.perf_counter() - t0:.1f} s")
        if "obs" in phases:
            counts, rec_rows = obs_path(device, card,
                                        setup[2] if setup else None)
            launches.update(counts)
            print(f"phase obs done at {time.perf_counter() - t0:.1f} s")
        if "learn" in phases:
            counts, learn_rows = learn_path(device, card)
            launches.update(counts)
            print(f"phase learn done at {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1

    if clocks:
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "phase_clocks.json"), "w") as f:
            json.dump(dict(card=card, runs=clocks), f, indent=1)
    if phases == set(PHASES):
        print(json.dumps({"kernels": kernel_rows(
            [k for k in kernels.KERNELS if k not in LANE_KERNELS], measured,
            blocked, launches, scale, errors) + lane_kernel_rows(
                lane_rows, launches) + fault_kernel_rows(
                    fault_rows, launches) + record_kernel_rows(
                        rec_rows, launches) + learned_kernel_rows(
                            learn_rows, launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def print_builds(infos: dict) -> None:
    """Each built library variant's build time, path and ptxas report."""
    for variant, info in infos.items():
        print(f"build [{variant or 'main'}]: {info.seconds:.1f} s -> "
              f"{info.path}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                print(f"ptxas [{variant or 'main'}]: {line.strip()}")


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
        configs["scale"] = dict(launches=launches["scale"].get(name, 0),
                                **scale[name if name != "init_tables"
                                        else "init_tables/replay_blocked"])
        rows.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=sum(c.get(name, 0) for c in launches.values()),
            max_abs_err=errors[name], library_ms=None,
            **measured["06-FGD"][name], configs=configs,
        ))
        if name in ("replay", "replay_blocked"):
            # the ckpt phase's launches are those of the chunk forms
            rows[-1].update(chunk_source=CHUNK_SOURCE, chunk_launches=sum(
                c.get(name, 0) for label, c in launches.items()
                if label.startswith("ckpt")))
    return rows


def lane_kernel_rows(lane_rows, launches):
    """The kernels line's rows of the lanes kernels: their numbers on the
    random lanes case (kernel and plain version on the same inputs), the
    openb prefix checks under "openb_prefix", the openb lane counts under
    "configs", and their launches on the sweep phase's runs."""
    rows = []
    for name in LANE_KERNELS:
        r = dict(lane_rows[name])
        rows.append(dict(
            name=name, route="cuda", source=LANES_SOURCE,
            replaces=REPLACES[name],
            launches=sum(c.get(name, 0) for c in launches.values()),
            max_abs_err=r.pop("max_abs_err"), library_ms=None,
            configs=r.pop("configs"), **r))
    return rows


def fault_kernel_rows(fault_rows, launches):
    """The kernels line's rows of the fault forms: their numbers on the
    openb merged stream's first LANE_PREFIX steps (the lanes forms': the
    random case's 4 lanes), every checked case under "cases", the whole
    openb lane's kernel time under "openb_ms", and their launches on the
    lane phase's runs."""
    rows = []
    for name in FAULT_KERNELS:
        r = dict(fault_rows[name])
        rows.append(dict(
            name=name, route="cuda", source=FAULT_SOURCES[name],
            replaces=REPLACES[name],
            launches=sum(c.get(name, 0) for c in launches.values()),
            max_abs_err=r.pop("max_abs_err"), ms=r.pop("ms"),
            plain_ms=r.pop("plain_ms"), bound_ms=r.pop("bound_ms"),
            bound_by=r.pop("bound_by"), library_ms=None, **r))
    return rows


if __name__ == "__main__":
    sys.exit(main())
