"""Host-side experiment driver (counterpart of the Simulator subset of
tpusim/sim/driver.py that the trace replay reaches; ref:
pkg/simulator/core.go:86-268).

The driver owns what happens once per experiment: trace preparation,
typical pods, tuning, the reports. The event loop runs in
the flat fused replay (tpusim_torch.sim.fused_engine) or, for clusters
whose tables outgrow the card's L2 cache, the blocked one
(tpusim_torch.sim.hbm_engine), as `table_residency` and
tpusim_torch.sim.residency decide: the hand-written CUDA kernels on a CUDA
device, the plain PyTorch versions when the caller asks for device="cpu".
There is no fallback from one to the other, and none to the other kernel:
a shape the card cannot hold fails its allocation (torch's
OutOfMemoryError) before launch, a failed launch raises. A randomized
configuration (RandomScore, gpu_sel random) always runs the flat replay,
as tpusim's table engine runs it flat, from the root key of its stage:
PRNGKey(seed) for the main replay, PRNGKey(seed + pods placed so far) for
`schedule_additional`, PRNGKey(inflation_seed) for the inflation run
(tpusim/sim/driver.py:1609, :1775, :2003).

A seed batch (`run_batch`) or a config sweep (`Simulator.run_sweep`,
`schedule_pods_sweep`, `schedule_pods_sweep_multi`) runs its
configurations as the lanes of one launch of the lanes kernels, each lane
bit-identical to its standalone run (the section at the end of this
module).

Under engine="sequential" every replay, each lane of a batch or sweep and
each fault run runs the sequential oracle instead (tpusim_torch.sim.engine
make_replay: the cycle of tpusim_torch.sim.step over tensors on the same
device, no tables, no kernel), as tpusim's sequential engine does; with
extenders configured, every replay runs the extender host loop
(tpusim_torch.sim.extender). Both are explicit choices: no replay falls
back to them.

Where tpusim's run_events takes its table engine, a replay can go through
the chunk surface instead (tpusim_torch.sim.table_engine
make_table_replay, the same kernels a chunk at a time): with
`checkpoint_every` it runs in chunks whose carry is written to a
content-addressed checkpoint after each (tpusim_torch.io.storage), and a
killed run resumes from the newest one (_run_chunked); `schedule_pods_fork`
replays a base run's stream with another tail from the base's nearest
checkpoint; the table cache (`table_cache_dir`) serves the tables of a
state it has seen instead of an init_tables launch.

After the main replay, `schedule_additional` replays more pods from the
placed cluster's state (apps, the new-workload swap, the inflation
evaluation), through the same kernels and the same report tail.
`deschedule_cluster` evicts pods by the configured policy and replays the
victims the same way; `run_with_faults` replays the trace in segments
between node failures, recoveries and evictions (the fault host loop),
each segment one `run_events` call.

The obs plane (tpusim_torch.obs) records every run: spans at tpusim's
sites (`typical_pods`, `init_tables` on a table-cache hit or miss, `scan`,
`fetch`, `metrics_postpass`, `report`; under `profile` each waits for the
card so it splits into dispatch and block) and exact counters
(`run_telemetry()`, SimulateResult.telemetry). With `record_decisions`,
`series_every` or `heartbeat_every` every kernel replay takes the chunk
surface, whose chunks launch the record forms of the replay kernels
(sim/records.py): SimulateResult.decisions and .series, concatenated
across chunks, resumes, forks, `schedule_additional` and fault segments as
tpusim's are.

With `report_per_event` on (the default, as in the reference), every replay
is followed by the metrics post-pass (tpusim_torch.sim.metrics) on the
replay's device, one transfer of the result to the host
(tpusim_torch.sim.fetch), the Bellman series of the host's C++ evaluator
(tpusim_torch.native) and the per-event log block; the analysis CSVs are
written from what that block stashes (tpusim_torch.analysis).
"""

from __future__ import annotations

import hashlib
import math
import os
import time
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tpusim_torch.constants import MILLI, Q3_SATISFIED
from tpusim_torch.io.trace import (
    NodeRow,
    PodRow,
    build_events,
    nodes_to_state,
    pods_to_specs,
    tiebreak_rank,
)
from tpusim_torch.io import storage
from tpusim_torch.obs import heartbeat as obs_heartbeat
from tpusim_torch.obs.counters import counters_from_events
from tpusim_torch.obs.decisions import DecisionLog, concat_logs
from tpusim_torch.obs.series import concat_series, log_from_stacked
from tpusim_torch.obs.spans import Recorder
from tpusim_torch.io.export import (
    export_node_snapshot_csv,
    export_pod_snapshot_csv,
    export_pod_snapshot_yaml,
)
from tpusim_torch.ops.frag import (
    cluster_frag_report,
    frag_sum_except_q3,
    node_frag_contrib,
    tree_sum,
)
from tpusim_torch.ops.prng import fold_in, prng_key
from tpusim_torch.parallel.sharding import pad_nodes, pad_rank, trim_nodes
from tpusim_torch.policies import make_policy
from tpusim_torch.sim import residency
from tpusim_torch.sim.deschedule import evict, select_victims
from tpusim_torch.sim import fault_lane, records
from tpusim_torch.sim.engine import (
    EV_CREATE,
    EV_DELETE,
    EV_EVICT,
    EV_NODE_FAIL,
    EV_NODE_RECOVER,
    EV_SKIP,
    ReplayResult,
    make_replay,
)
from tpusim_torch.sim.faults import (
    FaultConfig,
    fail_node,
    generate_fault_schedule,
    pick_eviction_victim,
    recover_node,
    validate_fault_schedule,
)
from tpusim_torch.sim.fetch import device_fetch
from tpusim_torch.sim.fused_engine import (
    Lane,
    init_tables,
    lane_weights,
    make_fused_replay,
    replay_faults,
    replay_lanes,
    replay_lanes_faults,
    validate_events,
)
from tpusim_torch.sim.hbm_engine import (
    make_blocked_replay,
    replay_blocked_faults,
    replay_blocked_lanes,
    replay_blocked_lanes_faults,
)
from tpusim_torch.sim.metrics import DisruptionMetrics, compute_event_metrics
from tpusim_torch.sim.queues import RetryQueue, app_queue
from tpusim_torch.sim.reports import (
    LogSink,
    batch_event_report_msgs,
    cluster_analysis_block,
    disruption_report_block,
    event_report_series,
    report_failed_pods,
)
from tpusim_torch.sim.residency import BLOCK
from tpusim_torch.sim.table_engine import (
    BlockedTableCarry,
    FlatTableCarry,
    build_pod_types,
    carry_arrays,
    carry_from_arrays,
    carry_layout,
    check_block_size,
    check_carry_arrays,
    make_table_replay,
    table_tier,
)
from tpusim_torch.sim.typical import (
    TypicalPodsConfig,
    get_skyline_pods,
    get_typical_pods,
    pad_typical_pods,
)
from tpusim_torch.sim.workload import (
    inflation_pods,
    sort_cluster_pods,
    total_pod_cpu_milli,
    total_pod_gpu_milli,
    tune_pods,
)
from tpusim_torch.types import NodeState, PodSpec


@dataclass
class SimulatorConfig:
    """Experiment knobs the replay path reads (ref: CustomConfig,
    pkg/api/v1alpha1/types.go:57-109, and the scheduler-config plugin
    selection)."""

    policies: Sequence[Tuple[str, int]] = (("FGDScore", 1000),)
    gpu_sel_method: str = "best"  # best | worst | random | <self-select policy>
    dim_ext_method: str = "share"  # DotProductScore's dim-ext method
    norm_method: str = "max"  # DotProductScore's norm method
    shuffle_pod: bool = False
    tuning_ratio: float = 0.0
    tuning_seed: int = 233
    # workload inflation (run_workload_inflation_evaluation): clone
    # ceil(n x ratio) - n workload pods onto the placed cluster
    inflation_ratio: float = 1.0
    inflation_seed: int = 233
    typical_pods: TypicalPodsConfig = field(default_factory=TypicalPodsConfig)
    # deschedule_cluster: evict ceil(ratio x pods placed) pods at most,
    # chosen by cosSim | fragOnePod | fragMultiPod
    deschedule_ratio: float = 0.0
    deschedule_policy: str = ""
    seed: int = 42  # node tie-break permutation, and the PRNG's root key
    # the per-event report block (attempt, [Report], [Alloc], [AllocCPU],
    # [Power] lines) and the per-event analysis CSVs
    report_per_event: bool = True
    # replay creations and deletions in timestamp order (build_events)
    use_timestamps: bool = False
    # where the replay's tables live: "vmem" = the flat `replay` kernel,
    # "hbm" = `replay_blocked`, "auto" = "vmem" while the tables fit the
    # card's L2 cache (always on the CPU); tpusim_torch.sim.residency
    table_residency: str = "auto"
    # fault replays (schedule_pods_with_faults): "scan" runs the in-scan
    # fault lane (tpusim_torch.sim.fault_lane, the replays' fault forms),
    # "segments" the segmented host loop, "auto" the lane unless a blocker
    # of _fault_scan_blockers (or a randomized configuration) keeps it on
    # the loop, as tpusim's auto does
    fault_mode: str = "auto"
    # tpusim's engine knob, of the values the port runs: "auto" and
    # "pallas" run its kernels ("pallas" keeps fault runs on the segmented
    # loop, as tpusim's fused pallas engine has no fault lane);
    # "sequential" runs the sequential oracle (tpusim_torch.sim.engine
    # make_replay) on the same device, and each lane of a batch or sweep
    # through it in turn
    engine: str = "auto"
    # HTTP scheduler extenders (tpusim_torch.sim.extender.ExtenderConfig
    # tuple): when set, every replay runs the extender host loop, which
    # splices the extenders' round-trips into each cycle (ref:
    # simulator.go:196 WithExtenders)
    extenders: tuple = ()
    # tpusim's table-engine select layout, as the port's kernels take it
    # (table_engine.check_block_size, table_tier): -1 forces the flat
    # `replay`, 0 keeps table_residency's rule, 128 forces
    # `replay_blocked`; other widths raise. Results are the same bits.
    block_size: int = 0
    # exact checkpoint/resume (tpusim's knobs): > 0 cuts a replay of more
    # events into checkpoint_every-event chunks (table_engine's chunk
    # surface), the carry written to a content-addressed file after each
    # chunk; a killed run started again with the same inputs resumes at
    # its last checkpoint and ends with the same bits. 0: one launch
    checkpoint_every: int = 0
    # where checkpoints live: this field, else $TPUSIM_CHECKPOINT_DIR, else
    # .tpusim_checkpoints/ at the repository's root
    checkpoint_dir: str = ""
    # retention: 0 keeps the newest checkpoint only, and none once the run
    # ends; -1 keeps every checkpoint (the ladder schedule_pods_fork
    # resumes from); N > 0 the newest N
    checkpoint_keep: int = 0
    # the init_tables cache: a directory here (or $TPUSIM_TABLE_CACHE_DIR)
    # keeps each table build under a content key; a hit serves the tables
    # instead of an init_tables launch. Empty and unset: off
    table_cache_dir: str = ""
    # where the CUDA kernels' library is built and looked for (this field,
    # else $TPUSIM_COMPILE_CACHE_DIR, else .tpusim_torch_build/ at the
    # repository's root; kernels.build_dir), tpusim's compile cache knob:
    # the port's only compiled artefact is that library
    compile_cache_dir: str = ""
    # tpusim's flat-select layout A/B for XLA (unswitched_select): the
    # port's kernels have no such layout; True raises (ROADMAP item 6)
    unswitched_select: bool = False
    # ---- observability (tpusim_torch.obs) ----
    # profile=True makes the always-on span recorder synchronise on each
    # phase's result, so spans carry the dispatch/block split (an
    # unprofiled run adds no sync point). Placements are unaffected.
    profile: bool = False
    # > 0: a heartbeat line (events/s, ETA) every N processed events from
    # inside the replay kernels' record forms (obs.heartbeat: a mapped
    # ring the kernel writes, drained by a host thread); 0 = off
    heartbeat_every: int = 0
    # the decision stream (obs.decisions): every replay records each
    # event's winner, per-policy raw and normalised scores, top-K
    # runner-ups and feasible count (SimulateResult.decisions, `apply
    # --decisions-out`), through the kernels' record forms
    record_decisions: bool = False
    # > 0: a cluster time-series sample (obs.series) every N processed
    # events, taken inside the kernels' record forms
    # (SimulateResult.series); 0 = off
    series_every: int = 0


# the values of tpusim's engine knob that the port's entries run
PORT_ENGINES = ("auto", "pallas", "sequential", "table")


@dataclass
class UnscheduledPod:
    pod: PodRow
    reason: str = "unschedulable"


@dataclass
class SimulateResult:
    unscheduled_pods: List[UnscheduledPod]
    placed_node: np.ndarray  # i32[P] final node per pod (-1 = none)
    dev_mask: np.ndarray  # bool[P, 8]
    state: NodeState  # final state, CPU tensors
    pods: List[PodRow]
    node_names: List[str]
    wall_seconds: float
    events: int
    # i64[P] position of each pod's creation event in scheduling order
    # (-1 = never created), for the pod snapshot's assume-time annotation
    creation_rank: np.ndarray = None
    # the run's obs.spans.RunTelemetry: spans, exact counters, cache and
    # fault counts (always; walls phase-split under cfg.profile)
    telemetry: object = None
    # obs.decisions.DecisionLog of the run (records + the events they
    # describe), where cfg.record_decisions; fault runs concatenate their
    # segments', schedule_additional appends
    decisions: object = None
    # obs.series.SeriesLog of the run (the real samples on the run's event
    # clock), where cfg.series_every > 0; concatenated likewise
    series: object = None


class Simulator:
    """Drives one cluster and workload through the fused replay.

    device: "cuda" (the default) runs the CUDA kernels and raises if no GPU
    is visible; "cpu" runs the plain PyTorch replay.

    After each replay, `last_engine` names the kernel that ran ("replay" or
    "replay_blocked", prefixed "plain_" on the CPU), `last_residency` its
    tier ("vmem" or "hbm"; a randomized configuration runs "vmem" whatever
    `table_residency` says) and `last_kernel_stats` the blocked replay's
    [waits, starts, rebuilds] (None after the flat one; summed over the
    chunks of a chunked run). Under engine="sequential" `last_engine` is
    "sequential", and with extenders "extender": host loops on the
    Simulator's device, with no residency. After a chunked replay,
    `last_chunks` counts its chunks, `last_chunk_times` splits its host
    time and `last_run_digest` names its checkpoints in
    `last_checkpoint_dir`; after a fork, `last_fork` says
    where it resumed; `last_table_cache` says whether the table cache hit.
    """

    def __init__(self, nodes: Sequence[NodeRow], cfg: SimulatorConfig = None,
                 device="cuda"):
        self.cfg = cfg or SimulatorConfig()
        check_block_size(self.cfg.block_size)
        if self.cfg.unswitched_select:
            raise NotImplementedError(
                "unswitched_select is an XLA select layout the PyTorch port "
                "does not have (ROADMAP queue 1, item 6)")
        if self.cfg.record_decisions and self.cfg.extenders:
            raise ValueError(
                "record_decisions cannot combine with extenders (the "
                "host-loop extender engine splices HTTP scores the "
                "flight recorder does not capture)")
        if self.cfg.series_every and self.cfg.extenders:
            raise ValueError(
                "series_every cannot combine with extenders (the "
                "host-loop extender engine has no in-scan sampling "
                "plane)")
        if self.cfg.series_every < 0:
            raise ValueError(
                f"series_every must be >= 0 (got {self.cfg.series_every})")
        if self.cfg.record_decisions and self.cfg.engine == "pallas":
            raise ValueError(
                "engine: pallas cannot record decisions (the fused kernel "
                "emits no per-event provenance); use the table, "
                "sequential, or shard engine")
        if self.cfg.series_every and self.cfg.engine == "pallas":
            raise ValueError(
                "engine: pallas cannot emit the in-scan series (the fused "
                "kernel has no per-event sampling plane); use the table, "
                "sequential, or shard engine")
        if self.cfg.engine == "pallas" and any(
                str(name).startswith("LearnedScore[")
                for name, _ in self.cfg.policies):
            # tpusim's Pallas engine has no column for a learned feature
            # (pallas_engine.supports)
            raise ValueError(
                "engine: pallas requires a registered Pallas column kernel "
                "for every enabled policy and a non-random gpuSelMethod "
                "(see tpusim.sim.pallas_engine.supports)")
        # the observability plane: spans and counters always (two
        # perf_counter calls a phase); profile=True synchronises per phase
        self.obs = Recorder(enabled=self.cfg.profile)
        # events of the run replayed by earlier fault segments: the
        # heartbeat's and the series' run-level clock
        self._hb_base = 0
        enable_compile_cache(self.cfg.compile_cache_dir)
        if self.cfg.engine not in PORT_ENGINES:
            raise ValueError(
                f"engine {self.cfg.engine!r}: the port runs "
                f"{' | '.join(PORT_ENGINES)} (its kernels)")
        if self.cfg.table_residency not in residency.RESIDENCIES:
            raise ValueError(
                f"unknown table_residency {self.cfg.table_residency!r}: "
                f"expected {' | '.join(residency.RESIDENCIES)}"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the replay runs its CUDA kernels "
                "on a GPU; pass device='cpu' for the plain PyTorch replay"
            )
        # raises ValueError for a gpu_sel the reference cannot run
        self._replay = make_fused_replay(
            self.cfg.policies, self.cfg.gpu_sel_method, self.device,
            self.cfg.dim_ext_method, self.cfg.norm_method,
        )
        self._blocked = None  # the blocked replayer, built on first use
        # the chunk surface (table_engine.make_table_replay), built on first
        # use
        self._table = None
        # (Policy, weight) pairs: the per-pod scorers of the sequential
        # oracle and the extender host loop
        self._policy_fns = [
            (make_policy(name, self.cfg.dim_ext_method, self.cfg.norm_method),
             weight)
            for name, weight in self.cfg.policies
        ]
        self._extender_fn = None  # the extender host loop, built on first use
        self.engine = ("fused cuda kernel" if self.device.type == "cuda"
                       else "plain pytorch (cpu)")
        self.last_engine = None
        self.last_residency = None
        self.last_kernel_stats = None
        # the last chunked replay's content key, checkpoint directory and
        # chunks launched; the last fork's source and events (tpusim's
        # last_run_digest, last_checkpoint_dir, last_fork)
        self.last_run_digest = None
        self.last_checkpoint_dir = None
        self.last_chunks = None
        # host milliseconds of the last chunked replay: the run digest, the
        # chunks' dispatch (init_tables and replay launches and their
        # preparation), the fetches (each waits for its chunk's kernels)
        # and the checkpoint writes (each while the next chunk runs)
        self.last_chunk_times = None
        self.last_fork = None
        self._fork_stats = None
        # the table cache's outcome of the last table build: "hit", "miss"
        # or None (off, or no table path)
        self.last_table_cache = None
        self.nodes = list(nodes)
        self.node_names = [n.name for n in self.nodes]
        self.node_index = {n.name: i for i, n in enumerate(self.nodes)}
        self.init_state = nodes_to_state(self.nodes, self.device)
        self.rank = torch.as_tensor(
            tiebreak_rank(len(self.nodes), self.cfg.seed), device=self.device
        )
        self.log = LogSink(stream=None)
        self.workload_pods: List[PodRow] = []
        self.typical = None
        self.node_total_milli_cpu = int(sum(n.cpu_milli for n in self.nodes))
        self.node_total_milli_gpu = int(sum(n.gpu * MILLI for n in self.nodes))
        self.total_gpus = int(sum(n.gpu for n in self.nodes))
        self.last_result = None
        self.last_ever_failed = None
        # the last fault replay's DisruptionMetrics
        self.last_disruption = None
        self.skyline = None
        self._bellman_eval = None
        # the inputs of a first Bellman series served from the disk cache,
        # evaluated before the next series so the memo is what an uncached
        # run's would be (_bellman_series)
        self._bellman_pending = None
        self._reset_run_state()

    def _reset_run_state(self):
        """Start a run's log and the stashes the analysis CSVs read
        (`event_reports`, `analysis_summary`, `failed_pod_lists`), so a
        reused Simulator does not count a previous run twice. An attached
        log stream is not rewound. `replay_times` gets one entry per replay
        of the run: its events, the replay's milliseconds (the kernels, up
        to a synchronise) and the report tail's (the post-pass, the fetch
        and the per-event block), host clock."""
        self.replay_times = []
        self.event_reports = []
        self.analysis_summary = {}
        self.failed_pod_lists = []
        self.log.lines = []
        self.obs.reset()

    # ---- workload prep (core.go:103-142) ----

    def set_workload_pods(self, pods: Sequence[PodRow]):
        self.workload_pods = list(pods)

    def set_typical_pods(self):
        with self.obs.span("typical_pods", pods=len(self.workload_pods)):
            typical, info = get_typical_pods(
                self.workload_pods, self.cfg.typical_pods, self.device
            )
        # zero-frequency padding rows add nothing to any frag sum
        self.typical = pad_typical_pods(typical)
        self._typical_info = info
        # the Bellman memo lives for one experiment, as the reference's
        # fragMemo does (simulator.go:58)
        self._bellman_eval = None
        self._bellman_pending = None
        self.log.info(f"Num of Total Pods: {len(self.workload_pods)}")
        self.log.info(f"Num of Total Pod Sepc: {len(info)}")

    def set_skyline_pods(self):
        """The workload's (cpu, gpu milli) skyline (frag.go:382-409)."""
        self.skyline = get_skyline_pods(self.workload_pods)

    def adopt_typical_pods(self, other: "Simulator"):
        """set_typical_pods, taking the distribution of a sibling with the
        same workload and typical-pod settings instead of computing it
        again (a seed batch): the same log lines, a fresh Bellman memo."""
        self.typical = other.typical
        self._typical_info = other._typical_info
        self._bellman_eval = None
        self._bellman_pending = None
        self.log.info(f"Num of Total Pods: {len(self.workload_pods)}")
        self.log.info(f"Num of Total Pod Sepc: {len(self._typical_info)}")

    def prepare_pods(self, tuning_ratio: float = None,
                     tuning_seed: int = None) -> List[PodRow]:
        """SortClusterPods, then tuning (core.go:131-142): one generator
        seeded by tuning_seed drives the shuffle and then the clone draws.
        The tune knobs default to the config's; a lane of a multi-trace
        sweep passes its own, and is then prepared as a standalone run
        configured with them."""
        ratio = (self.cfg.tuning_ratio if tuning_ratio is None
                 else float(tuning_ratio))
        seed = self.cfg.tuning_seed if tuning_seed is None else int(tuning_seed)
        rng = np.random.default_rng(seed)
        pods = sort_cluster_pods(
            list(self.workload_pods), self.cfg.shuffle_pod, rng
        )
        if ratio > 0:
            pods = tune_pods(pods, self.node_total_milli_gpu, ratio, rng)
        return pods

    # ---- the run (core.go:148 RunCluster -> SchedulePods) ----

    def _residency(self, num_nodes: int, num_types: int) -> str:
        """The tier a replay of this shape runs in (table_engine.table_tier:
        block_size, else residency.replay_tier against the card's L2 cache).
        A lanes launch asks it once for one lane's shape: the rule takes no
        lane count."""
        cfg = self._replay.config
        return table_tier(self.cfg.block_size, self.cfg.table_residency,
                          cfg.randomized, num_nodes, num_types,
                          cfg.num_tables, self.device)

    def _sequential_replay(self, faults: bool = False,
                           fault_frag: bool = False):
        """This configuration's sequential oracle (engine.make_replay),
        metric-free: the reports come from the post-pass, as after every
        replay. It records what the configuration records (not in its
        fault form, as tpusim's)."""
        rec = not faults
        return make_replay(self._policy_fns, self.cfg.gpu_sel_method,
                           report=False,
                           decisions=rec and self.cfg.record_decisions,
                           series_every=self.cfg.series_every if rec else 0,
                           faults=faults, fault_frag=fault_frag)

    @property
    def _recording(self) -> bool:
        """Whether replays run the kernels' record forms: decisions, the
        series or the heartbeat."""
        cfg = self.cfg
        return bool(cfg.record_decisions or cfg.series_every
                    or cfg.heartbeat_every)

    def _sync(self) -> None:
        """Wait for the card where profiling asks for the block half of a
        span (an unprofiled run adds no sync point)."""
        if self.obs.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _host_loop(self, name: str) -> None:
        self.last_engine, self.last_residency = name, None
        self.last_kernel_stats = None

    def run_events(self, state: NodeState, specs: PodSpec, ev_kind,
                   ev_pod, types=None, key=None,
                   pod_rows=None, fork=None) -> ReplayResult:
        """Replay an event stream from `state`: the CUDA kernels on a CUDA
        device, the plain replay on the CPU; the sequential oracle under
        engine="sequential"; the extender host loop when extenders are
        configured, which needs the PodRow list `pod_rows` for its
        payloads. Callers replaying the same pod specs repeatedly (a chunked
        stream) may pass their `build_pod_types(specs)` as `types`. `key` is
        the root of the event key chain (the main replay's, PRNGKey(seed),
        by default).

        Where tpusim's run_events takes its table engine (driver.py:800-905
        of the reference: pod types exist, and there are at least twice as
        many events as types, or engine="table", or a fork) and the engine
        is not "pallas", the replay goes through the chunk surface
        (table_engine.make_table_replay) when checkpoint_every cuts it
        (0 < checkpoint_every < events: _run_chunked), when the table cache
        is on (_cached_tables) or under engine="table"; the kernels are the
        same. `fork = (base_ev_kind, base_ev_pod, fork_event)` (from
        schedule_pods_fork) resumes from the base run's nearest checkpoint
        at or before fork_event."""
        ev_kind = np.asarray(ev_kind, np.int32)
        ev_pod = np.asarray(ev_pod, np.int32)
        if key is None:
            key = prng_key(self.cfg.seed)
        e = len(ev_kind)
        if self.cfg.heartbeat_every:
            # arm the host side of the kernels' ticks for this replay;
            # `base` = events of the run replayed by earlier fault segments
            obs_heartbeat.configure(self._hb_base + e, "replay",
                                    base=self._hb_base)
        with self.obs.span("scan", events=e) as h:
            out = self._run_events(state, specs, ev_kind, ev_pod, types, key,
                                   pod_rows, fork)
            h.dispatched()
            self._sync()
        if self.cfg.heartbeat_every:
            obs_heartbeat.complete(e)
        if out.counters is None:
            # a launch that records nothing: the counts of its outputs
            stats = self.last_kernel_stats
            out = out._replace(counters=counters_from_events(
                torch.as_tensor(ev_kind, device=out.event_node.device),
                out.event_node, 0 if stats is None else int(stats[2])))
        self.obs.note_scan(self.last_engine, counters=out.counters,
                           events=e)
        if self.last_residency:
            self.obs.pallas_residency = self.last_residency
        return out

    def _run_events(self, state, specs, ev_kind, ev_pod, types, key,
                    pod_rows, fork) -> ReplayResult:
        """run_events' dispatch (its docstring), inside the scan span."""
        e = len(ev_kind)
        if fork is not None and not self.cfg.extenders:
            fork = self._check_fork(fork, e)
        if self.cfg.extenders or self.cfg.engine == "sequential":
            validate_events(ev_kind, ev_pod, int(specs.cpu.shape[0]))
            if self.cfg.extenders:
                if pod_rows is None:
                    raise ValueError(
                        "extender-configured replays need the PodRow list "
                        "(run_events(..., pod_rows=...)) to build the "
                        "ExtenderArgs payloads")
                if self._extender_fn is None:
                    from tpusim_torch.sim.extender import make_extender_replay

                    self._extender_fn = make_extender_replay(
                        self._policy_fns, self.cfg.gpu_sel_method,
                        self.cfg.extenders)
                out = self._extender_fn(state, specs, ev_kind, ev_pod,
                                        self.typical, key, self.rank,
                                        pod_rows, self.nodes)
                self._host_loop("extender")
            else:
                out = self._sequential_replay()(
                    state, specs, ev_kind, ev_pod, self.typical, key,
                    self.rank, heartbeat_every=self.cfg.heartbeat_every)
                self._host_loop("sequential")
            self.log.info(f"[Engine] replay of {len(ev_kind)} events ran on: "
                          f"{_ran_on(self, self.last_engine, None)}")
            return out
        if types is None:
            types = build_pod_types(specs)
        n, k = state.num_nodes, types.num_types
        tier = self._residency(n, k)
        table_path = self.cfg.engine != "pallas" and k > 0 and (
            e >= 2 * k or self.cfg.engine == "table" or fork is not None)
        if fork is not None and not table_path:
            raise ValueError(
                "forked replay fell through to the sequential engine (no "
                "pod types / carry surface): run the base and fork on the "
                "table engine")
        chunked = table_path and 0 < self.cfg.checkpoint_every < e
        # a recording replay takes the chunk surface, whose chunks launch
        # the record forms (tpusim's auto leaves its fused kernel for the
        # table engine the same way)
        if (table_path and (chunked or self.cfg.engine == "table"
                            or self._table_cache_dir())) or \
                (self._recording and k > 0):
            return self._run_table(state, specs, types, ev_kind, ev_pod, key,
                                   tier, chunked, fork)
        args = (state, specs, types, torch.as_tensor(ev_kind),
                torch.as_tensor(ev_pod), self.typical, key, self.rank)
        if tier == "hbm":
            if self._blocked is None:
                self._blocked = make_blocked_replay(
                    self.cfg.policies, self.cfg.gpu_sel_method, self.device,
                    self.cfg.dim_ext_method, self.cfg.norm_method,
                )
            out, stats = self._blocked(*args)
            kernel, self.last_kernel_stats = "replay_blocked", stats.tolist()
        else:
            out = self._replay(*args)
            kernel, self.last_kernel_stats = "replay", None
        if self.device.type != "cuda":
            kernel = f"plain_{kernel}"
        self.last_engine, self.last_residency = kernel, tier
        self.log.info(
            f"[Engine] replay of {len(ev_kind)} events ran on: {self.engine}"
            f", {kernel} ({tier} residency)"
        )
        return out

    def _check_fork(self, fork, e: int):
        """tpusim's fork guards (driver.py:736-758 of the reference): the
        chunked path, the table engine (or auto), the fork event within
        the base stream. Returns (base kinds, base pods, fork event)."""
        if not 0 < self.cfg.checkpoint_every < e:
            raise ValueError(
                "forked replay needs the chunked path: set checkpoint_every "
                f"in (0, num_events) (got {self.cfg.checkpoint_every} for "
                f"{e} events)")
        if self.cfg.engine not in ("table", "auto"):
            raise ValueError(f"forked replay needs the table or shard "
                             f"engine, not {self.cfg.engine!r}")
        bk, bp, fev = fork
        bk, bp = np.asarray(bk, np.int32), np.asarray(bp, np.int32)
        if not 0 <= int(fev) <= bk.shape[0]:
            raise ValueError(f"fork_event {fev} outside the base stream "
                             f"(0..{bk.shape[0]})")
        return bk, bp, int(fev)

    def _table_replay(self):
        """This configuration's chunk surface (make_table_replay), built
        once."""
        if self._table is None:
            cfg = self.cfg
            self._table = make_table_replay(
                cfg.policies, cfg.gpu_sel_method, cfg.block_size,
                cfg.dim_ext_method, cfg.norm_method, cfg.table_residency,
                decisions=cfg.record_decisions,
                series_every=cfg.series_every,
                heartbeat_every=cfg.heartbeat_every)
        return self._table

    def _run_table(self, state, specs, types, ev_kind, ev_pod, key,
                   tier: str, chunked: bool, fork) -> ReplayResult:
        """run_events through the chunk surface: _run_chunked where
        checkpoint_every cuts the stream, else one chunk; the tables of
        event 0 from the table cache where it is on. The [Engine] line
        names the kernel, its residency and the chunks."""
        validate_events(ev_kind, ev_pod, int(specs.cpu.shape[0]))
        fn = self._table_replay()
        evk = torch.as_tensor(ev_kind, device=self.device)
        evp = torch.as_tensor(ev_pod, device=self.device)

        def tables():
            padded = (pad_nodes(state, self.rank, BLOCK)[0] if tier == "hbm"
                      else state)
            return self._cached_tables(padded, types)

        self.last_chunks = None
        if chunked:
            out, stats, extra = self._run_chunked(
                fn, state, specs, types, evk, evp, key, tables, fork)
        else:
            out = fn(state, specs, types, evk, evp, self.typical, key,
                     self.rank, tables=tables())
            stats = fn.last_stats
            extra = ""
        kernel = "replay_blocked" if tier == "hbm" else "replay"
        self.last_kernel_stats = (None if stats is None
                                  else [int(x) for x in stats])
        if self.device.type != "cuda":
            kernel = f"plain_{kernel}"
        self.last_engine, self.last_residency = kernel, tier
        self.log.info(
            f"[Engine] replay of {len(ev_kind)} events ran on: "
            f"{_ran_on(self, kernel, tier, extra)}")
        return out

    # ---- exact checkpoint/resume of a chunked replay ----

    def _checkpoint_dir(self) -> str:
        d = self.cfg.checkpoint_dir or os.environ.get(
            "TPUSIM_CHECKPOINT_DIR", "")
        if not d:
            d = os.path.join(_REPO_ROOT, ".tpusim_checkpoints")
        return d

    def _config_bytes(self) -> bytes:
        cfg = self.cfg
        return repr((tuple(name for name, _ in cfg.policies),
                     cfg.gpu_sel_method, cfg.dim_ext_method,
                     cfg.norm_method)).encode()

    def _run_digest(self, state, specs, ev_kind, ev_pod, key) -> str:
        """Content key of one replay run (tpusim's _run_digest): the port's
        source salt, the configuration, and every input that determines
        the trajectory: the initial state, the pod specs, the typical
        pods, the event stream, the root key, the tie-break rank and the
        weights. checkpoint_every is not part of it (a resume may cut
        elsewhere), nor is the kernel (block_size, table_residency, the
        device): every tier gives the same bits, so a run checkpointed on
        the card resumes on the CPU."""
        def chunks():
            yield _engine_source_digest()
            yield self._config_bytes()
            host = device_fetch((state, specs, self.typical, self.rank))
            for tree in host:
                for leaf in tree:
                    yield leaf.contiguous().numpy().tobytes()
            for leaf in (ev_kind, ev_pod, np.asarray(
                    [int(w) & 0xFFFFFFFF for w in key], np.uint32),
                         np.asarray([w for _, w in self.cfg.policies],
                                    np.int32)):
                yield np.ascontiguousarray(leaf).tobytes()

        return storage.checkpoint_digest(chunks())

    def _run_chunked(self, fn, state, specs, types, ev_kind, ev_pod, key,
                     tables_thunk, fork=None):
        """Chunked replay with exact checkpoint/resume (tpusim's
        _run_chunked, driver.py:1195-1440 of the reference): the stream in
        checkpoint_every-event chunks through the chunk surface, the carry
        and the per-event telemetry so far fetched to the host after each
        chunk but the last and written to a content-addressed file
        (io.storage) while the next chunk's kernels run, and on entry a
        resume from the newest valid checkpoint of this run (a torn file is
        skipped with a [Degrade] line and deleted). Retention follows
        checkpoint_keep.

        `fork = (base kinds, base pods, fork event)`: where this run has no
        checkpoint, resume from the base run's nearest checkpoint at or
        before the fork event (its carry consumed only shared events);
        none found, a full replay with a [Degrade] line. Returns
        (ReplayResult on the device, the blocked chunks' summed stats or
        None, the [Engine] line's chunk note)."""
        t0 = time.perf_counter()
        e = int(ev_kind.shape[0])
        p = int(specs.cpu.shape[0])
        every = max(1, int(self.cfg.checkpoint_every))
        cache_dir = self._checkpoint_dir()
        ev_host = (ev_kind.cpu().numpy(), ev_pod.cpu().numpy())
        digest = self._run_digest(state, specs, *ev_host, key)
        times = dict(digest_ms=(time.perf_counter() - t0) * 1e3,
                     dispatch_ms=0.0, fetch_ms=0.0, write_ms=0.0)
        self.last_run_digest = digest
        self.last_checkpoint_dir = cache_dir
        self._fork_stats = None
        layout = carry_layout(state, p)

        pi = len(self.cfg.policies)
        rec_names = ([("dec", records.dec_cols(pi))]
                     if self.cfg.record_decisions else []) + (
            [("ser", records.ser_cols(pi))] if self.cfg.series_every else [])

        def validate(arrays):
            check_carry_arrays(arrays, layout)
            c = int(arrays["cursor"])
            if arrays["event_node"].shape != (c,) or \
                    arrays["event_dev"].shape != (c, layout["masks"][0][1]):
                raise ValueError("event telemetry does not match the cursor")
            # the record streams so far ride the checkpoint (rows in the
            # configuration's policy order), so a resumed run's are whole
            for name, cols in rec_names:
                a = arrays[f"rec_{name}"]
                rows = c if name == "dec" else records.series_count(
                    0, c, self.cfg.series_every)
                if a.shape != (rows, cols) or a.dtype != np.int32:
                    raise ValueError(f"rec_{name} does not match the cursor")

        def on_skip(path, err):
            self.log.info(
                f"[Degrade] skipping unusable checkpoint "
                f"{os.path.basename(path)} ({err}); trying the newest "
                "valid predecessor")

        found = storage.load_valid_checkpoint(cache_dir, digest,
                                              validate=validate,
                                              on_skip=on_skip)
        if fork is not None:
            base_kind, base_pod, fork_event = fork
            base_digest = self._run_digest(state, specs, base_kind, base_pod,
                                           key)
            self._fork_stats = {"base_digest": base_digest,
                                "fork_event": fork_event,
                                "source_cursor": 0, "degrade": False}
            if found is None:
                found = storage.load_valid_checkpoint(
                    cache_dir, base_digest, validate=validate,
                    on_skip=on_skip, max_cursor=fork_event,
                    delete_invalid=False)
                if found is None:
                    self._fork_stats["degrade"] = True
                    self.log.info(
                        f"[Degrade] no usable fork source at-or-before "
                        f"event {fork_event} for base {base_digest[:12]}…; "
                        "full replay from event 0")
        node_parts, dev_parts = [], []
        rec_parts = {name: [] for name, _ in rec_names}
        if found is not None:
            cursor, arrays, path = found
            if self._fork_stats is not None:
                self._fork_stats["source_cursor"] = cursor
            cls = (BlockedTableCarry if fn.tier_of(state, types) == "hbm"
                   else FlatTableCarry)
            carry = carry_from_arrays(cls, arrays, self.device)
            node_parts.append(arrays["event_node"])
            dev_parts.append(arrays["event_dev"])
            for name in rec_parts:
                rec_parts[name].append(arrays[f"rec_{name}"])
            if self.cfg.heartbeat_every:
                # the resumed counters include events this process never
                # ran: keep the rate honest
                obs_heartbeat.note_resume(cursor)
            self.log.info(f"[Checkpoint] resumed replay at event {cursor}/{e} "
                          f"from {os.path.basename(path)}")
        else:
            carry = fn.init_carry(state, specs, types, self.typical, key,
                                  self.rank, tables_thunk())
        start = carry.cursor
        stats = None
        chunks = 0
        # a boundary's checkpoint is written once the next chunk is
        # launched, while its kernels run: the (cursor, arrays) to write
        pending = None
        while carry.cursor < e:
            end = min(carry.cursor + every, e)
            t0 = time.perf_counter()
            carry, ys = fn.run_chunk(
                carry, specs, types, ev_kind[carry.cursor:end],
                ev_pod[carry.cursor:end], self.typical, self.rank)
            nseg, dseg = ys[:2]
            seg_rec = {}
            if rec_names:
                seg_rec = {f"seg_{name}": getattr(ys[2], name)
                           for name in rec_parts}
            t1 = time.perf_counter()
            times["dispatch_ms"] += (t1 - t0) * 1e3
            chunks += 1
            if fn.last_stats is not None:
                stats = fn.last_stats if stats is None else \
                    stats + fn.last_stats
            if pending is not None:
                storage.save_checkpoint(cache_dir, digest, *pending)
                storage.prune_checkpoints(cache_dir, digest, pending[0],
                                          keep=self.cfg.checkpoint_keep)
                pending = None
            t2 = time.perf_counter()
            times["write_ms"] += (t2 - t1) * 1e3
            if carry.cursor < e:
                arrays = carry_arrays(carry, {"seg_node": nseg,
                                              "seg_dev": dseg, **seg_rec})
                node_parts.append(arrays.pop("seg_node"))
                dev_parts.append(arrays.pop("seg_dev"))
                arrays["event_node"] = np.concatenate(node_parts)
                arrays["event_dev"] = np.concatenate(dev_parts)
                for name, parts in rec_parts.items():
                    parts.append(arrays.pop(f"seg_{name}"))
                    arrays[f"rec_{name}"] = np.concatenate(parts)
                pending = (carry.cursor, arrays)
            else:
                nseg, dseg, host_rec = device_fetch(
                    (nseg, dseg, tuple(seg_rec.values())))
                node_parts.append(nseg.numpy())
                dev_parts.append(dseg.numpy())
                for parts, x in zip(rec_parts.values(), host_rec):
                    parts.append(x.numpy())
            times["fetch_ms"] += (time.perf_counter() - t2) * 1e3
        storage.prune_checkpoints(cache_dir, digest, e + 1,
                                  keep=self.cfg.checkpoint_keep)
        self.last_chunks = chunks
        self.last_chunk_times = times
        state_f, placed, masks, failed = fn.finish(carry)
        nodes = torch.as_tensor(np.concatenate(node_parts), device=self.device)
        devs = torch.as_tensor(np.concatenate(dev_parts), device=self.device)
        extra = f", {chunks} chunks of {every} events"
        if start:
            extra += f" resumed at event {start}"
        decs = sers = None
        if rec_names:
            cfg = self._replay.config
            whole = {name: np.concatenate(parts)
                     for name, parts in rec_parts.items()}
            if "dec" in whole:
                decs = records.decision_rows(whole["dec"], pi, cfg.order)
            if "ser" in whole:
                sers = records.sample_rows(whole["ser"], pi, cfg.order)
        return (ReplayResult(state_f, placed, masks, failed, None, nodes,
                             devs, carry.ctr, decs, sers), stats, extra)

    # ---- the content-keyed init_tables cache ----

    def _table_cache_dir(self) -> str:
        return self.cfg.table_cache_dir or os.environ.get(
            "TPUSIM_TABLE_CACHE_DIR", "")

    def _tables_digest(self, state, types) -> str:
        """Content key of one table build (tpusim's _tables_digest): the
        port's source salt, the configuration, and every input init_tables
        reads: the state (padded where the blocked replay runs), the
        distinct pod types and the typical pods. Not the events, the key,
        the rank or the weights, which the tables do not depend on."""
        def chunks():
            yield _engine_source_digest()
            yield self._config_bytes()
            host = device_fetch((state, types.share, types.whole,
                                 self.typical))
            for tree in host:
                for leaf in tree:
                    yield leaf.contiguous().numpy().tobytes()

        return storage.checkpoint_digest(chunks())

    def _cached_tables(self, state, types):
        """(score, sdev, feas) of `state` from the table cache, built with
        one init_tables launch and saved on a miss; None where the cache is
        off. A hit launches no init_tables; a file that does not load is
        dropped and rebuilt."""
        cache_dir = self._table_cache_dir()
        if not cache_dir:
            return None
        names = ("score_tbl", "sdev_tbl", "feas_tbl")
        digest = self._tables_digest(state, types)
        found = storage.find_tables(cache_dir, digest)
        if found is not None:
            try:
                arrays = storage.load_tables(found)
                tables = tuple(torch.as_tensor(arrays[k], device=self.device)
                               for k in names)
                self.log.info(f"[TableCache] reused init tables from "
                              f"{os.path.basename(found)}")
                self.last_table_cache = "hit"
                return tables
            except Exception as err:
                self.log.info(f"[TableCache] dropping unusable entry "
                              f"{os.path.basename(found)} ({err}); rebuilding")
                try:
                    os.unlink(found)
                except OSError:
                    pass
        tables = init_tables(state, types, self.typical,
                             self._replay.config)
        host = device_fetch(tuple(tables))
        path = storage.save_tables(cache_dir, digest, dict(zip(
            names, (t.numpy() for t in host))))
        self.log.info(f"[TableCache] saved init tables to "
                      f"{os.path.basename(path)}")
        self.last_table_cache = "miss"
        return tables

    def _attach_metrics(self, out: ReplayResult, state: NodeState, specs,
                        ev_kind, ev_pod) -> ReplayResult:
        """The metrics post-pass on the replay's device when per-event
        reporting is on (compute_event_metrics, from the telemetry)."""
        if not self.cfg.report_per_event:
            return out
        dev = out.event_node.device
        with self.obs.span("metrics_postpass", events=len(ev_kind)) as h:
            out = out._replace(metrics=compute_event_metrics(
                state, specs, torch.as_tensor(ev_kind, device=dev),
                torch.as_tensor(ev_pod, device=dev), out.event_node,
                out.event_dev, self.typical))
            h.dispatched()
            self._sync()
        return out

    def _replay_pods(self, state: NodeState, pods: Sequence[PodRow], key,
                     use_timestamps: bool, events=None, fork=None):
        """Replay `pods` from `state` with root key `key`: the kernels, the
        metrics post-pass, one fetch and the host tail (_finish_replay).
        `events` (ev_kind, ev_pod) replaces the pods' own stream, `fork` is
        run_events'. Returns (the replay's result on the host, events,
        unscheduled pods, creation ranks)."""
        t0 = time.perf_counter()
        specs = pods_to_specs(pods, self.node_index, self.device)
        ev_kind, ev_pod = events or build_events(pods, use_timestamps)
        out = self.run_events(state, specs, ev_kind, ev_pod, key=key,
                              pod_rows=pods, fork=fork)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        out = self._attach_metrics(out, state, specs, ev_kind, ev_pod)
        with self.obs.span("fetch", events=len(ev_kind)):
            out = device_fetch(out)
        done = self._finish_replay(out, pods, ev_kind, ev_pod, state)
        self.replay_times.append(dict(
            events=len(ev_kind), replay_ms=(t1 - t0) * 1e3,
            report_ms=(time.perf_counter() - t1) * 1e3))
        return done

    def _finish_replay(self, out: ReplayResult, pods, ev_kind, ev_pod,
                       state: NodeState):
        """The host tail of a replay (driver.py:1566-1600 of the
        reference): the per-event log block from the replay's start state,
        the unscheduled pods (the pod-unscheduled annotation's too) and
        each pod's creation rank. `out` is on the host. The decision
        records are paired with the events they describe (a DecisionLog),
        the samples filtered to a SeriesLog from the replay's clock."""
        if out.decisions is not None:
            out = out._replace(decisions=DecisionLog(
                records.on_host(out.decisions), np.asarray(ev_kind),
                np.asarray(ev_pod)))
        if out.series is not None:
            out = out._replace(series=log_from_stacked(
                records.on_host(out.series)))
        self._emit_event_reports(out, pods, ev_kind, ev_pod, state)
        skipped = np.array([p.unscheduled for p in pods], bool)
        failed = out.ever_failed.numpy() | skipped
        unscheduled = [
            UnscheduledPod(
                pods[i],
                "pod-unscheduled annotation" if skipped[i] else "unschedulable",
            )
            for i in np.flatnonzero(failed)
        ]
        rank = np.full(len(pods), -1, np.int64)
        creates = np.asarray(ev_pod)[np.asarray(ev_kind) == EV_CREATE]
        rank[creates] = np.arange(len(creates))
        return out, len(ev_kind), unscheduled, rank

    def schedule_pods(self, pods: Sequence[PodRow]) -> SimulateResult:
        if self.typical is None:
            self.set_typical_pods()
        t0 = time.perf_counter()
        out, events, unscheduled, rank = self._replay_pods(
            self.init_state, pods, prng_key(self.cfg.seed),
            self.cfg.use_timestamps)
        return self._record_result(out, pods, events, unscheduled, rank,
                                   time.perf_counter() - t0)

    def schedule_pods_fork(self, pods: Sequence[PodRow], fork_event: int,
                           tail_kind, tail_pod) -> SimulateResult:
        """Warm-state what-if (tpusim's schedule_pods_fork,
        driver.py:1617-1671 of the reference): replay the stream
        `base[:fork_event] + tail` over the same pods, resumed from the
        base run's nearest checkpoint at or before fork_event, so only the
        tail and at most one chunk of shared prefix run. The base must have
        run on this configuration with checkpoint_every > 0 and
        checkpoint_keep != 0; a missing source degrades to a full replay
        (last_fork["degrade"]). Equal to schedule_pods over the spliced
        stream, bit for bit. last_fork: the base digest, the fork event,
        the source cursor, the events this call executed and the total."""
        if self.typical is None:
            self.set_typical_pods()
        t0 = time.perf_counter()
        base_kind, base_pod = build_events(pods, self.cfg.use_timestamps)
        fev = int(fork_event)
        if not 0 <= fev <= len(base_kind):
            raise ValueError(f"fork_event {fev} outside the base stream "
                             f"(0..{len(base_kind)})")
        ev_kind = np.concatenate([base_kind[:fev],
                                  np.asarray(tail_kind, base_kind.dtype)])
        ev_pod = np.concatenate([base_pod[:fev],
                                 np.asarray(tail_pod, base_pod.dtype)])
        self._fork_stats = None
        out, events, unscheduled, rank = self._replay_pods(
            self.init_state, pods, prng_key(self.cfg.seed),
            self.cfg.use_timestamps, events=(ev_kind, ev_pod),
            fork=(base_kind, base_pod, fev))
        stats = dict(self._fork_stats or {})
        if stats:
            stats["events_executed"] = max(
                0, len(ev_kind) - int(stats["source_cursor"]))
            stats["events_total"] = len(ev_kind)
        self.last_fork = stats
        return self._record_result(out, pods, events, unscheduled, rank,
                                   time.perf_counter() - t0)

    def _record_result(self, out: ReplayResult, pods, events: int,
                       unscheduled, rank, wall: float) -> SimulateResult:
        """The run's SimulateResult from a replay's result on the host;
        `last_ever_failed` keeps its creation-failure mask (lane_from_run
        reads it)."""
        self.last_ever_failed = out.ever_failed.numpy()
        self.last_result = SimulateResult(
            unscheduled_pods=unscheduled,
            placed_node=out.placed_node.numpy(),
            dev_mask=out.dev_mask.numpy(),
            state=out.state,
            pods=list(pods),
            node_names=self.node_names,
            wall_seconds=wall,
            events=events,
            creation_rank=rank,
            telemetry=self.run_telemetry(),
            decisions=out.decisions,
            series=out.series,
        )
        return self.last_result

    def event_counter_series(self) -> dict:
        """Per-event counter tracks for the Chrome trace (obs.emitters;
        tpusim's event_counter_series): the cluster frag gpu-milli in all
        and by FGD failure category (the post-pass's frag_amounts), used
        gpu-milli and used cpu-milli, one value per reported event across
        the run's reporting replays. Empty without per-event reporting."""
        from tpusim_torch.obs.series import FRAG_CATEGORY_NAMES

        frag, used, used_cpu = [], [], []
        cats = [[] for _ in FRAG_CATEGORY_NAMES]
        for rep in self.event_reports:
            s = rep.get("series", {})
            if "_frag_milli_f" in s:
                frag.extend(np.asarray(s["_frag_milli_f"],
                                       np.float64).tolist())
            amounts = rep.get("frag_amounts")
            if amounts is not None:
                a = np.asarray(amounts, np.float64)
                for j in range(min(a.shape[1], len(cats))):
                    cats[j].extend(a[:, j].tolist())
            used.extend(np.asarray(rep["used_gpu_milli"]).astype(
                np.int64).tolist())
            used_cpu.extend(np.asarray(rep["used_cpu_milli"]).astype(
                np.int64).tolist())
        out = {}
        if frag:
            out["frag_gpu_milli"] = frag
        if used:
            out["used_gpu_milli"] = used
        if used_cpu:
            out["used_cpu_milli"] = used_cpu
        for name, vals in zip(FRAG_CATEGORY_NAMES, cats):
            if vals:
                out[f"frag_{name}_milli"] = vals
        return out

    def _telemetry_meta(self) -> dict:
        """The run's deterministic description for the telemetry record
        (tpusim's _telemetry_meta: the same across same-seed runs, no
        walls, no paths; the port has no mesh, so mesh is 0)."""
        cfg = self.cfg
        return {
            "policies": [[n, w] for n, w in cfg.policies],
            "gpu_sel": cfg.gpu_sel_method,
            "norm": cfg.norm_method,
            "dim_ext": cfg.dim_ext_method,
            "seed": cfg.seed,
            "engine_cfg": cfg.engine,
            "block_size": cfg.block_size,
            "mesh": 0,
            "nodes": len(self.nodes),
        }

    def run_telemetry(self):
        """The RunTelemetry snapshot so far (spans, counters, cache and
        fault counts), also attached to every SimulateResult."""
        return self.obs.snapshot(meta=self._telemetry_meta())

    def _placed_state(self) -> NodeState:
        """The last result's state on the Simulator's device."""
        return NodeState(*(a.to(self.device) for a in self.last_result.state))

    def schedule_additional(self, pods: Sequence[PodRow]
                            ) -> List[UnscheduledPod]:
        """Replay `pods` on the current cluster state and append them to the
        run's result (driver.py:1764 of the reference): the engine behind
        the apps (core.go:255-261) and the new-workload swap
        (core.go:195-209). Events are the pods' creations in list order."""
        if self.typical is None:
            self.set_typical_pods()
        res = self.last_result
        out, events, failed, rank = self._replay_pods(
            self._placed_state(), pods,
            prng_key(self.cfg.seed + len(res.pods)), use_timestamps=False)
        res.state = out.state
        res.pods = list(res.pods) + list(pods)
        res.placed_node = np.concatenate([res.placed_node,
                                          out.placed_node.numpy()])
        res.dev_mask = np.concatenate([res.dev_mask, out.dev_mask.numpy()])
        res.unscheduled_pods = list(res.unscheduled_pods) + failed
        prior_events = res.events
        res.events += events
        if out.series is not None:
            # the appended replay's sample clock starts at 0: rebase it
            # onto the run's event clock
            res.series = concat_series([res.series, out.series._replace(
                pos=np.asarray(out.series.pos) + prior_events)])
        if out.decisions is not None:
            # the appended replay's events index its own pod list
            res.decisions = concat_logs([res.decisions, out.decisions._replace(
                ev_pod=np.asarray(out.decisions.ev_pod)
                + (len(res.pods) - len(pods)))])
        res.telemetry = self.run_telemetry()
        base = int(res.creation_rank.max(initial=-1)) + 1
        res.creation_rank = np.concatenate(
            [res.creation_rank, np.where(rank >= 0, rank + base, -1)])
        return failed

    def schedule_app(self, name: str, pods: Sequence[PodRow],
                     use_greed: bool = False) -> List[UnscheduledPod]:
        """ScheduleApp (simulator.go:224-237): the app's pods through the
        affinity and toleration queues (greed first with use_greed), then
        scheduled on the current state."""
        ordered = app_queue(pods, self.nodes, use_greed)
        self.log.info(f"Scheduling app {name}: {len(ordered)} pods")
        return self.schedule_additional(ordered)

    def run(self) -> SimulateResult:
        """Full experiment (core.go:86-268 minus deschedule and inflation):
        typical pods, prepare, schedule with the per-event reports, the
        failed-pods block and the Cluster Analysis block."""
        self._reset_run_state()
        self.set_typical_pods()
        self.set_skyline_pods()
        pods = self.prepare_pods()
        self.log.info(
            f"Number of original workload pods: {len(self.workload_pods)}"
        )
        res = self.schedule_pods(pods)
        self.report_failed([u.pod for u in res.unscheduled_pods])
        self.cluster_analysis("InitSchedule")
        return res

    def run_sweep(self, weights, seeds=None, bucket: int = 512, tunes=None,
                  faults=None) -> List["SweepLane"]:
        """run()'s workload preparation, then one lanes replay of B
        (weight row, seed) configurations of this Simulator's policy
        family (schedule_pods_sweep); returns a SweepLane a configuration.
        With `tunes`, a tuning ratio a lane: each lane's workload is
        prepared as a standalone run with that ratio (the same tuning seed)
        and the lanes run through schedule_pods_sweep_multi. With `faults`,
        a fault spec a lane (resolve_fault_spec), the chaos sweep: each
        lane replays under its schedule on the fault forms' lanes
        (schedule_pods_sweep_faults, or schedule_pods_sweep_multi's fault
        lanes with `tunes`)."""
        self._reset_run_state()
        self.set_typical_pods()
        self.log.info(
            f"Number of original workload pods: {len(self.workload_pods)}"
        )
        if faults is not None:
            if tunes is not None:
                w = np.asarray(weights, np.int32)
                if w.ndim != 2 or len(tunes) != int(w.shape[0]):
                    raise ValueError(
                        f"tunes has {len(tunes)} entries for weight grid "
                        f"of shape {w.shape} (want one tuning ratio per "
                        "weight row)"
                    )
                pods_list = [self.prepare_pods(tuning_ratio=t)
                             for t in tunes]
                return schedule_pods_sweep_multi(
                    self, pods_list, w, seeds=seeds, bucket=bucket,
                    fault_specs=faults)
            return schedule_pods_sweep_faults(self, self.prepare_pods(),
                                              weights, faults, seeds=seeds,
                                              bucket=bucket)
        if tunes is None:
            return schedule_pods_sweep(self, self.prepare_pods(), weights,
                                       seeds=seeds, bucket=bucket)
        w = np.asarray(weights, np.int32)
        if w.ndim != 2 or len(tunes) != int(w.shape[0]):
            raise ValueError(
                f"tunes has {len(tunes)} entries for weight grid of shape "
                f"{w.shape} (want one tuning ratio per weight row)"
            )
        pods_list = [self.prepare_pods(tuning_ratio=t) for t in tunes]
        return schedule_pods_sweep_multi(self, pods_list, w, seeds=seeds,
                                         bucket=bucket)

    def run_with_faults(self, fault_cfg: FaultConfig = None,
                        faults=None) -> SimulateResult:
        """run() under fault injection (driver.py:1918 of the reference):
        the same preparation, the main schedule replaced by
        schedule_pods_with_faults (apply's --fault-* flags land here)."""
        self._reset_run_state()
        self.set_typical_pods()
        self.set_skyline_pods()
        pods = self.prepare_pods()
        self.log.info(
            f"Number of original workload pods: {len(self.workload_pods)}"
        )
        res = self.schedule_pods_with_faults(pods, faults=faults,
                                             fault_cfg=fault_cfg)
        self.report_failed([u.pod for u in res.unscheduled_pods])
        self.cluster_analysis("InitSchedule")
        return res

    def report_failed(self, pods) -> None:
        """The failed-pods block, and the stash the fail CSV groups."""
        report_failed_pods(self.log, pods)
        self.failed_pod_lists.append(list(pods))

    def run_workload_inflation_evaluation(self, tag: str):
        """Clone extra workload pods onto the current cluster state, replay
        them with the per-event reports, report the failed ones, run the
        Cluster Analysis of the inflated state under `tag`, then drop them
        (simulator.go:1015-1132): the committed state is left as it was.
        None when no pod was cloned."""
        rng = np.random.default_rng(self.cfg.inflation_seed)
        extra = inflation_pods(
            self.workload_pods, self.cfg.inflation_ratio, rng,
            self.node_total_milli_cpu, self.node_total_milli_gpu,
            total_pod_cpu_milli(self.workload_pods),
            total_pod_gpu_milli(self.workload_pods))
        if not extra:
            return None
        self.log.info(f"(Inflation) Num of Total Pods: {len(extra)}")
        out, _, unscheduled, _ = self._replay_pods(
            self._placed_state(), extra, prng_key(self.cfg.inflation_seed),
            use_timestamps=False)
        self.report_failed([u.pod for u in unscheduled])
        self.log.info(f"[ReportFailedPods] {len(unscheduled)} unscheduled "
                      "inflation pods")
        saved = self.last_result.state
        self.last_result.state = out.state
        analysis = self.cluster_analysis(tag)
        self.last_result.state = saved
        return analysis

    def deschedule_cluster(self) -> List[UnscheduledPod]:
        """Evict pods by the configured policy, report PostEviction, then
        replay the victims from the evicted state (DescheduleCluster,
        deschedule.go:20-47, as driver.py:2017-2108 of the reference runs
        it; the caller follows with cluster_analysis("PostDeschedule")).
        The victims re-enter as creations in eviction order, from root key
        PRNGKey(seed + 1), through the kernels and the report tail; their
        creation ranks follow every earlier one, and those that fail join
        the unscheduled pods. Returns them."""
        res = self.last_result
        # the reference scores and replays the victims without pinning
        specs = pods_to_specs(res.pods, None, self.device)
        state = self._placed_state()
        victims = select_victims(
            state, specs, res.placed_node, res.dev_mask, self.typical,
            self.cfg.deschedule_policy, self.cfg.deschedule_ratio,
            self.node_names)
        budget = math.ceil(self.cfg.deschedule_ratio
                           * int((res.placed_node >= 0).sum()))
        self.log.info(
            f"maximum number of pods that can be descheduled: {budget}, "
            f"deschedule policy: {self.cfg.deschedule_policy}"
        )
        state = evict(state, specs, res.placed_node, res.dev_mask, victims)
        res.state = device_fetch(state)
        res.placed_node = res.placed_node.copy()
        res.dev_mask = res.dev_mask.copy()
        res.placed_node[victims] = -1
        res.dev_mask[victims] = False
        self.cluster_analysis("PostEviction")
        self.log.info(
            f"[DescheduleCluster] Num of Descheduled Pods: {len(victims)}")
        if not victims:
            return []
        v = np.asarray(victims, np.int64)
        vpods = [res.pods[int(i)] for i in v]
        vspecs = PodSpec(*(a[torch.as_tensor(v, device=self.device)]
                           for a in specs))
        ev_kind = np.zeros(len(v), np.int32)  # an EV_CREATE stream
        ev_pod = np.arange(len(v), dtype=np.int32)
        t0 = time.perf_counter()
        out = self.run_events(state, vspecs, ev_kind, ev_pod,
                              key=prng_key(self.cfg.seed + 1),
                              pod_rows=vpods)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        out = device_fetch(self._attach_metrics(out, state, vspecs, ev_kind,
                                                ev_pod))
        # the victims' replay reports as any other (deschedule.go:91 ->
        # SchedulePods)
        self._emit_event_reports(out, vpods, ev_kind, ev_pod, state)
        self.replay_times.append(dict(
            events=len(v), replay_ms=(t1 - t0) * 1e3,
            report_ms=(time.perf_counter() - t1) * 1e3))
        placed_v = out.placed_node.numpy()
        res.placed_node[v] = placed_v
        res.dev_mask[v] = out.dev_mask.numpy()
        res.state = out.state
        if res.creation_rank is not None:  # the victims re-enter last
            base = int(res.creation_rank.max(initial=-1)) + 1
            res.creation_rank = res.creation_rank.copy()
            res.creation_rank[v] = base + np.arange(len(v))
        failed = [UnscheduledPod(res.pods[v[i]])
                  for i in np.flatnonzero(placed_v < 0)]
        res.unscheduled_pods = list(res.unscheduled_pods) + failed
        self.log.info(f"[DescheduleCluster] Num of Failed Pods: {len(failed)}")
        return failed

    # ---- fault injection (tpusim_torch.sim.faults) ----

    def _fault_scan_blockers(self) -> list:
        """What keeps this configuration off the in-scan fault lane
        (tpusim's _fault_scan_blockers, of the options the port runs)."""
        out = []
        if self.cfg.report_per_event:
            out.append("per-event reporting (the report postpass does not "
                       "model fault transitions)")
        if self.cfg.extenders:
            out.append("extenders")
        if self.cfg.record_decisions:
            out.append("decision recording")
        if self.cfg.series_every:
            out.append("the in-scan series plane")
        if self.cfg.checkpoint_every:
            out.append("checkpointing (composes with the segmented path)")
        if self.cfg.engine == "pallas":
            out.append("the fused pallas engine")
        if self.cfg.heartbeat_every:
            out.append("the in-scan heartbeat")
        return out

    def schedule_pods_with_faults(self, pods: Sequence[PodRow], faults=None,
                                  fault_cfg: FaultConfig = None
                                  ) -> SimulateResult:
        """schedule_pods under a fault schedule (driver.py:2147-2187 of the
        reference): the in-scan fault lane (_schedule_pods_faults_scan, one
        launch of the replays' fault forms over the merged stream) or the
        segmented host loop. `fault_mode` "scan" takes the lane and raises
        ValueError for a configuration it cannot serve; "segments" takes
        the loop; "auto" takes the lane unless a blocker of
        _fault_scan_blockers or a configuration that draws per event keeps
        it on the loop, and then logs why, as tpusim's auto does."""
        mode = self.cfg.fault_mode
        if mode not in ("auto", "scan", "segments"):
            raise ValueError(
                f"unknown fault_mode {mode!r}: expected auto | scan | "
                "segments"
            )
        blockers = self._fault_scan_blockers()
        if mode == "scan" and blockers:
            raise ValueError(
                f"fault_mode='scan' cannot serve this config: {blockers[0]}"
            )
        if mode == "auto" and not blockers and \
                self._replay.config.randomized:
            # the lane draws one key chain over the merged stream, the loop
            # one a segment: auto keeps the loop's results
            blockers = ["per-event randomness draws a different (still "
                        "seeded) PRNG chain on the scan lane; "
                        "fault_mode='scan' opts in"]
        if mode == "segments" or blockers:
            if blockers and mode == "auto":
                self.log.info(f"[Fault] segmented replay ({blockers[0]})")
            return self._schedule_pods_with_faults_segmented(pods, faults,
                                                             fault_cfg)
        return self._schedule_pods_faults_scan(pods, faults, fault_cfg)

    def _schedule_pods_faults_scan(self, pods: Sequence[PodRow], faults=None,
                                   fault_cfg: FaultConfig = None
                                   ) -> SimulateResult:
        """schedule_pods_with_faults on the in-scan fault lane
        (driver.py:2486-2577 of the reference): the schedule compiled into
        one merged stream (fault_lane.compile_fault_plan), one init_tables
        and one launch of a fault form (_dispatch_fault_scan), one fetch,
        then the DisruptionMetrics from the carry and the steps' outputs,
        the [Fault] lines rebuilt from them, the unscheduled pods (the dead
        ones as "max-retries-exceeded") and the creation ranks. The run's
        `replay_times` entry splits the plan's compile (plan_ms), the
        kernels up to a synchronise (replay_ms), the fetch (fetch_ms) and
        the host tail after it (report_ms), host clock."""
        if self.cfg.use_timestamps:
            raise ValueError(
                "schedule_pods_with_faults replays creation-ordered traces "
                "(use_timestamps=False); model deletions as Evict fault "
                "events instead"
            )
        if self.typical is None:
            self.set_typical_pods()
        fcfg = fault_cfg or FaultConfig()
        pods = list(pods)
        ev_kind, ev_pod = build_events(pods, False)
        if faults is None:
            faults = generate_fault_schedule(len(self.nodes), len(ev_kind),
                                             fcfg)
        t0 = time.perf_counter()
        specs = pods_to_specs(pods, self.node_index, self.device)
        plan = fault_lane.compile_fault_plan(
            ev_kind, ev_pod, faults, fcfg, len(self.nodes), len(pods))
        t_plan = time.perf_counter()
        with self.obs.span("scan", events=int(plan.kind.shape[0])):
            out, fout = self._dispatch_fault_scan(specs, plan)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        t_run = time.perf_counter()
        with self.obs.span("fetch", events=int(plan.kind.shape[0])):
            out, fout = device_fetch((out, fout))
        t_fetch = time.perf_counter()
        dm, dead, attempts_run = fault_lane.assemble_disruption(
            plan, fout.ys, fout.carry, self.init_state.gpu_cnt.cpu().numpy())
        e_m = int(plan.kind.shape[0])
        # the merged stream's counters as tpusim's lane counts them: a
        # popped retry slot is a create, every other slot and fault step a
        # skip, which the padding correction takes out again
        kinds = np.asarray(plan.kind)
        popped = fout.ys.rpod.numpy() >= 0
        eff = np.where(kinds > EV_SKIP,
                       np.where(popped, EV_CREATE, EV_SKIP), kinds)
        self.obs.note_scan(
            self.last_engine, counters=counters_from_events(
                torch.as_tensor(eff, dtype=torch.int32), out.event_node),
            pad_skips=e_m - plan.num_events - attempts_run,
            events=plan.num_events + attempts_run)
        self.obs.note_disruption(dm)
        self.log.info(
            f"[Engine] fault-lane replay of {plan.num_events} events "
            f"(+{attempts_run} retries, merged stream {e_m}) ran on: "
            f"{_ran_on(self, self.last_engine, self.last_residency)}")
        self._emit_fault_log_lines(plan, fout.ys, pods)
        self.analysis_summary.update(disruption_report_block(self.log, dm))
        self.last_disruption = dm
        placed = out.placed_node.numpy()
        ever_failed = out.ever_failed.numpy()
        skipped = np.array([p.unscheduled for p in pods], bool)
        unscheduled = []
        for i in range(len(pods)):
            if skipped[i]:
                unscheduled.append(UnscheduledPod(
                    pods[i], reason="pod-unscheduled annotation"))
            elif dead[i]:
                unscheduled.append(UnscheduledPod(
                    pods[i], reason="max-retries-exceeded"))
            elif placed[i] < 0 and bool(ever_failed[i]):
                unscheduled.append(UnscheduledPod(pods[i]))
        self.last_ever_failed = ever_failed
        self.last_result = SimulateResult(
            unscheduled_pods=unscheduled,
            placed_node=placed,
            dev_mask=out.dev_mask.numpy(),
            state=out.state,
            pods=pods,
            node_names=self.node_names,
            wall_seconds=time.perf_counter() - t0,
            events=plan.num_events + attempts_run,
            creation_rank=fault_lane.fault_creation_rank(plan, fout.ys,
                                                         len(pods)),
            telemetry=self.run_telemetry(),
        )
        self.replay_times.append(dict(
            events=e_m, plan_ms=(t_plan - t0) * 1e3,
            replay_ms=(t_run - t_plan) * 1e3,
            fetch_ms=(t_fetch - t_run) * 1e3,
            report_ms=(time.perf_counter() - t_fetch) * 1e3))
        return self.last_result

    def _dispatch_fault_scan(self, specs: PodSpec, plan):
        """One fault-lane replay (the non-mesh half of driver.py:2579-2698
        of the reference): init_tables, then the fault form of the replay
        residency.replay_tier picks, `replay_faults` or
        `replay_blocked_faults` (over the nodes padded to whole blocks),
        from root key PRNGKey(seed); under engine="sequential" the
        oracle's fault form instead. Returns (ReplayResult, FaultOut) on
        the device, the state and the down clock over the cluster's
        nodes."""
        if plan.kind.shape[0] and not specs.cpu.shape[0]:
            raise ValueError("the fault lane replays a workload of at least "
                             "one pod")
        state, rank, tp = self.init_state, self.rank, self.typical
        n, p = state.num_nodes, int(specs.cpu.shape[0])
        if self.cfg.engine == "sequential":
            lane = fault_lane.lane_of(plan, state, p)
            out = self._sequential_replay(True, plan.has_recover)(
                state, specs, plan.kind, plan.idx, tp,
                prng_key(self.cfg.seed), rank, fault_ops=lane.ops,
                fault_carry0=lane.carry)
            self._host_loop("sequential")
            return out
        types = build_pod_types(specs)
        cfg = self._replay.config
        tier = self._residency(n, types.num_types)
        kinds = torch.as_tensor(plan.kind, device=self.device)
        idx = torch.as_tensor(plan.idx, device=self.device)
        if tier == "hbm":
            padded, rank_p = pad_nodes(state, rank, BLOCK)
            tables = init_tables(padded, types, tp, cfg)
            out, stats, fout = replay_blocked_faults(
                padded, specs, types, kinds, idx, tp, rank_p, tables, cfg,
                fault_lane.lane_of(plan, padded, p))
            out = out._replace(state=trim_nodes(out.state, n))
            fout = fout._replace(carry=fout.carry._replace(
                down_at=fout.carry.down_at[:n]))
            kernel, self.last_kernel_stats = ("replay_blocked_faults",
                                              stats.tolist())
        else:
            tables = init_tables(state, types, tp, cfg)
            out, fout = replay_faults(
                state, specs, types, kinds, idx, tp, rank, tables, cfg,
                fault_lane.lane_of(plan, state, p), prng_key(self.cfg.seed))
            kernel, self.last_kernel_stats = "replay_faults", None
        if self.device.type != "cuda":
            kernel = f"plain_{kernel}"
        self.last_engine, self.last_residency = kernel, tier
        return out, fout

    def _emit_fault_log_lines(self, plan, ys, pods):
        """The segmented loop's [Fault] lines, rebuilt from the plan and the
        steps' outputs (driver.py:2700 of the reference): the down and up
        transitions follow from the schedule, the victims from the
        outputs."""
        nvict = np.asarray(ys.nvict)
        vpod = np.asarray(ys.vpod)
        vnode = np.asarray(ys.vnode)
        fb = np.asarray(ys.fb, np.float64)
        fa = np.asarray(ys.fa, np.float64)
        down: set = set()
        for i, k in enumerate(plan.kind.tolist()):
            pos = int(plan.pos[i])
            a = int(plan.arg[i])
            if k == EV_NODE_FAIL and a not in down:
                down.add(a)
                self.log.info(
                    f"[Fault] node {self.node_names[a]} failed at event "
                    f"{pos}: {int(nvict[i])} pods evicted"
                )
            elif k == EV_NODE_RECOVER and a in down:
                down.discard(a)
                delta = float(fa[i]) - float(fb[i])
                self.log.info(
                    f"[Fault] node {self.node_names[a]} recovered at "
                    f"event {pos} (frag delta {delta:+.1f})"
                )
            elif k == EV_EVICT and int(vpod[i]) >= 0:
                self.log.info(
                    f"[Fault] pod {pods[int(vpod[i])].name} evicted from "
                    f"node {self.node_names[int(vnode[i])]} at event {pos}"
                )

    def _schedule_pods_with_faults_segmented(self, pods: Sequence[PodRow],
                                             faults=None,
                                             fault_cfg: FaultConfig = None
                                             ) -> SimulateResult:
        """The host loop (driver.py:2189-2484 of the reference): node
        failures, recoveries and evictions fire between replay segments,
        evicted pods re-enter through a capped exponential backoff queue
        (RetryQueue), and a pod out of retries is terminal (reason
        "max-retries-exceeded").

        `faults`: an explicit FaultEvent list, or None for the seeded
        schedule of `fault_cfg` (generate_fault_schedule). Each segment is
        one run_events call (an init_tables launch and a replay launch on
        the card) from root key fold_in(PRNGKey(seed), segment), followed
        by the report tail. Creation-ordered traces only
        (use_timestamps=False): model deletions as EV_EVICT faults. The
        totals land in `last_disruption` and the `[Disruption]` block."""
        if self.cfg.use_timestamps:
            raise ValueError(
                "schedule_pods_with_faults replays creation-ordered traces "
                "(use_timestamps=False); model deletions as Evict fault "
                "events instead"
            )
        if self.typical is None:
            self.set_typical_pods()
        fcfg = fault_cfg or FaultConfig()
        pods = list(pods)
        ev_kind, ev_pod = build_events(pods, False)
        num_events = len(ev_kind)
        if faults is None:
            faults = generate_fault_schedule(len(self.nodes), num_events, fcfg)
        faults = sorted(faults, key=lambda f: f.pos)  # stable
        validate_fault_schedule(faults, len(self.nodes), len(pods))
        t0 = time.perf_counter()

        num_pods = len(pods)
        specs = pods_to_specs(pods, self.node_index, self.device)
        types = build_pod_types(specs)
        gpu_cnt = self.init_state.gpu_cnt.cpu().numpy()
        ndev = int(self.init_state.gpu_left.shape[1])
        placed = np.full(num_pods, -1, np.int32)
        masks = np.zeros((num_pods, ndev), bool)
        ever_failed = np.zeros(num_pods, bool)
        creation_rank = np.full(num_pods, -1, np.int64)
        base_key = prng_key(self.cfg.seed)
        rq = RetryQueue(fcfg.backoff_base, fcfg.backoff_cap,
                        fcfg.max_retries)
        dm = DisruptionMetrics()
        attempts: dict = {}  # pod -> failed retries in a row so far
        evicted_at: dict = {}  # pod -> eviction position
        down_at: dict = {}  # node -> failure position
        box = {"state": self.init_state, "rank": 0, "events": 0, "segs": 0}
        typical_host = None
        dec_logs, ser_logs = [], []

        def frag_total(st: NodeState) -> float:
            nonlocal typical_host
            if typical_host is None:
                typical_host = device_fetch(self.typical)
            amounts = cluster_frag_report(device_fetch(st), typical_host)[0]
            return float(frag_sum_except_q3(torch.as_tensor(amounts)))

        def run_segment(seg_kind: np.ndarray, seg_pod: np.ndarray):
            """One segment through run_events and the report tail; merges
            its placements into the host's arrays."""
            seg_key = fold_in(base_key, box["segs"])
            box["segs"] += 1
            pre = box["state"]
            t_seg = time.perf_counter()
            # the run-level heartbeat window: this segment's ticks report
            # the events so far plus its own progress
            self._hb_base = box["events"]
            out = self.run_events(pre, specs, seg_kind, seg_pod,
                                  types=types, key=seg_key, pod_rows=pods)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_rep = time.perf_counter()
            box["state"] = out.state
            out = device_fetch(self._attach_metrics(out, pre, specs,
                                                    seg_kind, seg_pod))
            self._emit_event_reports(out, pods, seg_kind, seg_pod, pre)
            if out.series is not None:
                # each segment is a replay of its own, so it opens with a
                # sample of the post-fault cluster at stride position 0:
                # rebase onto the run's event clock and stamp the retry
                # queue's depth (host state the replay cannot see)
                ser_logs.append(log_from_stacked(
                    records.on_host(out.series), base_pos=box["events"],
                    retry_depth=len(rq)))
            if out.decisions is not None:
                dec_logs.append(DecisionLog(
                    records.on_host(out.decisions), np.asarray(seg_kind),
                    np.asarray(seg_pod)))
            self.replay_times.append(dict(
                events=int(seg_kind.size), replay_ms=(t_rep - t_seg) * 1e3,
                report_ms=(time.perf_counter() - t_rep) * 1e3))
            created = seg_pod[seg_kind == EV_CREATE]
            placed[created] = out.placed_node.numpy()[created]
            masks[created] = out.dev_mask.numpy()[created]
            ever_failed[created] |= out.ever_failed.numpy()[created]
            creation_rank[created] = box["rank"] + np.arange(created.size)
            box["rank"] += int(created.size)
            box["events"] += int(seg_kind.size)

        def evict_bookkeep(pod_i: int, pos: int):
            placed[pod_i] = -1
            masks[pod_i] = False
            evicted_at[pod_i] = pos
            dm.evicted_pods += 1
            att = attempts.get(pod_i, 0) + 1
            attempts[pod_i] = att
            # rq.dead is the terminal list; its totals are read after the
            # loop
            if rq.push(pod_i, pos, att) is None:
                ever_failed[pod_i] = True
            else:
                dm.retries_enqueued += 1

        def apply_fault(f, pos: int):
            if f.kind == EV_NODE_FAIL:
                if f.node in down_at:
                    return  # already down
                victims = np.flatnonzero(placed == f.node)
                box["state"] = fail_node(box["state"], f.node)
                down_at[f.node] = pos
                dm.node_failures += 1
                self.log.info(
                    f"[Fault] node {self.node_names[f.node]} failed at "
                    f"event {pos}: {victims.size} pods evicted"
                )
                for v in victims.tolist():
                    evict_bookkeep(int(v), pos)
            elif f.kind == EV_NODE_RECOVER:
                if f.node not in down_at:
                    return  # never failed, or already back
                before = frag_total(box["state"])
                box["state"] = recover_node(box["state"], f.node)
                after = frag_total(box["state"])
                dm.post_recovery_frag_delta.append(after - before)
                dm.node_recoveries += 1
                dm.failed_node_gpu_events += int(gpu_cnt[f.node]) * (
                    pos - down_at.pop(f.node))
                self.log.info(
                    f"[Fault] node {self.node_names[f.node]} recovered at "
                    f"event {pos} (frag delta {after - before:+.1f})"
                )
            else:  # an eviction
                v = pick_eviction_victim(placed, pos, fcfg.seed, f.pod)
                if v is None:
                    return  # nothing placed to evict
                box["state"] = evict(box["state"], specs, placed, masks, [v])
                self.log.info(
                    f"[Fault] pod {pods[v].name} evicted from node "
                    f"{self.node_names[int(placed[v])]} at event {pos}"
                )
                evict_bookkeep(int(v), pos)

        fi = 0
        cursor = 0
        while True:
            candidates = [num_events] if cursor < num_events else []
            if fi < len(faults):
                candidates.append(min(faults[fi].pos, num_events))
            nr = rq.next_ready()
            if nr is not None:
                candidates.append(min(nr, num_events))
            if not candidates:
                break
            stop = min(candidates)
            if stop > cursor:
                run_segment(ev_kind[cursor:stop], ev_pod[cursor:stop])
                cursor = stop
            pos = stop
            # faults fire first, so a retry due at the same position sees
            # the cluster after the fault
            while fi < len(faults) and min(faults[fi].pos, num_events) <= pos:
                apply_fault(faults[fi], pos)
                fi += 1
            # once the trace and the faults are done, the queue is flushed
            # whatever its backoff: nothing is left to wait for
            thresh = (pos if (cursor < num_events or fi < len(faults))
                      else float("inf"))
            due = rq.pop_due(thresh)
            if due:
                retry_idx = np.array([p for p, _ in due], np.int32)
                run_segment(np.zeros(retry_idx.size, np.int32), retry_idx)
                for pod_i, _att in due:
                    if placed[pod_i] >= 0:
                        dm.rescheduled_pods += 1
                        dm.reschedule_latency_events.append(
                            pos - evicted_at.pop(pod_i))
                        # the budget counts failures in a row: a
                        # reschedule resets it
                        attempts.pop(pod_i, None)
                    else:
                        att = attempts[pod_i] + 1
                        attempts[pod_i] = att
                        if rq.push(pod_i, pos, att) is not None:
                            dm.retries_enqueued += 1

        # capacity still down at the end counts to the end of the trace
        for node_i, t_fail in down_at.items():
            dm.failed_node_gpu_events += int(gpu_cnt[node_i]) * max(
                num_events - t_fail, 0)
        dead_pods = {p for p, _ in rq.dead}
        dm.unscheduled_after_retries = len(rq.dead)
        self.analysis_summary.update(disruption_report_block(self.log, dm))
        self.last_disruption = dm
        self.obs.note_disruption(dm)
        self._hb_base = 0  # later replays report from a fresh clock

        skipped = np.array([p.unscheduled for p in pods], bool)
        unscheduled = []
        for i in range(num_pods):
            if skipped[i]:
                unscheduled.append(UnscheduledPod(
                    pods[i], reason="pod-unscheduled annotation"))
            elif i in dead_pods:
                unscheduled.append(UnscheduledPod(
                    pods[i], reason="max-retries-exceeded"))
            elif placed[i] < 0 and bool(ever_failed[i]):
                unscheduled.append(UnscheduledPod(pods[i]))
        self.last_ever_failed = ever_failed
        self.last_result = SimulateResult(
            unscheduled_pods=unscheduled,
            placed_node=placed,
            dev_mask=masks,
            state=device_fetch(box["state"]),
            pods=pods,
            node_names=self.node_names,
            wall_seconds=time.perf_counter() - t0,
            events=box["events"],
            creation_rank=creation_rank,
            telemetry=self.run_telemetry(),
            decisions=concat_logs(dec_logs),
            series=concat_series(ser_logs),
        )
        return self.last_result

    # ---- snapshot export (export.go) ----

    def export_pod_snapshot_yaml(self, path: str):
        r = self.last_result
        export_pod_snapshot_yaml(r.pods, r.placed_node, r.dev_mask,
                                 self.node_names, path,
                                 creation_rank=r.creation_rank)

    def export_pod_snapshot_csv(self, path: str):
        r = self.last_result
        export_pod_snapshot_csv(r.pods, r.placed_node, r.dev_mask,
                                self.nodes, path)

    def export_node_snapshot_csv(self, path: str):
        r = self.last_result
        num_pods = np.zeros(len(self.nodes), np.int64)
        np.add.at(num_pods, r.placed_node[r.placed_node >= 0], 1)
        export_node_snapshot_csv(
            NodeState(*(a.numpy() for a in r.state)), self.nodes, num_pods,
            path)

    def finish(self):
        """The unscheduled-count line (apply.go:228). The analysis parser
        stops at it, so it comes after the experiment's last Cluster
        Analysis block: call it once, at the end."""
        self.log.info(f"there are {len(self.last_result.unscheduled_pods)}"
                      " unscheduled pods")

    # ---- the per-event report (simulator.go:410-427) ----

    def _typical_host_rows(self):
        """The typical pods as (cpu, gpu_milli, gpu_num, gpu_mask, freq)
        rows on the host, for the Bellman evaluator."""
        t = device_fetch(self.typical)
        return list(zip(*(a.tolist() for a in t)))

    def _bellman_series(self, start_state: NodeState, pods, ev_kind, ev_pod,
                        out: ReplayResult) -> np.ndarray:
        """The cluster's Bellman frag after each event (the `(bellman)`
        [Report] line, analysis.go:110), f64[E]: each event's touched node
        is rebuilt from the telemetry and only its memoised value is
        updated, in one call of the C++ evaluator. The value depends on the
        node's state alone, so this equals the reference's sweep over every
        node after every event.

        The series is a pure function of the typical rows, the start state
        and the event stream with its telemetry, so a Simulator's first
        series goes through a content-keyed disk cache (_bellman_cache_path;
        TPUSIM_BELLMAN_CACHE names its directory, an empty value turns it
        off). Later series depend on the memo the earlier ones warmed, so
        they are neither read nor written there; after a hit, the cached
        call's inputs are evaluated first, so the memo, and every later
        value, is what an uncached run's would be."""
        from tpusim_torch.native import BellmanEvaluator

        kinds = np.asarray(ev_kind)
        ev_pods = np.asarray(ev_pod)
        pod_cpu = np.fromiter((p.cpu_milli for p in pods), np.int32,
                              count=len(pods))
        pod_gpu = np.fromiter((p.gpu_milli for p in pods), np.int32,
                              count=len(pods))
        s = device_fetch(start_state)
        inputs = tuple(np.ascontiguousarray(a) for a in (
            s.cpu_left.numpy().astype(np.int32),
            s.gpu_left.numpy().astype(np.int32),
            s.gpu_type.numpy().astype(np.int32),
            out.event_node.numpy().astype(np.int32),
            out.event_dev.numpy().astype(np.uint8),
            np.where(kinds == EV_CREATE, 1, -1).astype(np.int8),
            pod_cpu[ev_pods], pod_gpu[ev_pods]))
        first = self._bellman_eval is None and self._bellman_pending is None
        path = self._bellman_cache_path(inputs) if first else None
        if path is not None and os.path.isfile(path):
            self._bellman_pending = inputs
            return np.load(path)
        if self._bellman_eval is None:
            self._bellman_eval = BellmanEvaluator(self._typical_host_rows())
            if self._bellman_pending is not None:
                self._bellman_eval.eval_series(*self._bellman_pending)
                self._bellman_pending = None
        series = self._bellman_eval.eval_series(*inputs)
        if path is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp.npy"
            with open(tmp, "wb") as f:
                np.save(f, series)
            os.replace(tmp, path)
        return series

    def _bellman_cache_path(self, inputs):
        """The cache file of a first Bellman series with these inputs, or
        None where the cache is off: under TPUSIM_BELLMAN_CACHE, by default
        .bellman_cache/ at the repository's root. The key hashes the port's
        tag and evaluator source (tpusim's entries, under another key,
        are never read), the typical rows and the inputs."""
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cache_dir = os.environ.get("TPUSIM_BELLMAN_CACHE",
                                   os.path.join(root, ".bellman_cache"))
        if not cache_dir:
            return None
        h = hashlib.sha256(_bellman_source_digest())
        for row in self._typical_host_rows():
            h.update(repr(row).encode())
        for a in inputs:
            h.update(a.tobytes())
        return os.path.join(cache_dir, h.hexdigest() + ".npy")

    def _emit_event_reports(self, out: ReplayResult, pods, ev_kind, ev_pod,
                            start_state: NodeState):
        """The per-event log block: each event's `[i] attempt to ...` line
        (simulator.go:410, 420; a failed create adds the deletePod rollback
        line, :354), then its [Report] origin and bellman, [Alloc],
        [AllocCPU] and [Power] lines (simulator.go:426-427,
        analysis.go:109-118). Skip events emit nothing
        (simulator.go:391-399). Nothing without per-event reporting. `out`
        is on the host."""
        if not self.cfg.report_per_event or out.metrics is None:
            return
        with self.obs.span("report", events=len(ev_kind)):
            bellman = self._bellman_series(start_state, pods, ev_kind,
                                           ev_pod, out)
            self._format_event_reports(out, pods, ev_kind, ev_pod, bellman)

    def _format_event_reports(self, out: ReplayResult, pods, ev_kind, ev_pod,
                              bellman: np.ndarray):
        """Format the block from the host metrics and the Bellman series,
        every line family over all events at once, append it to the log in
        one call, and stash the structured series for the analysis CSVs."""
        m = out.metrics
        amounts = m.frag_amounts.numpy()
        kinds = np.asarray(ev_kind)
        ev_pods = np.asarray(ev_pod)
        pod_names = np.array([p.name for p in pods])[ev_pods]
        ev_failed = out.ever_failed.numpy()[ev_pods]
        cols = {k: getattr(m, k).numpy() for k in (
            "used_nodes", "used_gpus", "used_gpu_milli", "arrived_gpu_milli",
            "used_cpu_milli", "arrived_cpu_milli")}
        series = event_report_series(amounts, m.power_cpu.numpy(),
                                     m.power_gpu.numpy(), bellman)
        self.event_reports.append(dict(
            series=series, frag_amounts=amounts, kinds=kinds,
            pod_names=pod_names, failed=ev_failed, total_gpus=self.total_gpus,
            **cols))
        self.log.info_many(batch_event_report_msgs(
            amounts, self.total_gpus, cols["used_nodes"], cols["used_gpus"],
            cols["used_gpu_milli"], cols["arrived_gpu_milli"],
            cols["used_cpu_milli"], cols["arrived_cpu_milli"],
            m.power_cpu.numpy(), m.power_gpu.numpy(), bellman=bellman,
            kinds=kinds, ev_create=EV_CREATE, ev_delete=EV_DELETE,
            pod_names=pod_names, failed=ev_failed, series=series))

    # ---- reporting (analysis.go:145-199, alloc.go:90-127) ----

    def alloc_maps(self, state: NodeState):
        """Cluster requested/allocatable per resource."""
        s = {k: v.cpu().numpy() for k, v in state._asdict().items()}
        slot = np.arange(s["gpu_left"].shape[1])[None, :] < s["gpu_cnt"][:, None]
        used_dev = slot & (s["gpu_left"] < MILLI)
        requested = {
            "MilliCpu": int((s["cpu_cap"] - s["cpu_left"]).sum()),
            "Memory": int(np.int64(s["mem_cap"] - s["mem_left"]).sum()
                          * 1024 * 1024),
            "Gpu": int(used_dev.sum()),
            "MilliGpu": int(np.where(slot, MILLI - s["gpu_left"], 0).sum()),
        }
        allocatable = {
            "MilliCpu": int(np.int64(s["cpu_cap"]).sum()),
            "Memory": int(np.int64(s["mem_cap"]).sum() * 1024 * 1024),
            "Gpu": int(s["gpu_cnt"].sum()),
            "MilliGpu": int(s["gpu_cnt"].sum()) * MILLI,
        }
        return requested, allocatable

    def cluster_analysis(self, tag: str = "InitSchedule", _amounts=None):
        """The end-of-stage 16-line analysis block. The frag amounts are
        summed on the host in a fixed order, whatever the device; a seed
        batch passes each lane's, summed in that order on the device
        (_batched_frag_amounts)."""
        state = (self.last_result.state if self.last_result is not None
                 else self.init_state)
        state = NodeState(*(a.cpu() for a in state))
        if _amounts is not None:
            amounts = np.asarray(_amounts, np.float32)
        else:
            typical = type(self.typical)(*(a.cpu() for a in self.typical))
            amounts = cluster_frag_report(state, typical)[0]
        requested, allocatable = self.alloc_maps(state)
        kv = cluster_analysis_block(self.log, tag, amounts, requested,
                                    allocatable)
        # the summary across stages, in emission order, for analysis.csv
        self.analysis_summary.update(kv)
        return amounts, requested, allocatable


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_ENGINE_SRC_DIGEST = None


def _engine_source_digest() -> bytes:
    """sha256 over the port's sources that determine a replay trajectory or
    the carry's layout (sim/, policies/, ops/, types.py, constants.py,
    io/storage.py, learn/policy.py, whose features are score columns, and
    the kernels' .cu sources), after a tag naming the
    port: the checkpoint and table-cache keys' salt. Editing any of them
    starts runs fresh instead of resuming into divergence, and the port
    never reads tpusim's files."""
    global _ENGINE_SRC_DIGEST
    if _ENGINE_SRC_DIGEST is None:
        import glob

        base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        files = [os.path.join(base, rel) for rel in
                 ("types.py", "constants.py", "io/storage.py",
                  "learn/policy.py")]
        for pattern in ("sim/*.py", "policies/*.py", "ops/*.py",
                        "kernels/*.cu"):
            files += glob.glob(os.path.join(base, pattern))
        h = hashlib.sha256(b"tpusim_torch replay checkpoint\0")
        for path in sorted(files):
            h.update(os.path.relpath(path, base).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
        _ENGINE_SRC_DIGEST = h.digest()
    return _ENGINE_SRC_DIGEST


def enable_compile_cache(cache_dir: str = ""):
    """Build and look for the kernels' library in `cache_dir`, else in
    $TPUSIM_COMPILE_CACHE_DIR (tpusim's enable_compile_cache, whose
    artefact is the compiled scan; the port's is its kernel library).
    Returns the directory, or None where neither is set (the default
    .tpusim_torch_build/). A library a process has already loaded stays
    loaded."""
    from tpusim_torch import kernels

    d = cache_dir or os.environ.get("TPUSIM_COMPILE_CACHE_DIR", "")
    if not d:
        return None
    kernels.set_build_dir(d)
    return d


def _bellman_source_digest() -> bytes:
    """The Bellman cache key's salt: a tag naming the port and the sha256
    of its evaluator's source, so a changed evaluator misses every entry."""
    from tpusim_torch import native

    h = hashlib.sha256(b"tpusim_torch bellman series\0")
    base = os.path.dirname(os.path.abspath(native.__file__))
    for name in ("bellman.cpp", "__init__.py"):
        with open(os.path.join(base, name), "rb") as f:
            h.update(f.read())
    return h.digest()


def _ran_on(sim: Simulator, kernel: str, tier, extra: str = "") -> str:
    """What an [Engine] line says ran: the kernel and its residency, or a
    host loop (the sequential oracle, the extender loop) and its device."""
    if tier is None:
        return f"the {kernel} host loop ({sim.device.type}{extra})"
    return f"{sim.engine}, {kernel} ({tier} residency{extra})"


# ---------------------------------------------------------------------------
# Lanes: seed batches and config sweeps as one launch (counterpart of the
# seed-batched and config-axis replays of tpusim/sim/driver.py)
# ---------------------------------------------------------------------------
#
# tpusim runs a seed group or a weight grid as one vmapped scan. Here each
# configuration is a lane of one launch of the lanes kernels
# (fused_engine.replay_lanes, hbm_engine.replay_blocked_lanes): a block a
# lane, every lane a serial replay of its own, side by side on the card's
# SMs. The tables hold raw per-policy scores, which neither the weights nor
# the tie-break rank touch, so one init_tables build serves every lane
# (copied per lane, which mutates its copy). The lanes run at their true
# sizes: the `bucket` arguments are accepted for tpusim's signatures and
# pad nothing.


def _lane_tensors(sim: Simulator, pods, use_timestamps: bool):
    """A lane's (pod specs, ev_kind, ev_pod) on the Simulator's device,
    the events checked on the host first."""
    specs = pods_to_specs(pods, sim.node_index, sim.device)
    ev_kind, ev_pod = build_events(pods, use_timestamps)
    validate_events(ev_kind, ev_pod, len(pods))
    return (specs, torch.as_tensor(ev_kind, device=sim.device),
            torch.as_tensor(ev_pod, device=sim.device))


def _config_row(cfg, lane_row) -> List[int]:
    """A lane's weights (in `cfg`'s policy order, lane_weights) back in the
    order of the [(name, weight)] list `cfg` was made from."""
    row = [0] * len(cfg.order)
    for j, i in enumerate(cfg.order):
        row[i] = int(lane_row[j])
    return row


def _launch_lanes(sim: Simulator, types, lanes) -> dict:
    """Queue the lanes (fused_engine.Lane, built over the Simulator's
    initial state) on the Simulator's device: init_tables once over the
    shared `types`, then the lanes kernel of the residency that
    residency.replay_tier picks for one lane of that shape. Under
    engine="sequential" each lane runs through the sequential oracle in
    turn instead, as a standalone run with its pods, events, rank, weights
    and key (tpusim vmaps its oracle over the lanes). Returns the results
    (a ReplayResult a lane, on the device) and what ran."""
    cfg = sim._replay.config
    state, tp = sim.init_state, sim.typical
    n = state.num_nodes
    if sim.cfg.engine == "sequential":
        replay = sim._sequential_replay()
        results = [replay(state, lane.pods, lane.ev_kind, lane.ev_pod, tp,
                          lane.key, lane.rank,
                          weights=_config_row(cfg, lane.weights))
                   for lane in lanes]
        sim._host_loop("sequential")
        return dict(results=results, stats=None, kernel="sequential",
                    tier=None)
    tier = sim._residency(n, types.num_types)
    if tier == "hbm":
        padded, _ = pad_nodes(state, lanes[0].rank, BLOCK)
        lanes = [lane._replace(rank=pad_rank(lane.rank, BLOCK))
                 for lane in lanes]
        tables = init_tables(padded, types, tp, cfg)
        outs = replay_blocked_lanes(padded, types, tp, tables, cfg, lanes)
        results = [o._replace(state=trim_nodes(o.state, n)) for o, _ in outs]
        stats = [st for _, st in outs]
        kernel = "replay_blocked_lanes"
    else:
        tables = init_tables(state, types, tp, cfg)
        results, stats = replay_lanes(state, types, tp, tables, cfg,
                                      lanes), None
        kernel = "replay_lanes"
    if sim.device.type != "cuda":
        kernel = f"plain_{kernel}"
    sim.last_engine, sim.last_residency = kernel, tier
    sim.last_kernel_stats = None
    return dict(results=results, stats=stats, kernel=kernel, tier=tier)


def _lane_metrics(sim: Simulator, results, lane_inputs):
    """Each lane's result with the metrics post-pass attached (per-event
    reporting on), on the lanes' device."""
    return [sim._attach_metrics(out, sim.init_state, specs, evk, evp)
            for out, (specs, evk, evp) in zip(results, lane_inputs)]


def _lane_frag_amounts(states: Sequence[NodeState], tp) -> np.ndarray:
    """The cluster frag amounts f32[B, 7] of B final states, in the order
    of cluster_frag_report (the reference's tree order over nodes and
    typical pods), summed for every lane at once by elementwise adds on
    the states' device: the bits of cluster_frag_report on each."""
    b, n = len(states), states[0].num_nodes
    cat = [torch.cat([getattr(s, f) for s in states])
           for f in ("cpu_left", "gpu_left", "gpu_type")]
    contrib = node_frag_contrib(*cat, tp)  # [B * N, T, 7]
    contrib = contrib.view(b, n, *contrib.shape[1:]).permute(1, 2, 0, 3)
    return tree_sum(contrib, 2).cpu().numpy()


@dataclass
class SweepLane:
    """One configuration's result out of a sweep: its lane's replay and the
    summary the sweep table prints. Placements are bit-identical to a
    standalone run with `weights` in the configuration and `seed` as
    cfg.seed."""

    weights: np.ndarray  # i32[num_pol] this lane's weight row
    seed: int
    placed_node: np.ndarray  # i32[P]
    dev_mask: np.ndarray  # bool[P, 8]
    ever_failed: np.ndarray  # bool[P]
    counters: object  # the in-scan counters: None (not in the port yet)
    metrics: object  # EventMetrics (per-event rows) or None
    state: NodeState  # final state, CPU tensors
    events: int
    placed: int  # pods placed at the end of the trace
    failed: int  # creation attempts rejected
    gpu_alloc_pct: float
    frag_gpu_milli: float
    # pods that ended the trace unplaced after a rejected creation (or out
    # of retries, in a chaos sweep)
    unscheduled: int = 0
    # a chaos-sweep lane's DisruptionMetrics (None in the other sweeps)
    disruption: object = None


def _check_sweep_grid(cfg: SimulatorConfig, weights, seeds):
    """Validate the [B, num_pol] weight grid and the per-lane seeds;
    returns (w, B, seeds) with the defaults resolved. Extender configs do
    not sweep: their per-cycle round-trips do not batch."""
    if cfg.extenders:
        raise ValueError(
            "schedule_pods_sweep cannot run extender configs (per-cycle "
            "HTTP round-trips do not batch)"
        )
    if cfg.record_decisions:
        raise ValueError(
            "schedule_pods_sweep cannot record decisions (the vmapped "
            "replay has no per-config provenance surface)"
        )
    if cfg.series_every:
        raise ValueError(
            "schedule_pods_sweep cannot emit the in-scan series (the "
            "vmapped replay has no per-config sampling surface)"
        )
    w = np.asarray(weights, np.int32)
    if w.ndim != 2 or w.shape[1] != len(cfg.policies):
        raise ValueError(
            f"weights must be a [B, {len(cfg.policies)}] matrix (one row "
            f"per config, columns in cfg.policies order); got shape "
            f"{w.shape}"
        )
    b = int(w.shape[0])
    if b < 1:
        raise ValueError("weights needs at least one config row")
    if seeds is None:
        seeds = [cfg.seed] * b
    seeds = [int(s) for s in seeds]
    if len(seeds) != b:
        raise ValueError(
            f"seeds has {len(seeds)} entries for {b} weight rows"
        )
    return w, b, seeds


def _lane_summary(state: NodeState, placed_node, ever_failed, amounts):
    """(placed, failed, gpu_alloc_pct, frag_gpu_milli, unscheduled) of a
    lane's final arrays on the host, in the reference's arithmetic (the
    frag total of the f32[7] amounts as numpy sums it)."""
    pn = np.asarray(placed_node, np.int32)
    failed = np.asarray(ever_failed, bool)
    gpu_left, gpu_cnt = state.gpu_left.numpy(), state.gpu_cnt.numpy()
    slot = np.arange(gpu_left.shape[1])[None, :] < gpu_cnt[:, None]
    denom = max(int(gpu_cnt.sum()) * MILLI, 1)
    alloc = 100.0 * float(np.where(slot, MILLI - gpu_left, 0).sum()) / denom
    amounts = np.asarray(amounts, np.float32)
    frag = amounts.sum(-1) - amounts[..., Q3_SATISFIED]
    return dict(placed=int((pn >= 0).sum()), failed=int(failed.sum()),
                gpu_alloc_pct=alloc, frag_gpu_milli=float(frag),
                unscheduled=int(((pn < 0) & failed).sum()))


def _slice_sweep_lane(outs, amounts, i, wrow, seed, p, e) -> SweepLane:
    """Lane i of a sweep's results on the host (`outs`, a ReplayResult a
    lane) as its SweepLane; `amounts` are the lanes' frag amounts f32[B, 7]
    and p, e the lane's true pod and event counts."""
    out = outs[i]
    pn = out.placed_node.numpy()[:p]
    failed = out.ever_failed.numpy()[:p]
    return SweepLane(
        weights=np.asarray(wrow, np.int32).copy(), seed=int(seed),
        placed_node=pn, dev_mask=out.dev_mask.numpy()[:p],
        ever_failed=failed, counters=None,
        metrics=(None if out.metrics is None else
                 type(out.metrics)(*(a[:e] for a in out.metrics))),
        state=out.state, events=e,
        **_lane_summary(out.state, pn, failed, amounts[i]))


def lane_from_arrays(state, placed_node, dev_mask, ever_failed, counters,
                     typical, weights, seed, events,
                     pad_skips: int = 0) -> SweepLane:
    """SweepLane from a run's final arrays on the host: the summary of
    _slice_sweep_lane (the same allocation slots, the same frag total), so
    a standalone run and a sweep lane compare field by field. `counters`
    and `pad_skips` are tpusim's in-scan counters and their padding
    correction; the port has no counters yet and keeps them as given."""
    state = NodeState(*(torch.as_tensor(np.asarray(a)) for a in state))
    typical = type(typical)(*(a.cpu() for a in typical))
    amounts = cluster_frag_report(state, typical)[0]
    pn = np.asarray(placed_node, np.int32)
    failed = np.asarray(ever_failed, bool)
    return SweepLane(
        weights=np.asarray(weights, np.int32).copy(), seed=int(seed),
        placed_node=pn, dev_mask=np.asarray(dev_mask), ever_failed=failed,
        counters=counters, metrics=None, state=state, events=int(events),
        **_lane_summary(state, pn, failed, amounts))


def lane_from_run(sim: Simulator, weights, seed,
                  pad_skips: int = 0) -> SweepLane:
    """SweepLane view of the Simulator's newest standalone run
    (schedule_pods)."""
    res = sim.last_result
    return lane_from_arrays(res.state, res.placed_node, res.dev_mask,
                            sim.last_ever_failed, None, sim.typical, weights,
                            seed, int(res.events), pad_skips)


def _sweep_lanes(sim: Simulator, lane_inputs, types, type_ids, w, seeds,
                 what: str) -> List[SweepLane]:
    """The lanes of a sweep: lane i replays lane_inputs[i] (specs, ev_kind,
    ev_pod) with type ids type_ids[i] into `types`, weight row w[i] (in
    cfg.policies order) and seed seeds[i] (its tie-break rank and root
    key). One launch, the post-pass where per-event reporting is on, the
    lanes' frag amounts in one device sum, one fetch."""
    cfg = sim._replay.config
    n = len(sim.nodes)
    lanes = [Lane(specs, tid, evk, evp,
                  torch.as_tensor(tiebreak_rank(n, seed), device=sim.device),
                  lane_weights(cfg, row), prng_key(seed))
             for (specs, evk, evp), tid, row, seed
             in zip(lane_inputs, type_ids, w, seeds)]
    ran = _launch_lanes(sim, types, lanes)
    b, e_max = len(lanes), max(int(evk.shape[0]) for _, evk, _ in lane_inputs)
    sim.log.info(
        f"[Engine] sweep of {b} {what} x {'<= ' if what == 'traces' else ''}"
        f"{e_max} events ran on: {_ran_on(sim, ran['kernel'], ran['tier'])}")
    results = ran["results"]
    if sim.cfg.report_per_event:
        results = _lane_metrics(sim, results, lane_inputs)
    amounts = _lane_frag_amounts([o.state for o in results], sim.typical)
    outs = device_fetch(tuple(results))
    return [_slice_sweep_lane(outs, amounts, i, w[i], seeds[i],
                              int(lane_inputs[i][0].cpu.shape[0]),
                              int(lane_inputs[i][1].shape[0]))
            for i in range(b)]


def schedule_pods_sweep(sim: Simulator, pods, weights, seeds=None,
                        bucket: int = 512) -> List[SweepLane]:
    """Evaluate B what-if configurations of one workload in one lanes
    launch: `weights` is a [B, num_pol] i32 matrix (a row a configuration,
    columns in cfg.policies order), `seeds` an optional list of B seeds
    (cfg.seed for every lane by default; a lane's seed drives its root key
    and its tie-break rank, as a standalone run's cfg.seed does). Each
    lane's placements, masks, state and metrics are bit-identical to a
    standalone run with that weight row in the configuration; the tables
    are built once for every lane."""
    cfg = sim.cfg
    w, b, seeds = _check_sweep_grid(cfg, weights, seeds)
    if sim.typical is None:
        sim.set_typical_pods()
    inputs = _lane_tensors(sim, pods, cfg.use_timestamps)
    types = build_pod_types(inputs[0])
    return _sweep_lanes(sim, [inputs] * b, types, [types.type_id] * b, w,
                        seeds, "configs")


def _union_types(specs_list):
    """The pod types of several lanes' specs together (the concat dedup of
    tpusim's seed batch), and each lane's type ids into them."""
    cat = PodSpec(*(torch.cat([getattr(s, f) for s in specs_list])
                    for f in PodSpec._fields))
    types = build_pod_types(cat)
    offs = np.cumsum([0] + [int(s.cpu.shape[0]) for s in specs_list])
    tids = [types.type_id[offs[i]:offs[i + 1]]
            for i in range(len(specs_list))]
    return types, tids


def schedule_pods_sweep_multi(sim: Simulator, pods_list, weights, seeds=None,
                              bucket: int = 512, min_pods: int = 0,
                              min_events: int = 0,
                              fault_specs=None) -> List[SweepLane]:
    """Evaluate B what-if configurations that each carry their own
    workload (tuned variants of one cluster's trace) in one lanes launch:
    lane i replays pods_list[i] under weight row i and seed i. The lanes
    share the Simulator's cluster, policy family and typical pods; the pod
    types are the union over the lanes, and the tables are built once.
    Each lane is bit-identical to a standalone run over its trace with its
    weights and seed. `min_pods`/`min_events` are tpusim's shape floors
    and pad nothing here. `fault_specs` (the chaos x tune sweep): a fault
    spec a lane (resolve_fault_spec), or None for a fault-free lane, each
    compiled against its lane's own trace; the lanes then run on the
    lanes fault forms, each equal to a standalone run_with_faults lane run
    over its trace (_dispatch_sweep_multi_faults)."""
    cfg = sim.cfg
    w, b, seeds = _check_sweep_grid(cfg, weights, seeds)
    if len(pods_list) != b:
        raise ValueError(
            f"pods_list has {len(pods_list)} traces for {b} weight rows "
            "(want one workload per config lane)"
        )
    if fault_specs is not None:
        if len(fault_specs) != b:
            raise ValueError(
                f"fault_specs has {len(fault_specs)} entries for {b} "
                "weight rows (want one fault schedule — or None — per "
                "lane)"
            )
        if cfg.use_timestamps:
            raise ValueError(
                "the chaos sweep replays creation-ordered traces "
                "(use_timestamps=False)"
            )
    if sim.typical is None:
        sim.set_typical_pods()
    inputs = [_lane_tensors(sim, pods, cfg.use_timestamps)
              for pods in pods_list]
    types, tids = _union_types([specs for specs, _, _ in inputs])
    if fault_specs is not None:
        return _dispatch_sweep_multi_faults(sim, fault_specs, inputs, types,
                                            tids, w, seeds, bucket)
    return _sweep_lanes(sim, inputs, types, tids, w, seeds, "traces")


def resolve_fault_spec(spec, num_nodes: int, num_events: int):
    """One chaos-sweep lane's spec as (FaultConfig, [FaultEvent]): a bare
    FaultConfig generates its seeded schedule; a (FaultConfig, events)
    tuple carries an explicit schedule, the config giving the retry and
    backoff knobs."""
    if isinstance(spec, tuple) and len(spec) == 2:
        fcfg, events = spec
        return fcfg, list(events)
    if isinstance(spec, FaultConfig):
        return spec, generate_fault_schedule(num_nodes, num_events, spec)
    raise ValueError(
        "each fault lane must be a FaultConfig (seeded MTBF schedule) or "
        f"a (FaultConfig, [FaultEvent]) tuple, got {type(spec).__name__}"
    )


def _chaos_plans(sim: Simulator, resolved, lane_events, lane_pods, bucket,
                 cache_key):
    """The lanes' fault plans of a chaos sweep, each compiled against its
    lane's base stream with one queue capacity: the lanes' largest, and no
    smaller than the Simulator's sticky floors (`sim._chaos_hw`, tpusim's:
    merged-stream length, draw rows, capacity, recover capture, which only
    grow). Identical lanes share one compile. Returns (plans, the padded
    merged-stream length the floors record)."""
    hw_em, hw_rows, hw_cap, hw_rec = getattr(sim, "_chaos_hw",
                                             (0, 0, 0, False))
    capacity = max(max(fault_lane.resolve_capacity(fcfg, p)
                       for (fcfg, _), p in zip(resolved, lane_pods)), hw_cap)
    cache, plans = {}, []
    for i, ((fcfg, events), (kinds, pods)) in enumerate(zip(resolved,
                                                            lane_events)):
        key = cache_key(i, fcfg, events)
        plan = cache.get(key)
        if plan is None:
            plan = cache[key] = fault_lane.compile_fault_plan(
                kinds, pods, events, fcfg, len(sim.nodes), lane_pods[i],
                capacity=capacity)
        plans.append(plan)
    kinds, _, _, _, _, draws, _, capacity, has_rec = \
        fault_lane.pad_fault_plans(plans, bucket=bucket, min_stream=hw_em,
                                   min_rows=hw_rows)
    e_m = int(kinds.shape[1])
    sim._chaos_hw = (e_m, int(draws.shape[1]), capacity,
                     bool(has_rec or hw_rec))
    return plans, e_m


def _fault_sweep_lanes(sim: Simulator, lane_inputs, types, type_ids, w,
                       seeds, plans):
    """One launch of the lanes fault forms: lane i replays plans[i]'s
    merged stream over lane_inputs[i]'s pods (type ids type_ids[i]) with
    weight row w[i] and seed seeds[i] (its tie-break rank and root key).
    init_tables runs once; residency.replay_tier picks
    `replay_lanes_faults` or `replay_blocked_lanes_faults` (over the nodes
    padded to whole blocks). Returns the lanes' (ReplayResult, FaultOut) on
    the host, the state and the down clock over the cluster's nodes, and
    the lanes' frag amounts f32[B, 7]."""
    cfg = sim._replay.config
    state, tp = sim.init_state, sim.typical
    n = state.num_nodes
    if sim.cfg.engine == "sequential":
        return _oracle_fault_lanes(sim, lane_inputs, w, seeds, plans)
    tier = sim._residency(n, types.num_types)
    target = state
    if tier == "hbm":
        target, _ = pad_nodes(state, sim.rank, BLOCK)
    lanes = []
    for (specs, _, _), tid, row, seed, plan in zip(lane_inputs, type_ids, w,
                                                   seeds, plans):
        if plan.kind.shape[0] and not specs.cpu.shape[0]:
            raise ValueError("the fault lane replays a workload of at least "
                             "one pod")
        rank = torch.as_tensor(tiebreak_rank(n, seed), device=sim.device)
        lanes.append(Lane(
            specs, tid, torch.as_tensor(plan.kind, device=sim.device),
            torch.as_tensor(plan.idx, device=sim.device),
            pad_rank(rank, BLOCK) if tier == "hbm" else rank,
            lane_weights(cfg, row), prng_key(seed),
            fault_lane.lane_of(plan, target, int(specs.cpu.shape[0]))))
    tables = init_tables(target, types, tp, cfg)
    if tier == "hbm":
        outs = [(o._replace(state=trim_nodes(o.state, n)), f)
                for o, _, f in replay_blocked_lanes_faults(
                    target, types, tp, tables, cfg, lanes)]
        kernel = "replay_blocked_lanes_faults"
    else:
        outs = replay_lanes_faults(state, types, tp, tables, cfg, lanes)
        kernel = "replay_lanes_faults"
    outs = [(o, f._replace(carry=f.carry._replace(down_at=f.carry.down_at[:n])))
            for o, f in outs]
    if sim.device.type != "cuda":
        kernel = f"plain_{kernel}"
    sim.last_engine, sim.last_residency = kernel, tier
    sim.last_kernel_stats = None
    amounts = _lane_frag_amounts([o.state for o, _ in outs], tp)
    return device_fetch(tuple(outs)), amounts


def _oracle_fault_lanes(sim: Simulator, lane_inputs, w, seeds, plans):
    """_fault_sweep_lanes under engine="sequential": each lane's plan
    through the oracle's fault form in turn, as a standalone lane run with
    its weight row, rank and key (the recover frag captured where any lane
    recovers a node, as tpusim's chaos sweep arms it)."""
    state, tp = sim.init_state, sim.typical
    n = state.num_nodes
    replay = sim._sequential_replay(True, any(p.has_recover for p in plans))
    outs = []
    for (specs, _, _), row, seed, plan in zip(lane_inputs, w, seeds, plans):
        p = int(specs.cpu.shape[0])
        if plan.kind.shape[0] and not p:
            raise ValueError("the fault lane replays a workload of at least "
                             "one pod")
        lane = fault_lane.lane_of(plan, state, p)
        outs.append(replay(
            state, specs, plan.kind, plan.idx, tp, prng_key(seed),
            torch.as_tensor(tiebreak_rank(n, seed), device=sim.device),
            weights=row, fault_ops=lane.ops, fault_carry0=lane.carry))
    sim._host_loop("sequential")
    amounts = _lane_frag_amounts([o.state for o, _ in outs], tp)
    return device_fetch(tuple(outs)), amounts


def _chaos_lane(outs, amounts, i, wrow, seed, plan, gpu_cnt) -> SweepLane:
    """Lane i of a chaos sweep on the host as its SweepLane, with its
    DisruptionMetrics; its events count the retries that ran, and its
    unscheduled pods the dead ones."""
    out, fout = outs[i]
    dm, dead, attempts_run = fault_lane.assemble_disruption(
        plan, fout.ys, fout.carry, gpu_cnt)
    p = int(out.placed_node.shape[0])
    lane = _slice_sweep_lane([out], amounts[i:i + 1], 0, wrow, seed, p,
                             plan.num_events)
    lane.disruption = dm
    lane.events = plan.num_events + attempts_run
    lane.unscheduled = int(((lane.placed_node < 0)
                            & (lane.ever_failed | dead[:p])).sum())
    return lane


def _dispatch_sweep_multi_faults(sim: Simulator, fault_specs, inputs, types,
                                 tids, w, seeds, bucket: int):
    """The fault half of schedule_pods_sweep_multi (driver.py:4373-4534 of
    the reference): each lane's plan compiled against its own trace (a
    fault-free lane under an empty schedule, an exact no-op on the lane),
    with the chaos sweep's sticky floors; then one launch of the lanes
    fault forms."""
    ev_list = [(evk.cpu().numpy(), evp.cpu().numpy())
               for _, evk, evp in inputs]
    lane_pods = [int(specs.cpu.shape[0]) for specs, _, _ in inputs]
    resolved = [(FaultConfig(), []) if spec is None else
                resolve_fault_spec(spec, len(sim.nodes), len(kinds))
                for spec, (kinds, _) in zip(fault_specs, ev_list)]
    plans, e_m = _chaos_plans(
        sim, resolved, ev_list, lane_pods, bucket,
        lambda i, fcfg, events: (repr(fcfg), tuple(events),
                                 len(ev_list[i][0])))
    outs, amounts = _fault_sweep_lanes(sim, inputs, types, tids, w, seeds,
                                       plans)
    sim.log.info(
        f"[Engine] chaos x trace sweep of {len(plans)} lanes (merged stream "
        f"{e_m}) ran on: "
        f"{_ran_on(sim, sim.last_engine, sim.last_residency)}")
    gcnt = sim.init_state.gpu_cnt.cpu().numpy()
    return [_chaos_lane(outs, amounts, i, w[i], seeds[i], plans[i], gcnt)
            for i in range(len(plans))]


def schedule_pods_sweep_faults(sim: Simulator, pods, weights, fault_specs,
                               seeds=None, bucket: int = 512
                               ) -> List[SweepLane]:
    """Evaluate B fault what-ifs of one workload in one launch (the chaos
    sweep, driver.py:4583-4772 of the reference): lane i replays the
    shared trace under weight row i, seed i and fault spec i
    (resolve_fault_spec), its own merged stream, draw table and retry
    queue, as a block of `replay_lanes_faults` (or
    `replay_blocked_lanes_faults`). The queue capacity is the lanes'
    largest, with the sticky floors of _chaos_plans. Each SweepLane
    carries its DisruptionMetrics and equals the standalone
    run_with_faults lane run with that schedule."""
    cfg = sim.cfg
    if cfg.use_timestamps:
        raise ValueError(
            "the chaos sweep replays creation-ordered traces "
            "(use_timestamps=False)"
        )
    w, b, seeds = _check_sweep_grid(cfg, weights, seeds)
    if len(fault_specs) != b:
        raise ValueError(
            f"fault_specs has {len(fault_specs)} entries for {b} weight "
            "rows (want one fault schedule per lane)"
        )
    if sim.typical is None:
        sim.set_typical_pods()
    inputs = _lane_tensors(sim, pods, False)
    ev = tuple(x.cpu().numpy() for x in inputs[1:])
    p, e = int(inputs[0].cpu.shape[0]), int(ev[0].shape[0])
    resolved = [resolve_fault_spec(spec, len(sim.nodes), e)
                for spec in fault_specs]
    plans, e_m = _chaos_plans(sim, resolved, [ev] * b, [p] * b, bucket,
                              lambda i, fcfg, events: (repr(fcfg),
                                                       tuple(events)))
    types = build_pod_types(inputs[0])
    outs, amounts = _fault_sweep_lanes(sim, [inputs] * b, types,
                                       [types.type_id] * b, w, seeds, plans)
    sim.log.info(
        f"[Engine] chaos sweep of {b} fault lanes x {e} events (merged "
        f"stream {e_m}) ran on: "
        f"{_ran_on(sim, sim.last_engine, sim.last_residency)}")
    gcnt = sim.init_state.gpu_cnt.cpu().numpy()
    return [_chaos_lane(outs, amounts, i, w[i], seeds[i], plans[i], gcnt)
            for i in range(b)]


def format_chaos_table(lanes: Sequence[SweepLane], policies) -> str:
    """Per-lane disruption frontier of a chaos sweep (the `apply
    --sweep-faults` output): placements and the DisruptionMetrics
    headline numbers a fault schedule."""
    names = [n for n, _ in policies]
    head = (
        f"{'lane':>4} {'weights(' + ','.join(names) + ')':<28} "
        f"{'seed':>6} {'placed':>7} {'evicted':>8} {'resched':>8} "
        f"{'dead':>5} {'fails':>6} {'lat_mean':>9} {'gpu_alloc%':>10} "
        f"{'frag_gpu_milli':>15}"
    )
    rows = [head, "-" * len(head)]
    for i, ln in enumerate(lanes):
        dm = ln.disruption
        wstr = ",".join(str(int(x)) for x in ln.weights)
        rows.append(
            f"{i:>4} {wstr:<28} {ln.seed:>6} {ln.placed:>7} "
            f"{dm.evicted_pods:>8} {dm.rescheduled_pods:>8} "
            f"{dm.unscheduled_after_retries:>5} {dm.node_failures:>6} "
            f"{dm.mean_reschedule_latency():>9.2f} "
            f"{ln.gpu_alloc_pct:>10.2f} {ln.frag_gpu_milli:>15.0f}"
        )
    return "\n".join(rows)


def format_sweep_table(lanes: Sequence[SweepLane], policies) -> str:
    """Per-config summary table of a sweep (the `apply --sweep-weights`
    output): a row a lane with its weight row, seed, placed and failed
    counts, GPU allocation and frag gpu-milli."""
    names = [n for n, _ in policies]
    head = (
        f"{'cfg':>4} {'weights(' + ','.join(names) + ')':<32} "
        f"{'seed':>6} {'placed':>7} {'failed':>7} "
        f"{'gpu_alloc%':>10} {'frag_gpu_milli':>15}"
    )
    rows = [head, "-" * len(head)]
    for i, ln in enumerate(lanes):
        wstr = ",".join(str(int(x)) for x in ln.weights)
        rows.append(
            f"{i:>4} {wstr:<32} {ln.seed:>6} {ln.placed:>7} "
            f"{ln.failed:>7} {ln.gpu_alloc_pct:>10.2f} "
            f"{ln.frag_gpu_milli:>15.0f}"
        )
    return "\n".join(rows)


# the settings every Simulator of a seed batch must share
_BATCH_SHARED = ("policies", "gpu_sel_method", "dim_ext_method",
                 "norm_method", "report_per_event", "use_timestamps",
                 "table_residency", "typical_pods", "engine", "block_size")


def schedule_pods_batch(sims: Sequence[Simulator], pods_list,
                        bucket: int = 512) -> List[SimulateResult]:
    """The main schedule of S same-config experiments that differ in their
    seeds (shuffle order, tuning, tie-break rank, root key) as one lanes
    launch. Each Simulator's result, log and CSVs equal its standalone
    schedule_pods."""
    return finish_pods_batch(dispatch_pods_batch(sims, pods_list, bucket))


def dispatch_pods_batch(sims: Sequence[Simulator], pods_list,
                        bucket: int = 512) -> dict:
    """The host preparation and the launch of schedule_pods_batch. The
    launch is asynchronous on the device's stream, so this returns once it
    is queued, and the caller may do host work (another group's tail)
    while the lanes run; finish_pods_batch(handle) waits for them and
    completes each Simulator's run."""
    lead = sims[0]
    if lead.cfg.extenders:
        raise ValueError(
            "schedule_pods_batch cannot run extender configs (per-cycle "
            "HTTP round-trips do not batch); run each sim's run() instead"
        )
    if any(s.cfg.record_decisions for s in sims):
        # any recording sim, not just the lead: the batch runs the lead's
        # configuration, so a recorder elsewhere would get no stream
        raise ValueError(
            "schedule_pods_batch cannot record decisions (the vmapped "
            "replay has no per-seed provenance surface); run each sim's "
            "run() instead"
        )
    if any(s.cfg.series_every for s in sims):
        raise ValueError(
            "schedule_pods_batch cannot emit the in-scan series (the "
            "vmapped replay has no per-seed sampling surface); run each "
            "sim's run() instead"
        )
    for s in sims[1:]:
        same = (all(getattr(s.cfg, f) == getattr(lead.cfg, f)
                    for f in _BATCH_SHARED)
                and s.nodes == lead.nodes
                and s.workload_pods == lead.workload_pods
                and s.device == lead.device)
        if not same:
            raise ValueError(
                "schedule_pods_batch requires same-config sims (policies, "
                "gpu/dim/norm methods, report flag, timestamps, table "
                "residency, typical-pod knobs, the node cluster, the "
                "workload and the device may not differ across the batch)"
            )
    t0 = time.perf_counter()
    for sim in sims:
        if sim.typical is None:
            sim.set_typical_pods()
    inputs = [_lane_tensors(sim, pods, sim.cfg.use_timestamps)
              for sim, pods in zip(sims, pods_list)]
    types, tids = _union_types([specs for specs, _, _ in inputs])
    cfg = lead._replay.config
    lanes = [Lane(specs, tid, evk, evp, sim.rank, cfg.fam_weights,
                  prng_key(sim.cfg.seed))
             for sim, (specs, evk, evp), tid in zip(sims, inputs, tids)]
    ran = _launch_lanes(lead, types, lanes)
    return dict(sims=sims, pods_list=pods_list, inputs=inputs, ran=ran,
                t0=t0, prep_s=time.perf_counter() - t0)


def finish_pods_batch(handle: dict) -> List[SimulateResult]:
    """Wait for a dispatch_pods_batch handle's lanes and finish each
    Simulator's run: the post-pass, one fetch, the log and the result."""
    sims, ran = handle["sims"], handle["ran"]
    lead = sims[0]
    t_fin = time.perf_counter()
    results = ran["results"]
    if lead.cfg.report_per_event:
        results = _lane_metrics(lead, results, handle["inputs"])
    outs = device_fetch(tuple(results))
    wall = handle["prep_s"] + (time.perf_counter() - t_fin)
    done = []
    for i, (sim, pods) in enumerate(zip(sims, handle["pods_list"])):
        evk, evp = (x.cpu().numpy() for x in handle["inputs"][i][1:])
        sim.last_engine, sim.last_residency = ran["kernel"], ran["tier"]
        sim.last_kernel_stats = None
        sim.log.info(
            f"[Engine] replay of {len(evk)} events ran on: "
            f"{_ran_on(sim, ran['kernel'], ran['tier'], f', lane {i} of {len(sims)}')}")
        t1 = time.perf_counter()
        out, events, unscheduled, rank = sim._finish_replay(
            outs[i], pods, evk, evp, sim.init_state)
        sim.replay_times.append(dict(
            events=events, replay_ms=wall * 1e3 / len(sims),
            report_ms=(time.perf_counter() - t1) * 1e3))
        done.append(sim._record_result(out, pods, events, unscheduled, rank,
                                       wall / len(sims)))
    return done


def _batched_frag_amounts(sims: Sequence[Simulator]) -> np.ndarray:
    """The cluster frag amounts f32[S, 7] of every Simulator's final state,
    summed for all of them at once on the lead's device in the order of
    cluster_frag_report."""
    lead = sims[0]
    states = [NodeState(*(a.to(lead.device) for a in s.last_result.state))
              for s in sims]
    return _lane_frag_amounts(states, lead.typical)


def run_batch(sims: Sequence[Simulator]) -> List[SimulateResult]:
    """run() for a seed batch: each Simulator's preparation and reports,
    one lanes launch for their replays (schedule_pods_batch)."""
    return finish_run_batch(dispatch_run_batch(sims))


def dispatch_run_batch(sims: Sequence[Simulator]) -> dict:
    """The preparation and the launch of run_batch (dispatch_pods_batch).
    The typical-pod distribution is computed once, on the lead, and taken
    by the Simulators with the same workload and settings."""
    pods_list = []
    lead = sims[0]
    for sim in sims:
        sim._reset_run_state()
        if (sim is lead or sim.workload_pods != lead.workload_pods
                or sim.cfg.typical_pods != lead.cfg.typical_pods):
            sim.set_typical_pods()
        else:
            sim.adopt_typical_pods(lead)
        pods_list.append(sim.prepare_pods())
        sim.log.info(
            f"Number of original workload pods: {len(sim.workload_pods)}"
        )
    return dispatch_pods_batch(sims, pods_list)


def finish_run_batch(handle: dict) -> List[SimulateResult]:
    """The finish half of run_batch: each run's failed-pods block and its
    Cluster Analysis, the frag amounts of all final states summed at
    once."""
    sims = handle["sims"]
    results = finish_pods_batch(handle)
    amounts = _batched_frag_amounts(sims)
    for i, (sim, res) in enumerate(zip(sims, results)):
        sim.report_failed([u.pod for u in res.unscheduled_pods])
        sim.cluster_analysis("InitSchedule", _amounts=amounts[i])
    return results
