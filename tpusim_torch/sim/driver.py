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
OutOfMemoryError) before launch, a failed launch raises.

After the main replay, `schedule_additional` replays more pods from the
placed cluster's state (apps, the new-workload swap, the inflation
evaluation), through the same kernels and the same report tail.

With `report_per_event` on (the default, as in the reference), every replay
is followed by the metrics post-pass (tpusim_torch.sim.metrics) on the
replay's device, one transfer of the result to the host
(tpusim_torch.sim.fetch), the Bellman series of the host's C++ evaluator
(tpusim_torch.native) and the per-event log block; the analysis CSVs are
written from what that block stashes (tpusim_torch.analysis).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tpusim_torch.constants import MILLI
from tpusim_torch.io.trace import (
    NodeRow,
    PodRow,
    build_events,
    nodes_to_state,
    pods_to_specs,
    tiebreak_rank,
)
from tpusim_torch.io.export import (
    export_node_snapshot_csv,
    export_pod_snapshot_csv,
    export_pod_snapshot_yaml,
)
from tpusim_torch.ops.frag import cluster_frag_report
from tpusim_torch.sim import residency
from tpusim_torch.sim.engine import EV_CREATE, EV_DELETE, ReplayResult
from tpusim_torch.sim.fetch import device_fetch
from tpusim_torch.sim.fused_engine import make_fused_replay
from tpusim_torch.sim.hbm_engine import make_blocked_replay
from tpusim_torch.sim.metrics import compute_event_metrics
from tpusim_torch.sim.queues import app_queue
from tpusim_torch.sim.reports import (
    LogSink,
    batch_event_report_msgs,
    cluster_analysis_block,
    event_report_series,
    report_failed_pods,
)
from tpusim_torch.sim.table_engine import build_pod_types
from tpusim_torch.sim.typical import (
    TypicalPodsConfig,
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
    gpu_sel_method: str = "best"  # best | worst | <self-select policy>
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
    seed: int = 42  # node tie-break permutation
    # the per-event report block (attempt, [Report], [Alloc], [AllocCPU],
    # [Power] lines) and the per-event analysis CSVs
    report_per_event: bool = True
    # replay creations and deletions in timestamp order (build_events)
    use_timestamps: bool = False
    # where the replay's tables live: "vmem" = the flat `replay` kernel,
    # "hbm" = `replay_blocked`, "auto" = "vmem" while the tables fit the
    # card's L2 cache (always on the CPU); tpusim_torch.sim.residency
    table_residency: str = "auto"


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


class Simulator:
    """Drives one cluster and workload through the fused replay.

    device: "cuda" (the default) runs the CUDA kernels and raises if no GPU
    is visible; "cpu" runs the plain PyTorch replay.

    After each replay, `last_engine` names the kernel that ran ("replay" or
    "replay_blocked", prefixed "plain_" on the CPU), `last_residency` its
    tier ("vmem" or "hbm") and `last_kernel_stats` the blocked replay's
    [waits, starts, rebuilds] (None after the flat one).
    """

    def __init__(self, nodes: Sequence[NodeRow], cfg: SimulatorConfig = None,
                 device="cuda"):
        self.cfg = cfg or SimulatorConfig()
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
        # raises NotImplementedError for configs the kernel does not cover
        self._replay = make_fused_replay(
            self.cfg.policies, self.cfg.gpu_sel_method, self.device,
            self.cfg.dim_ext_method, self.cfg.norm_method,
        )
        self._blocked = None  # the blocked replayer, built on first use
        self.engine = ("fused cuda kernel" if self.device.type == "cuda"
                       else "plain pytorch (cpu)")
        self.last_engine = None
        self.last_residency = None
        self.last_kernel_stats = None
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
        self._bellman_eval = None
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

    # ---- workload prep (core.go:103-142) ----

    def set_workload_pods(self, pods: Sequence[PodRow]):
        self.workload_pods = list(pods)

    def set_typical_pods(self):
        typical, info = get_typical_pods(
            self.workload_pods, self.cfg.typical_pods, self.device
        )
        # zero-frequency padding rows add nothing to any frag sum
        self.typical = pad_typical_pods(typical)
        # the Bellman memo lives for one experiment, as the reference's
        # fragMemo does (simulator.go:58)
        self._bellman_eval = None
        self.log.info(f"Num of Total Pods: {len(self.workload_pods)}")
        self.log.info(f"Num of Total Pod Sepc: {len(info)}")

    def prepare_pods(self) -> List[PodRow]:
        """SortClusterPods, then tuning (core.go:131-142): one generator
        seeded by tuning_seed drives the shuffle and then the clone draws."""
        rng = np.random.default_rng(self.cfg.tuning_seed)
        pods = sort_cluster_pods(
            list(self.workload_pods), self.cfg.shuffle_pod, rng
        )
        if self.cfg.tuning_ratio > 0:
            pods = tune_pods(pods, self.node_total_milli_gpu,
                             self.cfg.tuning_ratio, rng)
        return pods

    # ---- the run (core.go:148 RunCluster -> SchedulePods) ----

    def _residency(self, num_nodes: int, num_types: int) -> str:
        """The tier a replay of this shape runs in: the configured one, or
        under "auto" "vmem" while the tables fit the card's L2 cache ("vmem"
        on the CPU)."""
        if self.cfg.table_residency != "auto":
            return self.cfg.table_residency
        if self.device.type != "cuda":
            return "vmem"
        l2 = torch.cuda.get_device_properties(self.device).L2_cache_size
        return residency.select_residency(num_nodes, num_types,
                                          len(self.cfg.policies), l2)

    def run_events(self, state: NodeState, specs: PodSpec, ev_kind,
                   ev_pod, types=None) -> ReplayResult:
        """Replay an event stream from `state`: the CUDA kernels on a CUDA
        device, the plain replay on the CPU. Callers replaying the same pod
        specs repeatedly (a chunked stream) may pass their
        `build_pod_types(specs)` as `types`."""
        ev_kind = np.asarray(ev_kind, np.int32)
        ev_pod = np.asarray(ev_pod, np.int32)
        if types is None:
            types = build_pod_types(specs)
        n, k = state.num_nodes, types.num_types
        tier = self._residency(n, k)
        args = (state, specs, types, torch.as_tensor(ev_kind),
                torch.as_tensor(ev_pod), self.typical, None, self.rank)
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

    def _attach_metrics(self, out: ReplayResult, state: NodeState, specs,
                        ev_kind, ev_pod) -> ReplayResult:
        """The metrics post-pass on the replay's device when per-event
        reporting is on (compute_event_metrics, from the telemetry)."""
        if not self.cfg.report_per_event:
            return out
        dev = out.event_node.device
        return out._replace(metrics=compute_event_metrics(
            state, specs, torch.as_tensor(ev_kind, device=dev),
            torch.as_tensor(ev_pod, device=dev), out.event_node,
            out.event_dev, self.typical))

    def _replay_pods(self, state: NodeState, pods: Sequence[PodRow],
                     use_timestamps: bool):
        """Replay `pods` from `state`: the kernels, the metrics post-pass,
        one fetch and the host tail (_finish_replay). Returns (the replay's
        result on the host, events, unscheduled pods, creation ranks)."""
        t0 = time.perf_counter()
        specs = pods_to_specs(pods, self.node_index, self.device)
        ev_kind, ev_pod = build_events(pods, use_timestamps)
        out = self.run_events(state, specs, ev_kind, ev_pod)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        out = self._attach_metrics(out, state, specs, ev_kind, ev_pod)
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
        each pod's creation rank. `out` is on the host."""
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
            self.init_state, pods, self.cfg.use_timestamps)
        self.last_result = SimulateResult(
            unscheduled_pods=unscheduled,
            placed_node=out.placed_node.numpy(),
            dev_mask=out.dev_mask.numpy(),
            state=out.state,
            pods=list(pods),
            node_names=self.node_names,
            wall_seconds=time.perf_counter() - t0,
            events=events,
            creation_rank=rank,
        )
        return self.last_result

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
            self._placed_state(), pods, use_timestamps=False)
        res.state = out.state
        res.pods = list(res.pods) + list(pods)
        res.placed_node = np.concatenate([res.placed_node,
                                          out.placed_node.numpy()])
        res.dev_mask = np.concatenate([res.dev_mask, out.dev_mask.numpy()])
        res.unscheduled_pods = list(res.unscheduled_pods) + failed
        res.events += events
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
        pods = self.prepare_pods()
        self.log.info(
            f"Number of original workload pods: {len(self.workload_pods)}"
        )
        res = self.schedule_pods(pods)
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
            self._placed_state(), extra, use_timestamps=False)
        self.report_failed([u.pod for u in unscheduled])
        self.log.info(f"[ReportFailedPods] {len(unscheduled)} unscheduled "
                      "inflation pods")
        saved = self.last_result.state
        self.last_result.state = out.state
        analysis = self.cluster_analysis(tag)
        self.last_result.state = saved
        return analysis

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
        node after every event."""
        from tpusim_torch.native import BellmanEvaluator

        kinds = np.asarray(ev_kind)
        ev_pods = np.asarray(ev_pod)
        pod_cpu = np.fromiter((p.cpu_milli for p in pods), np.int32,
                              count=len(pods))
        pod_gpu = np.fromiter((p.gpu_milli for p in pods), np.int32,
                              count=len(pods))
        s = device_fetch(start_state)
        if self._bellman_eval is None:
            self._bellman_eval = BellmanEvaluator(self._typical_host_rows())
        return self._bellman_eval.eval_series(
            s.cpu_left.numpy(), s.gpu_left.numpy(), s.gpu_type.numpy(),
            out.event_node.numpy(), out.event_dev.numpy(),
            np.where(kinds == EV_CREATE, 1, -1).astype(np.int8),
            pod_cpu[ev_pods], pod_gpu[ev_pods])

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
        bellman = self._bellman_series(start_state, pods, ev_kind, ev_pod,
                                       out)
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

    def cluster_analysis(self, tag: str = "InitSchedule"):
        """The end-of-stage 16-line analysis block. The frag amounts are
        summed on the host in a fixed order, whatever the device."""
        state = (self.last_result.state if self.last_result is not None
                 else self.init_state)
        state = NodeState(*(a.cpu() for a in state))
        typical = type(self.typical)(*(a.cpu() for a in self.typical))
        amounts = cluster_frag_report(state, typical)[0]
        requested, allocatable = self.alloc_maps(state)
        kv = cluster_analysis_block(self.log, tag, amounts, requested,
                                    allocatable)
        # the summary across stages, in emission order, for analysis.csv
        self.analysis_summary.update(kv)
        return amounts, requested, allocatable
