"""analysis.py-compatible log emission (counterpart of
tpusim/sim/reports.py): the per-event report block, the failed pods and
the Cluster Analysis block.

Formats reproduce pkg/simulator/analysis.go and pkg/utils/alloc.go: each
line is a logrus text-format info line with a literal ``\\n`` before the
closing quote, as logrus renders embedded newlines.
"""

from __future__ import annotations

import re
from typing import IO, Dict, List, Optional, Sequence

import numpy as np

from tpusim_torch.constants import FRAG_CLASS_NAMES, Q3_SATISFIED

_ALLOC_KEYS = ("MilliCpu", "Memory", "Gpu", "MilliGpu")


class LogSink:
    """Collects logrus-text-format info lines (`level=info msg="..."`)."""

    def __init__(self, stream: Optional[IO] = None):
        self.lines: List[str] = []
        self.stream = stream

    def _emit(self, line: str):
        self.lines.append(line)
        if self.stream is not None:
            self.stream.write(line + "\n")

    def info(self, msg: str):
        self._emit(f'time="2000-01-01T00:00:00Z" level=info msg="{msg}\\n"')

    def info_many(self, msgs: Sequence[str]):
        """Info lines for many preformatted messages, written at once."""
        if not len(msgs):
            return
        prefix = 'time="2000-01-01T00:00:00Z" level=info msg="'
        lines = [f'{prefix}{m}\\n"' for m in msgs]
        self.lines.extend(lines)
        if self.stream is not None:
            self.stream.write("\n".join(lines) + "\n")

    def infoln(self):
        self._emit('time="2000-01-01T00:00:00Z" level=info')

    def dump(self) -> str:
        return "\n".join(self.lines) + "\n"


def report_frag_line(log: LogSink, amounts: np.ndarray):
    """Per-event `[Report] ... (origin)` line (analysis.go:109)."""
    idle = float(amounts.sum())
    frag = idle - float(amounts[Q3_SATISFIED])
    q124 = float(amounts[0] + amounts[1] + amounts[3])
    fr = 100.0 * frag / idle if idle else 0.0
    qr = 100.0 * q124 / idle if idle else 0.0
    log.info(
        f"[Report]; Frag amount: {frag:.2f}; Frag ratio: {fr:.2f}%; "
        f"Q124 ratio: {qr:.2f}%; (origin)"
    )


def report_bellman_line(log: LogSink, bellman: float, idle: float):
    """`[Report] ... (bellman)` variant (analysis.go:110)."""
    r = 100.0 * bellman / idle if idle else 0.0
    log.info(f"[Report]; Frag amount: {bellman:.2f}; Frag ratio: {r:.2f}%; "
             "(bellman)")


def report_alloc_lines(log: LogSink, used_nodes: int, used_gpus: int,
                       used_gpu_milli: int, total_gpus: int,
                       arrived_gpu_milli: int, used_cpu_milli: int,
                       arrived_cpu_milli: int):
    """Per-event `[Alloc]`/`[AllocCPU]` lines (analysis.go:115-118)."""
    log.info(
        f"[Alloc]; Used nodes: {used_nodes}; Used GPUs: {used_gpus}; "
        f"Used GPU Milli: {used_gpu_milli}; Total GPUs: {total_gpus}; "
        f"Arrived GPU Milli: {arrived_gpu_milli}"
    )
    log.info(
        f"[AllocCPU]; Used CPU Milli: {used_cpu_milli}; "
        f"Arrived CPU Milli: {arrived_cpu_milli}"
    )


def report_power_line(log: LogSink, power_cpu: float, power_gpu: float):
    """`[Power]` line (analysis.go:54-55)."""
    log.info(
        f"[Power]; cluster: {power_cpu + power_gpu:.1f}; "
        f"ClusterCPU: {power_cpu:.1f}; ClusterGPU: {power_gpu:.1f}"
    )


def pod_resource_repr(cpu_milli: int, gpu_num: int, gpu_milli: int,
                      gpu_spec: str = "", cpu_spec: str = "") -> str:
    """PodResource.Repr (pkg/type/resource.go:104-127): an empty CPU type
    renders ANY; an empty GPU type ANY for GPU pods, NONE otherwise."""
    cputype = cpu_spec or "ANY"
    gputype = gpu_spec or ("ANY" if gpu_milli > 0 else "NONE")
    return (
        f"<CPU: {cpu_milli / 1000:6.2f}, GPU: {gpu_num}"
        f" x {{{gpu_milli:<4d}}}m (CPUREQ: {cputype}) (GPUREQ: {gputype})>"
    )


def report_failed_pods(log: LogSink, pods) -> None:
    """`Failed Pods in detail:` block (pkg/utils/utils.go:1344-1354)."""
    if not pods:
        return
    log.info("Failed Pods in detail:")
    for p in pods:
        log.info(f"  {p.name}: "
                 + pod_resource_repr(p.cpu_milli, p.num_gpu, p.gpu_milli,
                                     p.gpu_spec))
    log.infoln()


def event_report_series(
    amounts: np.ndarray,  # f32[E, 7]
    power_cpu: np.ndarray,
    power_gpu: np.ndarray,
    bellman: Optional[np.ndarray] = None,  # f64[E]
) -> Dict[str, np.ndarray]:
    """The per-event float series of the report block as formatted string
    arrays. The log lines (batch_event_report_msgs) and the analysis CSVs
    (tpusim_torch.analysis) both read these strings, so the two agree by
    construction. The sums and ratios round as the one-line emitters above
    do: the seven amounts summed in float32, the rest in float64."""

    def f2(a):
        return np.char.mod("%.2f", a)

    idle = amounts.sum(axis=1, dtype=np.float32).astype(np.float64)
    frag = idle - amounts[:, Q3_SATISFIED].astype(np.float64)
    q124 = (amounts[:, 0] + amounts[:, 1] + amounts[:, 3]).astype(np.float64)
    safe = np.where(idle != 0, idle, 1.0)
    fr = np.where(idle != 0, 100.0 * frag / safe, 0.0)
    qr = np.where(idle != 0, 100.0 * q124 / safe, 0.0)
    pc = power_cpu.astype(np.float64)
    pg = power_gpu.astype(np.float64)
    series = {
        "origin_milli": f2(frag),
        "origin_ratio": f2(fr),
        "origin_q124": f2(qr),
        "power_cluster": np.char.mod("%.1f", pc + pg),
        "power_cluster_CPU": np.char.mod("%.1f", pc),
        "power_cluster_GPU": np.char.mod("%.1f", pg),
    }
    if bellman is not None:
        br = np.where(idle != 0, 100.0 * bellman / safe, 0.0)
        series["bellman_milli"] = f2(bellman)
        series["bellman_ratio"] = f2(br)
    return series


def _cat(*parts):
    out = parts[0]
    for p in parts[1:]:
        out = np.char.add(out, p)
    return out


def batch_event_report_msgs(
    amounts: np.ndarray,  # f32[E, 7]
    total_gpus: int,
    used_nodes: np.ndarray,
    used_gpus: np.ndarray,
    used_gpu_milli: np.ndarray,
    arrived_gpu_milli: np.ndarray,
    used_cpu_milli: np.ndarray,
    arrived_cpu_milli: np.ndarray,
    power_cpu: np.ndarray,
    power_gpu: np.ndarray,
    bellman: Optional[np.ndarray] = None,  # f64[E]
    kinds: Optional[np.ndarray] = None,  # event kind per event
    ev_create: int = 0,
    ev_delete: int = 1,
    pod_names: Optional[np.ndarray] = None,  # str[E] the event's pod
    failed: Optional[np.ndarray] = None,  # bool[E] the create was rejected
    series: Optional[Dict[str, np.ndarray]] = None,  # event_report_series
) -> List[str]:
    """The whole per-event report block: each line family formatted as one
    numpy string operation over the events, then interleaved into event
    order (attempt, rollback, frag, bellman, alloc, alloccpu, power;
    simulator.go:410-427, analysis.go:109-118). Skip events (the
    pod-unscheduled annotation) emit nothing (simulator.go:391-399)."""
    e_count = amounts.shape[0]
    if e_count == 0:
        return []
    active = (np.ones(e_count, bool) if kinds is None
              else (kinds == ev_create) | (kinds == ev_delete))
    if series is None:
        series = event_report_series(amounts, power_cpu, power_gpu, bellman)

    rows = []  # (mask, msgs) in the order an event emits them
    if kinds is not None and pod_names is not None:
        verb = np.where(kinds == ev_create, "create", "delete")
        rows.append((active, _cat(
            "[", np.char.mod("%d", np.arange(e_count)), "] attempt to ",
            verb, " pod(", pod_names, ")")))
        if failed is not None:
            rows.append(((kinds == ev_create) & failed, _cat(
                "[deletePod] attempt to delete a non-scheduled pod(",
                pod_names, ")")))
    rows.append((active, _cat(
        "[Report]; Frag amount: ", series["origin_milli"],
        "; Frag ratio: ", series["origin_ratio"],
        "%; Q124 ratio: ", series["origin_q124"], "%; (origin)")))
    if "bellman_milli" in series:
        rows.append((active, _cat(
            "[Report]; Frag amount: ", series["bellman_milli"],
            "; Frag ratio: ", series["bellman_ratio"], "%; (bellman)")))

    def d(a):
        return np.char.mod("%d", a)

    rows.append((active, _cat(
        "[Alloc]; Used nodes: ", d(used_nodes),
        "; Used GPUs: ", d(used_gpus),
        "; Used GPU Milli: ", d(used_gpu_milli),
        "; Total GPUs: ", str(int(total_gpus)),
        "; Arrived GPU Milli: ", d(arrived_gpu_milli))))
    rows.append((active, _cat(
        "[AllocCPU]; Used CPU Milli: ", d(used_cpu_milli),
        "; Arrived CPU Milli: ", d(arrived_cpu_milli))))
    rows.append((active, _cat(
        "[Power]; cluster: ", series["power_cluster"],
        "; ClusterCPU: ", series["power_cluster_CPU"],
        "; ClusterGPU: ", series["power_cluster_GPU"])))

    # [families, E] -> event-major order
    mask = np.stack([m for m, _ in rows])
    grid = np.empty(mask.shape, dtype=object)
    for i, (_, msgs) in enumerate(rows):
        grid[i] = msgs
    return grid.T.ravel()[mask.T.ravel()].tolist()


def camel_to_snake(name: str) -> str:
    """scripts/analysis.py's key normalization."""
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z0-9])([A-Z])", r"\1_\2", name).lower()


def cluster_analysis_block(log: LogSink, tag: str, frag_amounts: np.ndarray,
                           alloc_requested: dict,
                           alloc_allocatable: dict) -> Dict[str, float]:
    """The 16-line `Cluster Analysis Results` block (analysis.go:177-199,
    alloc.go:65-88). Returns the summary key/values the analysis parser
    would read from it."""
    summary: Dict[str, float] = {}
    log.infoln()
    log.info(f"========== Cluster Analysis Results ({tag}) ==========")
    log.info("Allocation Ratio:")
    for k in _ALLOC_KEYS:
        rval = alloc_requested[k]
        aval = alloc_allocatable[k]
        ratio = 100.0 * rval / aval if aval else 0.0
        log.info(f"    {k:<8}: {ratio:4.1f}% ({rval}/{aval})")
        summary[camel_to_snake(k + tag)] = float(f"{ratio:4.1f}")
        summary[camel_to_snake(k + "Amount" + tag)] = float(rval)
        summary[camel_to_snake(k + "Total")] = float(aval)
    total = float(frag_amounts.sum())
    denom = total if total else 1.0
    for v, name in enumerate(FRAG_CLASS_NAMES):
        val = float(frag_amounts[v])
        pct = 100 * val / denom
        log.info(f"{name:<13}: {val / 1000:6.2f} x 10^3 ({pct:5.2f}%)")
        summary[camel_to_snake(name + tag)] = float(f"{pct:5.2f}")
    log.info("--------------------")
    log.info(f"{'idle_gpu_milli':<13}: {total / 1000:6.2f} x 10^3 (100.0%)")
    frag = total - float(frag_amounts[Q3_SATISFIED])
    fpct = 100 * frag / denom
    log.info(
        f"{'frag_gpu_milli':<13}: {frag / 1000:6.2f} x 10^3 ({fpct:5.2f}%)"
    )
    summary[camel_to_snake("frag_gpu_milli" + tag)] = float(f"{fpct:5.2f}")
    log.info("==============================================")
    log.infoln()
    return summary


def disruption_report_block(log: LogSink, dm) -> Dict[str, float]:
    """The `[Disruption]` block a fault replay prints after its last
    segment (dm: tpusim_torch.sim.metrics.DisruptionMetrics). The analysis
    parser skips this line family; the returned summary joins the CSV
    stash as cluster_analysis_block's does."""
    log.info(
        f"[Disruption] node failures: {dm.node_failures}, recoveries: "
        f"{dm.node_recoveries}, evicted pods: {dm.evicted_pods}, retries "
        f"enqueued: {dm.retries_enqueued}"
    )
    lat = dm.reschedule_latency_events
    log.info(
        f"[Disruption] rescheduled: {dm.rescheduled_pods} "
        f"(latency events mean {dm.mean_reschedule_latency():.1f}, max "
        f"{max(lat) if lat else 0}), unscheduled after retries: "
        f"{dm.unscheduled_after_retries}"
    )
    log.info(
        f"[Disruption] failed-node GPU capacity lost: "
        f"{dm.failed_node_gpu_events} GPU-events"
    )
    if dm.post_recovery_frag_delta:
        log.info(
            f"[Disruption] post-recovery frag delta: "
            f"{sum(dm.post_recovery_frag_delta) / 1000:.2f} x 10^3 over "
            f"{len(dm.post_recovery_frag_delta)} recoveries"
        )
    return {f"disruption_{k}": float(v) for k, v in dm.as_dict().items()}
