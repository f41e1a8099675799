"""Phase spans and the run recorder, the timing half of obs (the port's
copy of tpusim/obs/spans.py).

A Span is one named phase of an experiment (typical_pods, init_tables,
scan, fetch, metrics_postpass, report, ...) with a dispatch/block wall
split. CUDA launches are asynchronous: the host returns from a launch once
it is queued, and the card finishes later, so

    dispatch_s  host wall until the phase's launches returned (the first
                call of a process includes building the kernels' library)
    block_s     wall spent in torch.cuda.synchronize() waiting for the
                card. Only taken when the recorder is enabled (profiling
                blocks on each phase's result); an unprofiled run adds no
                sync point, so its spans carry dispatch walls only.

The Recorder accumulates spans, host counters (cache hits, disruption
totals) and the replays' counter vectors (obs.counters) across every
replay a Simulator runs: fault runs note one replay per segment and the
vectors sum. RunTelemetry is the snapshot the driver attaches to
SimulateResult; its to_record() splits the JSONL payload into a
`deterministic` block (bit-identical across same-seed runs and across
kill/resume) and a `timing` block (machine-dependent walls).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tpusim_torch.obs.counters import (
    NUM_COUNTERS,
    counters_to_dict,
)

SCHEMA = "tpusim-obs-v1"


@dataclass
class Span:
    name: str
    start_s: float  # relative to the recorder epoch
    dispatch_s: float  # host wall until dispatch returned (compile on cold)
    block_s: float  # wall waiting on the device result (execute); 0 = unknown
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return self.dispatch_s + self.block_s

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "dispatch_s": round(self.dispatch_s, 6),
            "block_s": round(self.block_s, 6),
            "total_s": round(self.total_s, 6),
        }
        if self.meta:
            d["meta"] = self.meta
        return d


class _SpanHandle:
    """Yielded by Recorder.span(); call .dispatched() the moment the
    launches return, to split dispatch from the wait on the card."""

    __slots__ = ("_t0", "_t_dispatch")

    def __init__(self, t0: float):
        self._t0 = t0
        self._t_dispatch = None

    def dispatched(self):
        if self._t_dispatch is None:
            self._t_dispatch = time.perf_counter()


class Recorder:
    """Per-Simulator telemetry accumulator. Always cheap to keep on (a
    span is two perf_counter calls); `enabled` additionally makes the
    driver synchronise on each phase's result for the dispatch/block
    split, and is what --profile turns on."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.reset()

    def reset(self):
        self.epoch = time.perf_counter()
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.scan_counters = np.zeros(NUM_COUNTERS, np.int64)
        self._pending_scans: List[tuple] = []  # (device ctr array, pad_skips)
        self.scan_events = 0
        self.engines: List[str] = []
        self.disruption: Dict[str, int] = {}
        self.table_cache = "off"  # off | miss | hit
        # the table residency of the replay kernels (vmem = `replay`,
        # hbm = `replay_blocked`; off before any replay): the record key
        # is tpusim's, whose fused Pallas kernel had the same two tiers
        self.pallas_residency = "off"
        # the kernels' build note (note_compile_cache): set after the
        # run; None = never assessed
        self.compile_cache: Optional[dict] = None

    @contextmanager
    def span(self, name: str, **meta):
        t0 = time.perf_counter()
        h = _SpanHandle(t0)
        try:
            yield h
        finally:
            t1 = time.perf_counter()
            td = h._t_dispatch if h._t_dispatch is not None else t1
            self.spans.append(Span(
                name=name,
                start_s=t0 - self.epoch,
                dispatch_s=td - t0,
                block_s=t1 - td,
                meta=meta,
            ))

    def count(self, name: str, n: int = 1):
        self.counts[name] = self.counts.get(name, 0) + n

    def note_scan(self, engine: str, counters=None, pad_skips: int = 0,
                  events: int = 0):
        """Record one replay: which engine ran, how many events, and its
        counter vector. A device tensor is kept as it is (reading it would
        synchronise mid-run) and folded in at snapshot()."""
        self.engines.append(engine)
        self.scan_events += int(events)
        if counters is not None:
            self._pending_scans.append((counters, int(pad_skips)))

    def note_disruption(self, dm):
        """Fold a DisruptionMetrics into machine-readable counters (the
        [Disruption] log block's obs twin)."""
        self.disruption = {
            "node_failures": int(dm.node_failures),
            "node_recoveries": int(dm.node_recoveries),
            "evicted_pods": int(dm.evicted_pods),
            "rescheduled_pods": int(dm.rescheduled_pods),
            "retries_enqueued": int(dm.retries_enqueued),
            "unscheduled_after_retries": int(dm.unscheduled_after_retries),
        }

    def _drain_pending(self):
        for ctr, pad in self._pending_scans:
            if hasattr(ctr, "cpu"):
                ctr = ctr.cpu()
            vals = np.asarray(ctr).astype(np.int64).copy()
            vals[4] = max(int(vals[4]) - pad, 0)  # drop padding skips
            self.scan_counters += vals
        self._pending_scans = []

    def snapshot(self, meta: Optional[dict] = None) -> "RunTelemetry":
        self._drain_pending()
        return RunTelemetry(
            spans=list(self.spans),
            counters=counters_to_dict(self.scan_counters),
            counts=dict(self.counts),
            disruption=dict(self.disruption),
            engines=list(self.engines),
            events=self.scan_events,
            table_cache=self.table_cache,
            pallas_residency=self.pallas_residency,
            meta=dict(meta or {}),
            compile_cache=(
                dict(self.compile_cache) if self.compile_cache else None
            ),
        )


def note_compile_cache(recorder: Recorder, enabled: bool, cache_dir: str = "",
                       hit_threshold_s: float = 2.0) -> dict:
    """Stamp the run's build-cache outcome onto the recorder. The port's
    only compiled artefact is the kernels' library (tpusim_torch.kernels,
    built into compile_cache_dir): `probable_hit` says that the directory
    was set and the first scan span's dispatch wall stayed under
    hit_threshold_s (a build takes tens of seconds; a load, well under
    one), tpusim's heuristic. Lands in the run record's `timing` block."""
    scans = [s for s in recorder.spans if s.name == "scan"]
    first = scans[0] if scans else None
    info = {
        "enabled": bool(enabled),
        "dir": cache_dir,
        "first_scan_dispatch_s": (
            round(first.dispatch_s, 6) if first is not None else None
        ),
        "probable_hit": bool(
            enabled and first is not None
            and first.dispatch_s < hit_threshold_s
        ),
    }
    recorder.compile_cache = info
    return info


@dataclass
class RunTelemetry:
    """One run's telemetry: the object SimulateResult.telemetry carries
    and the JSONL emitter serializes."""

    spans: List[Span]
    counters: Dict[str, int]  # in-scan counters (obs.counters vocabulary)
    counts: Dict[str, int]  # host-side counters (degrades, cache, retries)
    disruption: Dict[str, int]
    engines: List[str]
    events: int
    table_cache: str
    meta: Dict[str, object]
    # the replay kernels' table residency (off | vmem | hbm):
    # deterministic, like table_cache
    pallas_residency: str = "off"
    # the build-cache note (note_compile_cache): enabled / dir /
    # first-scan dispatch wall / probable_hit heuristic. None when never
    # assessed; machine-dependent, so it reports under `timing`.
    compile_cache: Optional[dict] = None

    def to_record(self) -> dict:
        """The JSONL run record. `deterministic` is bit-identical across
        same-seed runs and kill/resume (integer counters + config only);
        `timing` carries the machine-dependent walls."""
        return {
            "schema": SCHEMA,
            "deterministic": {
                "events": self.events,
                "counters": self.counters,
                "degrades": {
                    k: v for k, v in sorted(self.counts.items())
                    if k.startswith("degrade_")
                },
                "counts": {
                    k: v for k, v in sorted(self.counts.items())
                    if not k.startswith("degrade_")
                },
                "disruption": self.disruption,
                "engines": self.engines,
                "table_cache": self.table_cache,
                "pallas_residency": self.pallas_residency,
                "meta": self.meta,
            },
            "timing": {
                "spans": [s.to_dict() for s in self.spans],
                "wall_s": round(
                    max((s.start_s + s.total_s for s in self.spans),
                        default=0.0),
                    6,
                ),
                **(
                    {"compile_cache": self.compile_cache}
                    if self.compile_cache is not None else {}
                ),
            },
        }
