"""Telemetry emitters: JSONL run records, Prometheus textfiles, Chrome
traces, the machine-readable outputs of a profiled run (the port's copy
of tpusim/obs/emitters.py; the formats and metric names are tpusim's).

Three consumers, three formats:

  JSONL    one self-contained record per run, appended (`--profile PATH`)
           — the reproducibility tests read this
  Prom     node_exporter textfile-collector gauges (`--metrics-out PATH`)
           — scrape-ready; written atomically (tmp + rename) per the
           textfile collector contract so a scraper never sees a torn
           file
  Chrome   chrome://tracing / Perfetto "X" (complete) events from the
           span list (`--trace-out PATH`) — the phase timeline view —
           plus "C" counter tracks (per-event frag/alloc series from the
           metrics postpass) charting fragmentation under the spans

All writers are atomic (tmp + os.replace) except the JSONL append, whose
unit of atomicity is the single O_APPEND write of one line.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterable, List

_METRIC_RE = re.compile(r"[^a-zA-Z0-9_]")


def _atomic_write(path: str, text: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def append_jsonl(path: str, record: dict) -> str:
    """Append one run record as a single JSON line (sorted keys, so two
    identical records are byte-identical lines — the bit-reproducibility
    contract is checkable with `diff`)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    line = json.dumps(record, sort_keys=True, separators=(",", ":"))
    with open(path, "a") as f:
        f.write(line + "\n")
    return path


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _metric_name(*parts: str) -> str:
    return _METRIC_RE.sub("_", "_".join(p for p in parts if p)).lower()


def escape_label_value(value: str) -> str:
    """Escape a label VALUE per the Prometheus exposition format (text
    version 0.0.4): backslash, double-quote, and line-feed are the three
    characters with escape sequences — everything else passes through.
    Order matters: backslashes first, or the other escapes' own
    backslashes would be doubled."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def unescape_label_value(value: str) -> str:
    """Inverse of escape_label_value (the round-trip contract tests pin).
    A manual scan, not chained replaces — `\\n` must decode to
    backslash+n, which replace-ordering cannot express."""
    out = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:  # unknown escape: keep verbatim (prom parsers do too)
                out.append(c + nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


# one sample line: name, optional {labels}, value. Label values may hold
# any escaped character, including escaped quotes.
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
    r' (\S+)$'
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str):
    """Strict-ish parse of an exposition-format snapshot into
    {(name, ((label, value), ...)): float}. Raises ValueError on any
    line that is neither a comment nor a well-formed sample, and on
    duplicate series — the checks the textfile collector applies, used
    by the round-trip tests."""
    out = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: not a valid sample: {line!r}")
        name, labels_raw, value = m.group(1), m.group(2), m.group(3)
        labels = tuple(
            (k, unescape_label_value(v))
            for k, v in _LABEL_RE.findall(labels_raw or "")
        )
        key = (name, labels)
        if key in out:
            raise ValueError(f"line {ln}: duplicate series {key}")
        try:
            out[key] = float(value)
        except ValueError:
            raise ValueError(f"line {ln}: bad sample value {value!r}")
    return out


def prometheus_lines(record: dict, prefix: str = "tpusim") -> List[str]:
    """Flatten a run record into `# TYPE ... gauge` + sample lines. Only
    the numeric leaves ship; span walls become
    `tpusim_span_seconds{name="...",phase="dispatch|block"}`.

    Each `# TYPE` declaration is emitted ONCE per metric name: two
    samples of the same metric (different labels, or two record keys
    sanitizing to the same name) must share one declaration — strict
    promtext parsers (and node_exporter's textfile collector) reject a
    file with duplicate TYPE lines for a metric. The same strictness
    applies to SAMPLES: only one line per (name, labelset) is legal, so
    when two record keys sanitize to one collision-free name the first
    (sorted-order) writer wins and later duplicates are dropped — an
    invalid file would lose the whole snapshot, not just one sample."""
    det = record.get("deterministic", {})
    lines: List[str] = []
    typed: set = set()
    emitted: set = set()

    def gauge(name: str, value, labels: str = ""):
        if (name, labels) in emitted:
            return
        emitted.add((name, labels))
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {value}")

    gauge(_metric_name(prefix, "events_total"), det.get("events", 0))
    for group in ("counters", "degrades", "counts", "disruption"):
        for k, v in sorted(det.get(group, {}).items()):
            gauge(_metric_name(prefix, group[:-1] if group.endswith("s")
                               else group, k), v)
    cache = det.get("table_cache", "off")
    gauge(_metric_name(prefix, "table_cache_hit"), int(cache == "hit"))
    # ---- the time-series plane: the LAST sample of every series ships
    # as a gauge (what "live cluster telemetry" means to a scraper), plus
    # the sample count so dashboards can rate
    series = record.get("series") or {}
    if series.get("pos"):
        sname = _metric_name(prefix, "series")
        gauge(f"{sname}_samples", len(series["pos"]))
        gauge(f"{sname}_last_pos", series["pos"][-1])
        for scalar in ("feasible", "nodes_down", "retry_depth"):
            if series.get(scalar):
                gauge(f"{sname}_{scalar}", series[scalar][-1])
        cats = series.get("frag_categories", [])
        if series.get("frag"):
            last = series["frag"][-1]
            for j, cat in enumerate(cats[: len(last)]):
                gauge(
                    f"{sname}_frag_gpu_milli",
                    last[j],
                    f'{{category="{escape_label_value(cat)}"}}',
                )
        if series.get("util_hist"):
            last = series["util_hist"][-1]
            nb = max(len(last), 1)
            for b, v in enumerate(last):
                gauge(
                    f"{sname}_util_nodes", v,
                    f'{{bucket="{100 * b // nb:02d}"}}',
                )
        pols = series.get("policies", [])
        for field in ("score_hi", "score_lo"):
            if series.get(field):
                last = series[field][-1]
                for i, pol in enumerate(pols[: len(last)]):
                    gauge(
                        f"{sname}_{field}", last[i],
                        f'{{policy="{escape_label_value(pol)}"}}',
                    )
    timing = record.get("timing", {})
    if "wall_s" in timing:
        gauge(_metric_name(prefix, "wall_seconds"), timing["wall_s"])
    # aggregate spans per (name, phase): a profiled run records MANY spans
    # with the same name (one 'scan' per chunk/segment/warm run), and the
    # Prometheus text format forbids duplicate series — node_exporter's
    # textfile collector would drop the whole file
    agg: dict = {}
    counts: dict = {}
    for s in timing.get("spans", []):
        # label values are ESCAPED, never stripped: a span named with a
        # quote/backslash/newline must round-trip through a strict
        # exposition-format parser (escape_label_value)
        name = str(s.get("name", ""))
        counts[name] = counts.get(name, 0) + 1
        for phase in ("dispatch", "block"):
            key = (name, phase)
            agg[key] = agg.get(key, 0.0) + float(s.get(f"{phase}_s", 0))
    if agg:
        span_metric = _metric_name(prefix, "span_seconds_total")
        for (name, phase), v in sorted(agg.items()):
            gauge(
                span_metric, round(v, 6),
                f'{{name="{escape_label_value(name)}",phase="{phase}"}}',
            )
        count_metric = _metric_name(prefix, "span_count")
        for name, n in sorted(counts.items()):
            gauge(count_metric, n,
                  f'{{name="{escape_label_value(name)}"}}')
    return lines


def write_prometheus(path: str, record: dict, prefix: str = "tpusim") -> str:
    _atomic_write(path, "\n".join(prometheus_lines(record, prefix)) + "\n")
    return path


def chrome_trace_events(spans: Iterable, pid: int = 1) -> List[dict]:
    """Span list -> Chrome trace "X" events (ts/dur in microseconds).
    Each span renders as two stacked slices — the dispatch (compile)
    half and the block (execute) half — so the compile/execute split is
    visible directly on the timeline."""
    events = []
    for s in spans:
        d = s.to_dict() if hasattr(s, "to_dict") else dict(s)
        base = {"pid": pid, "tid": 1, "ph": "X", "cat": "tpusim"}
        t0 = d["start_s"] * 1e6
        if d.get("dispatch_s", 0) > 0:
            events.append({
                **base, "name": f"{d['name']}:dispatch",
                "ts": t0, "dur": d["dispatch_s"] * 1e6,
                "args": d.get("meta", {}),
            })
        if d.get("block_s", 0) > 0:
            events.append({
                **base, "name": f"{d['name']}:block",
                "ts": t0 + d.get("dispatch_s", 0) * 1e6,
                "dur": d["block_s"] * 1e6,
                "args": d.get("meta", {}),
            })
    return events


# counter tracks denser than this are strided down — Perfetto renders a
# multi-thousand-point counter no better, and the trace file stays small
MAX_COUNTER_POINTS = 2000


def chrome_counter_events(
    counter_series: dict, spans: Iterable, pid: int = 1,
    max_points: int = MAX_COUNTER_POINTS,
) -> List[dict]:
    """Per-event series -> Chrome counter-track events (`"ph": "C"`), so
    the timeline shows fragmentation/allocation evolving UNDER the phase
    spans. `counter_series` maps track name -> one value per event (the
    frag/alloc series the metrics postpass already computes,
    sim/metrics.compute_event_metrics). Events carry no wall timestamps
    — the scan spans do — so the E points are laid out linearly across
    the union of the `scan` spans' wall window (falling back to the full
    span window), which is exactly the stretch of the timeline the
    events executed in."""
    spans = list(spans)
    dicts = [s.to_dict() if hasattr(s, "to_dict") else dict(s) for s in spans]
    windows = [d for d in dicts if d.get("name") == "scan"] or dicts

    def _end_s(d):
        # the stretch the "X" slices actually render: dispatch + block
        # when the span recorded them (profiled runs — the only ones
        # emitting traces). total_s can run past that by whatever host
        # pause hit between dispatched() and span exit, which would
        # strand the tail counter points beyond every rendered slice.
        halves = d.get("dispatch_s", 0) + d.get("block_s", 0)
        return d["start_s"] + (halves if halves > 0 else d.get("total_s", 0))

    if windows:
        t0 = min(d["start_s"] for d in windows) * 1e6
        t1 = max(_end_s(d) for d in windows) * 1e6
    else:
        t0, t1 = 0.0, 1e6
    events: List[dict] = []
    for track, values in sorted(counter_series.items()):
        values = list(values)
        n = len(values)
        if not n:
            continue
        stride = max(1, -(-n // max_points))
        idx = list(range(0, n, stride))
        if idx[-1] != n - 1:
            idx.append(n - 1)  # always chart the final value
        span_us = max(t1 - t0, 1.0)
        for i in idx:
            ts = t0 + span_us * (i / max(n - 1, 1))
            events.append({
                "pid": pid, "tid": 0, "ph": "C", "cat": "tpusim",
                "name": track, "ts": ts, "args": {track: values[i]},
            })
    return events


def write_chrome_trace(path: str, spans: Iterable,
                       counter_series: dict = None) -> str:
    spans = list(spans)
    events = chrome_trace_events(spans)
    if counter_series:
        events.extend(chrome_counter_events(counter_series, spans))
    _atomic_write(
        path,
        json.dumps({"traceEvents": events, "displayTimeUnit": "ms"}),
    )
    return path


def build_record(telemetry, meta: dict = None, series: dict = None) -> dict:
    """One run's JSONL record from its RunTelemetry, plus the caller's
    meta and the series block (obs.series.series_to_record), built once
    so every consumer (JSONL append, Prometheus textfile) renders the
    same record."""
    record = telemetry.to_record()
    if meta:
        record["deterministic"]["meta"].update(meta)
    if series:
        record["series"] = series
    return record


def emit_record(record: dict, spans, jsonl: str = "", metrics: str = "",
                trace: str = "", counter_series: dict = None) -> List[str]:
    """Write the requested emitter outputs for a prebuilt record; returns
    the paths written. `spans` feeds the Chrome-trace timeline;
    `counter_series` (track name -> per-event values) adds counter
    tracks to it."""
    written = []
    if jsonl:
        written.append(append_jsonl(jsonl, record))
    if metrics:
        written.append(write_prometheus(metrics, record))
    if trace:
        written.append(write_chrome_trace(trace, spans, counter_series))
    return written


def emit_all(telemetry, jsonl: str = "", metrics: str = "", trace: str = "",
             meta: dict = None, counter_series: dict = None,
             series: dict = None) -> List[str]:
    """build_record + emit_record for one RunTelemetry (the historical
    one-call surface)."""
    record = build_record(telemetry, meta=meta, series=series)
    return emit_record(
        record, telemetry.spans, jsonl=jsonl, metrics=metrics, trace=trace,
        counter_series=counter_series,
    )
