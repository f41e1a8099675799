"""Decision provenance, the per-event flight recorder of obs (the port's
copy of tpusim/obs/decisions.py).

The paper's whole argument is comparative: FGD places pods *differently*
from BestFit/DotProd/Packing, and that difference IS the fragmentation
win. End-state aggregates show *that* two policies diverge; this module
captures *which event* diverged first and *why a node won*, at scan time
instead of by re-running.

Vocabulary (the fixed-shape per-event record every engine emits: the
decision twin of the `counters.py` `ctr` leaf; the replay kernels' record
forms write it as one int32 row an event, sim/records.py):

    node        i32     winning node (-1 = failed create / non-create)
    total       i32     the winner's weighted selectHost total
    raw         i32[π]  the winner's per-policy RAW plugin scores
    norm        i32[π]  the winner's per-policy NORMALIZED scores — the
                        values the weighted sum actually consumed, so
                        Σ weight·norm == total holds exactly
    topk_node   i32[K]  top-K candidates in selection order (entry 0 IS
                        the packed_argmax winner; -1 pads)
    topk_total  i32[K]  their weighted totals
    topk_rank   i32[K]  their tie-break ranks (the lexicographic second
                        key — why equal-total candidates lost)
    feasible    i32     Filter-phase candidate count (pinning included)
    block       i32     the block id that won in a blocked select.
                        Engine-SPECIFIC by nature (like the counters'
                        `rebuilds` slot): -1 on the flat/sequential
                        paths — cross-engine bit-identity is pinned on
                        INVARIANT_FIELDS.

All leaves are exact i32, so the stream is bit-reproducible across
engines, transparent to checkpoint kill/resume (the driver persists the
accumulated stream beside event_node/event_dev in the same
content-addressed checkpoint), and continuous across fault segmentation.

Persistence is one JSONL file per run: a header line (schema, policies +
weights, meta, and a sha256 payload digest under the io.storage
checkpoint-digest discipline — a torn or hand-edited file fails loudly
on read), then one line per event. `explain` and `diff` (tpusim_torch.cli)
consume these files; the format is tpusim's, so either package reads the
other's files.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

DECISION_SCHEMA = "tpusim-decisions-v1"

# Top-K depth of the runner-up capture. A fixed constant — NOT a knob —
# because every engine must emit the same shape for the cross-engine
# bit-identity contract to be checkable with array_equal.
DECISION_TOPK = 3


class DecisionRecord(NamedTuple):
    """One scheduling decision (field semantics in the module docstring).
    Stacked over the event axis, every leaf is int32 ([E] or [E, x])."""

    node: object
    total: object
    raw: object  # [num_policies]
    norm: object  # [num_policies]
    topk_node: object  # [DECISION_TOPK]
    topk_total: object  # [DECISION_TOPK]
    topk_rank: object  # [DECISION_TOPK]
    feasible: object
    block: object


# engine-invariant fields (everything but the blocked-select block id)
INVARIANT_FIELDS = tuple(
    f for f in DecisionRecord._fields if f != "block"
)


class DecisionLog(NamedTuple):
    """A replay's full decision stream plus the event stream it describes
    — what SimulateResult.decisions carries and write_decisions persists.
    All members are host numpy arrays with a leading event axis."""

    records: DecisionRecord
    ev_kind: object  # i32[E]
    ev_pod: object  # i32[E]


def no_decision(num_policies: int, device=None) -> DecisionRecord:
    """The inert record non-create events emit: fixed shape, all
    sentinels, int32 tensors on `device`."""
    import torch

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=device)

    return DecisionRecord(
        node=full((), -1),
        total=full((), 0),
        raw=full((num_policies,), 0),
        norm=full((num_policies,), 0),
        topk_node=full((DECISION_TOPK,), -1),
        topk_total=full((DECISION_TOPK,), 0),
        topk_rank=full((DECISION_TOPK,), -1),
        feasible=full((), 0),
        block=full((), -1),
    )


def concat_logs(logs: Sequence[DecisionLog]) -> Optional[DecisionLog]:
    """Concatenate segment logs along the event axis (the fault path's
    per-segment streams; checkpoint resume concatenates the same way)."""
    logs = [l for l in logs if l is not None]
    if not logs:
        return None
    rec = DecisionRecord(
        *(
            np.concatenate([np.asarray(getattr(l.records, f)) for l in logs])
            for f in DecisionRecord._fields
        )
    )
    return DecisionLog(
        rec,
        np.concatenate([np.asarray(l.ev_kind) for l in logs]),
        np.concatenate([np.asarray(l.ev_pod) for l in logs]),
    )


# ---------------------------------------------------------------------------
# Host-side rows + JSONL persistence
# ---------------------------------------------------------------------------


def decision_rows(log: DecisionLog, pod_names=None) -> List[dict]:
    """One JSON-ready dict per event from a stacked DecisionLog."""
    r = log.records
    node = np.asarray(r.node)
    total = np.asarray(r.total)
    raw = np.asarray(r.raw)
    norm = np.asarray(r.norm)
    tkn = np.asarray(r.topk_node)
    tkt = np.asarray(r.topk_total)
    tkr = np.asarray(r.topk_rank)
    feas = np.asarray(r.feasible)
    blk = np.asarray(r.block)
    kinds = np.asarray(log.ev_kind)
    pods = np.asarray(log.ev_pod)
    rows = []
    for i in range(node.shape[0]):
        row = {
            "e": int(i),
            "kind": int(kinds[i]),
            "pod": int(pods[i]),
            "node": int(node[i]),
            "total": int(total[i]),
            "raw": raw[i].astype(int).tolist(),
            "norm": norm[i].astype(int).tolist(),
            "topk": [
                [int(tkn[i, j]), int(tkt[i, j]), int(tkr[i, j])]
                for j in range(tkn.shape[1])
            ],
            "feasible": int(feas[i]),
            "block": int(blk[i]),
        }
        if pod_names is not None:
            row["name"] = str(pod_names[int(pods[i])])
        rows.append(row)
    return rows


def _row_lines(rows: List[dict]) -> List[str]:
    return [
        json.dumps(r, sort_keys=True, separators=(",", ":")) for r in rows
    ]


def _payload_digest(lines: List[str]) -> str:
    from tpusim_torch.io.storage import checkpoint_digest

    return checkpoint_digest(
        (line + "\n").encode() for line in lines
    )


def write_decisions(
    path: str,
    log: DecisionLog,
    policies: Sequence,
    meta: Optional[dict] = None,
    pod_names=None,
) -> str:
    """Persist one run's decision stream as JSONL: a header line carrying
    the schema, the policy list with weights (what `explain` multiplies
    the norm column by), caller meta, and the sha256 digest of the
    payload lines (io.storage.checkpoint_digest — the same
    content-digest discipline checkpoints use, so read_decisions rejects
    torn/edited files), then one line per event. Written atomically
    (tmp + os.replace)."""
    rows = decision_rows(log, pod_names)
    lines = _row_lines(rows)
    header = {
        "schema": DECISION_SCHEMA,
        "topk": DECISION_TOPK,
        "events": len(rows),
        "policies": [[str(n), int(w)] for n, w in policies],
        "meta": dict(meta or {}),
        "digest": _payload_digest(lines),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(header, sort_keys=True, separators=(",", ":")))
        f.write("\n")
        for line in lines:
            f.write(line + "\n")
    os.replace(tmp, path)
    return path


def read_decisions(path: str) -> Tuple[dict, List[dict]]:
    """(header, rows) from a decision JSONL; verifies the header's payload
    digest so a torn/truncated/edited file fails loudly instead of
    producing a silently wrong explain/diff."""
    with open(path) as f:
        raw_lines = [l.rstrip("\n") for l in f if l.strip()]
    if not raw_lines:
        raise ValueError(f"{path}: empty decision file")
    header = json.loads(raw_lines[0])
    if header.get("schema") != DECISION_SCHEMA:
        raise ValueError(
            f"{path}: not a {DECISION_SCHEMA} file "
            f"(schema={header.get('schema')!r})"
        )
    payload = raw_lines[1:]
    digest = _payload_digest(payload)
    if digest != header.get("digest"):
        raise ValueError(
            f"{path}: payload digest mismatch (torn or edited file): "
            f"header {header.get('digest')} != computed {digest}"
        )
    if len(payload) != int(header.get("events", len(payload))):
        raise ValueError(
            f"{path}: header says {header.get('events')} events, file has "
            f"{len(payload)}"
        )
    return header, [json.loads(l) for l in payload]


# ---------------------------------------------------------------------------
# Run-diff divergence tracing
# ---------------------------------------------------------------------------


def check_comparable(rows_a: List[dict], rows_b: List[dict]) -> None:
    """Reject a diff of two runs that do not describe the same trace:
    every compared row must agree on (kind, pod) — the event stream —
    and on the pod NAME where both runs recorded one (pod indices alone
    are too weak: unrelated traces both open with 'create pod 0') — or
    the 'divergence' the diff reports is an artifact of comparing
    unrelated runs, not a policy difference. Lengths may differ (a
    shorter run diffs on the overlap); content may not."""
    for ra, rb in zip(rows_a, rows_b):
        same = int(ra["kind"]) == int(rb["kind"]) and int(
            ra["pod"]
        ) == int(rb["pod"])
        if same and "name" in ra and "name" in rb:
            same = ra["name"] == rb["name"]
        if not same:
            na = ra.get("name", f"pod[{ra['pod']}]")
            nb = rb.get("name", f"pod[{rb['pod']}]")
            raise ValueError(
                f"runs are not comparable: event {ra['e']} is "
                f"{_kind_name(ra['kind'])} {na} in one run but "
                f"{_kind_name(rb['kind'])} {nb} in the other — the two "
                "files describe different traces"
            )


def run_diff(
    header_a: dict, rows_a: List[dict],
    header_b: dict, rows_b: List[dict],
    label_a: str = "A", label_b: str = "B", buckets: int = 10,
) -> dict:
    """The one-stop diff entry of `diff` (tpusim_torch.cli): verifies the two runs
    describe the same trace (check_comparable — raises ValueError
    otherwise), then computes the divergence histogram, the
    first-divergence detail, and the formatted report in a single pass
    over the rows. Returns {'first', 'histogram', 'text'}."""
    check_comparable(rows_a, rows_b)
    hist = divergence_histogram(rows_a, rows_b, buckets)
    first = None
    if hist["first"] is not None:
        i = hist["first"]
        first = {"event": int(rows_a[i]["e"]), "a": rows_a[i],
                 "b": rows_b[i]}
    return {
        "first": first,
        "histogram": hist,
        "text": format_diff(
            header_a, rows_a, header_b, rows_b,
            label_a=label_a, label_b=label_b, buckets=buckets,
            hist=hist, first=first,
        ),
    }


def first_divergence(rows_a: List[dict], rows_b: List[dict]) -> Optional[dict]:
    """First event where the two runs placed differently (node differs),
    or None when the compared prefix agrees. Deletes/skips inherit their
    divergence from the creating event, so comparing `node` across all
    events finds the first *decision* divergence."""
    for ra, rb in zip(rows_a, rows_b):
        if int(ra["node"]) != int(rb["node"]):
            return {"event": int(ra["e"]), "a": ra, "b": rb}
    return None


def divergence_histogram(
    rows_a: List[dict], rows_b: List[dict], buckets: int = 10
) -> dict:
    """Where the two runs disagree: per-event-range bucket counts of
    differing placements, plus summary totals. Compares the common event
    prefix (runs of different lengths diff on the overlap)."""
    n = min(len(rows_a), len(rows_b))
    diff_idx = [
        i
        for i, (ra, rb) in enumerate(zip(rows_a, rows_b))
        if int(ra["node"]) != int(rb["node"])
    ]
    buckets = max(1, min(buckets, max(n, 1)))
    width = max(1, -(-n // buckets))
    counts = [0] * buckets
    for i in diff_idx:
        counts[min(i // width, buckets - 1)] += 1
    return {
        "events": n,
        "diverged": len(diff_idx),
        "bucket_width": width,
        "counts": counts,
        "first": diff_idx[0] if diff_idx else None,
        "last": diff_idx[-1] if diff_idx else None,
    }


def _policy_label(header: dict) -> str:
    return "+".join(n for n, _ in header.get("policies", [])) or "?"


def format_diff(
    header_a: dict, rows_a: List[dict], header_b: dict, rows_b: List[dict],
    label_a: str = "A", label_b: str = "B", buckets: int = 10,
    hist: Optional[dict] = None, first: Optional[dict] = None,
) -> str:
    """Human-readable run diff: first-divergence detail + the divergence
    histogram. Deterministic text for deterministic inputs (golden-output
    testable). `hist`/`first` accept precomputed results (run_diff passes
    them) so a large run is scanned once, not per consumer."""
    if hist is None:
        hist = divergence_histogram(rows_a, rows_b, buckets)
        first = first_divergence(rows_a, rows_b)
    out = [
        f"[diff] {label_a}: {_policy_label(header_a)} "
        f"({len(rows_a)} events)  vs  {label_b}: "
        f"{_policy_label(header_b)} ({len(rows_b)} events)",
        f"[diff] compared {hist['events']} events: "
        f"{hist['diverged']} diverged placements",
    ]
    if first is None:
        out.append("[diff] no divergence on the compared prefix")
        return "\n".join(out)
    ra, rb = first["a"], first["b"]
    name = ra.get("name", f"pod[{ra['pod']}]")
    out.append(
        f"[diff] first divergence at event {first['event']} "
        f"({_kind_name(ra['kind'])} {name}):"
    )
    out.append(
        f"[diff]   {label_a}: node {ra['node']} total {ra['total']} "
        f"(feasible {ra['feasible']})"
    )
    out.append(
        f"[diff]   {label_b}: node {rb['node']} total {rb['total']} "
        f"(feasible {rb['feasible']})"
    )
    out.append(
        f"[diff] histogram (bucket = {hist['bucket_width']} events): "
        + " ".join(str(c) for c in hist["counts"])
    )
    out.append(
        f"[diff] first diverged event {hist['first']}, last "
        f"{hist['last']}"
    )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Explain — why a node won
# ---------------------------------------------------------------------------


def _kind_name(kind: int) -> str:
    return {0: "create", 1: "delete", 2: "skip"}.get(int(kind), f"kind{kind}")


def format_explain(header: dict, rows: List[dict], event: int) -> str:
    """The human-readable per-policy score table for one event: winner,
    raw/normalized/weighted contributions per policy (the weighted sum
    must reproduce the recorded selectHost total exactly — a mismatch
    raises ValueError, the unusable-input path of `explain`),
    top-K runner-ups with totals and tie-break ranks, and the 'why n
    beat m' line."""
    if not 0 <= event < len(rows):
        raise ValueError(
            f"event {event} out of range (run has {len(rows)} events)"
        )
    r = rows[event]
    name = r.get("name", f"pod[{r['pod']}]")
    kind = _kind_name(r["kind"])
    out = [f"event {event}: {kind} {name}"]
    if r["kind"] != 0:
        out.append(
            f"  no scheduling decision recorded for {kind} events "
            "(provenance is captured at creation time)"
        )
        return "\n".join(out)
    if r["node"] < 0:
        out.append(
            f"  unschedulable: {r['feasible']} feasible nodes after Filter"
        )
        return "\n".join(out)
    out.append(
        f"winner: node {r['node']}  total={r['total']}  "
        f"feasible={r['feasible']}"
        + (f"  block={r['block']}" if r["block"] >= 0 else "")
    )
    policies = header.get("policies", [])
    out.append(f"  {'policy':<20}{'weight':>8}{'raw':>10}{'norm':>8}"
               f"{'weighted':>12}")
    total = 0
    for i, (pname, weight) in enumerate(policies):
        raw = r["raw"][i] if i < len(r["raw"]) else 0
        norm = r["norm"][i] if i < len(r["norm"]) else 0
        contrib = int(weight) * int(norm)
        total += contrib
        out.append(
            f"  {pname:<20}{weight:>8}{raw:>10}{norm:>8}{contrib:>12}"
        )
    if total != int(r["total"]):
        raise ValueError(
            f"event {event}: weighted sum of per-policy contributions "
            f"({total}) != recorded winner total ({r['total']}) — the "
            "file's norm/weights are inconsistent with its totals"
        )
    out.append(
        f"  {'weighted sum':<46}{total:>12}  == recorded total "
        f"{r['total']}"
    )
    out.append(f"top-{len(r['topk'])} candidates (selection order):")
    for j, (n, t, rk) in enumerate(r["topk"]):
        if n < 0:
            continue
        tagline = "  <- winner" if j == 0 else ""
        out.append(f"  #{j + 1} node {n}  total={t}  rank={rk}{tagline}")
    runner = next(
        ((n, t, rk) for (n, t, rk) in r["topk"][1:] if n >= 0), None
    )
    if runner is not None:
        wn, wt, wr = r["topk"][0]
        rn, rt, rr = runner
        if wt != rt:
            why = f"higher total ({wt} > {rt})"
        else:
            why = f"equal totals, smaller tie-break rank ({wr} < {rr})"
        out.append(f"why node {wn} beat node {rn}: {why}")
    elif r["feasible"] == 1:
        out.append(
            f"node {r['node']} was the only feasible candidate"
        )
    return "\n".join(out)
