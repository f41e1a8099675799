"""The cluster time-series, the live-state half of obs (the port's copy of
tpusim/obs/series.py).

When a replay runs with `series_every = s > 0`, it takes one bounded-shape
SeriesSample whenever the processed-event count sits on a multiple of `s`:
the replay kernels' record forms write the real samples from the card as
they run (sim/records.py lays the rows out), the plain versions and the
sequential oracle build them with `build_sample` below. A run's
utilization, fragmentation and score distributions are so recorded as
the replay runs, not rebuilt after it.

Vocabulary (every leaf int32; like the counters, append-only):

    pos         processed-event count when the sample was taken (the
                stride clock = creates+deletes+skips applied so far); -1
                marks a sentinel row
    util_hist   [UTIL_BUCKETS] UP GPU nodes bucketed by GPU-milli
                occupancy (bucket = used*B//cap, integer math, exact)
    nodes_down  nodes carrying the DOWN sentinel (mem_left < 0;
                tpusim_torch.sim.faults), 0 outside fault runs
    feasible    Filter-feasible node count for the sampled event's pod
                type (pinning excluded: a type-level property)
    frag        [7] cluster frag by FGD failure category in whole
                GPU-milli: each UP node's float32 row is rounded to whole
                milli (half to even) before an integer sum, so the total
                does not depend on the order nodes are added in
    score_hi    [num_policies] max NORMALIZED per-policy score over the
                feasible set (the value selectHost weights)
    score_lo    [num_policies] min normalized score over the feasible set
    (retry_depth, the fault path's queue depth, is host-side state the
    driver fills per segment; it lives on SeriesLog, not the sample)

Every field is an integer reduction over the cluster state after the
previously committed event and the event's pod-type score rows, so the
samples are the same for the flat, blocked and sequential engines and,
because the stride clock is the carry's counters, across kill/resume.
Fault runs restart the stride at each segment: every segment opens with a
sample of the post-fault cluster, and the driver rebases `pos` onto the
run's event clock when it concatenates the segment logs.

RandomScore's slot is always zero (its score row is a per-event draw;
sampling it would spend draws and change the trajectory).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

SERIES_SCHEMA = "tpusim-series-v1"

# occupancy buckets of the node-utilization histogram: bucket i covers
# [i*100/B, (i+1)*100/B) percent of the node's GPU-milli capacity, with
# the top bucket closed at 100%. A fixed constant, not a knob: every
# engine emits the same shape.
UTIL_BUCKETS = 10

# frag category names, in tpusim_torch.constants class-id order (Q1..NO_ACCESS)
FRAG_CATEGORY_NAMES = (
    "q1_lack_both", "q2_lack_gpu", "q3_satisfied", "q4_lack_cpu",
    "xl_satisfied", "xr_lack_cpu", "no_access",
)


class SeriesSample(NamedTuple):
    """One stride sample (field semantics in the module docstring).
    Stacked over the sample axis, every leaf is int32."""

    pos: object
    util_hist: object  # [UTIL_BUCKETS]
    nodes_down: object
    feasible: object
    frag: object  # [7] whole GPU-milli
    score_hi: object  # [num_policies]
    score_lo: object  # [num_policies]


# every field is engine-invariant (there is no engine-specific slot)
INVARIANT_FIELDS = SeriesSample._fields


def no_sample(num_policies: int, device=None) -> SeriesSample:
    """The inert sentinel row (pos == -1) of a stride miss: fixed shape,
    int32 tensors on `device`."""
    import torch

    def zeros(n):
        return torch.zeros(n, dtype=torch.int32, device=device)

    return SeriesSample(
        pos=torch.tensor(-1, dtype=torch.int32, device=device),
        util_hist=zeros(UTIL_BUCKETS),
        nodes_down=zeros(()),
        feasible=zeros(()),
        frag=zeros(len(FRAG_CATEGORY_NAMES)),
        score_hi=zeros(num_policies),
        score_lo=zeros(num_policies),
    )


def cluster_stats(state, tp):
    """(util_hist i32[B], nodes_down i32, frag i32[7]) of one cluster
    state, as int32 tensors on its device: the per-node half of a sample.
    A node's frag row is its float32 `node_frag_rows` row (the typical
    pods summed in the reference's order), rounded half to even."""
    import torch

    from tpusim_torch.constants import MILLI
    from tpusim_torch.ops.frag import node_frag_rows

    down = state.mem_left < 0
    up = ~down
    cap = state.gpu_cnt * MILLI
    used = cap - state.gpu_left.sum(-1, dtype=torch.int32)
    gpu_up = up & (state.gpu_cnt > 0)
    bucket = torch.div(used * UTIL_BUCKETS, cap.clamp(min=1),
                       rounding_mode="floor").clamp(0, UTIL_BUCKETS - 1)
    hist = torch.zeros(UTIL_BUCKETS, dtype=torch.int32,
                       device=state.cpu_left.device)
    hist.index_add_(0, bucket[gpu_up].long(),
                    torch.ones_like(bucket[gpu_up]))
    rows = node_frag_rows(state.cpu_left, state.gpu_left, state.gpu_type,
                          tp)  # f32[N, 7]
    frag = torch.where(up[:, None], torch.round(rows).to(torch.int32),
                       0).sum(0, dtype=torch.int32)
    return hist, down.sum().to(torch.int32), frag


def score_stats(raws, feasible, policies):
    """(score_hi i32[pi], score_lo i32[pi]) over the feasible set from
    per-policy RAW score rows [pi, N], each normalised as the select
    consumes it (minmax/pwr over the feasible mask, none = identity,
    RandomScore = zeros). With no feasible node both come out 0.
    `policies` are tpusim_torch.policies.Policy objects."""
    import torch

    from tpusim_torch.policies.base import normalize

    big = torch.iinfo(torch.int32).max
    any_f = bool(feasible.any())
    his, los = [], []
    for i, pol in enumerate(policies):
        raw = raws[i]
        if pol.per_event:
            nrm = torch.zeros_like(raw)
        else:
            nrm = normalize(pol.normalize, raw, feasible)
        hi = torch.where(feasible, nrm, -big).max()
        lo = torch.where(feasible, nrm, big).min()
        his.append(hi if any_f else torch.zeros_like(hi))
        los.append(lo if any_f else torch.zeros_like(lo))
    return (torch.stack(his).to(torch.int32),
            torch.stack(los).to(torch.int32))


def build_sample(state, tp, raws, feasible, policies, processed
                 ) -> SeriesSample:
    """One sample from the committed state, the sampled event's per-policy
    raw score rows ([pi, N]; RandomScore's row is ignored) and its
    type-level feasibility row (bool [N]). `processed` becomes `pos`."""
    import torch

    hist, down, frag = cluster_stats(state, tp)
    hi, lo = score_stats(raws, feasible, policies)
    return SeriesSample(
        pos=torch.tensor(int(processed), dtype=torch.int32,
                         device=feasible.device),
        util_hist=hist,
        nodes_down=down,
        feasible=feasible.sum().to(torch.int32),
        frag=frag,
        score_hi=hi,
        score_lo=lo,
    )


# ---------------------------------------------------------------------------
# Host-side log + JSONL record + rendering
# ---------------------------------------------------------------------------


class SeriesLog(NamedTuple):
    """A run's filtered sample stream on host: numpy arrays with a
    leading sample axis, plus the host-filled retry-queue depth (the
    fault driver knows the queue; the replay does not)."""

    pos: object  # i64[S] global event positions
    util_hist: object  # i32[S, UTIL_BUCKETS]
    nodes_down: object  # i32[S]
    feasible: object  # i32[S]
    frag: object  # i64[S, 7]
    score_hi: object  # i32[S, pi]
    score_lo: object  # i32[S, pi]
    retry_depth: object  # i64[S]


def log_from_stacked(stacked: SeriesSample, base_pos: int = 0,
                     retry_depth: int = 0) -> SeriesLog:
    """Filter a replay's stacked SeriesSample (host numpy or tensors) down
    to the real samples (pos >= 0) and rebase their positions onto the
    run's event clock (`base_pos` = events replayed before this replay,
    the fault path's segment offset). `retry_depth` fills the host column
    for every sample of this replay (constant within a segment)."""
    pos = np.asarray(stacked.pos)
    keep = pos >= 0
    s = int(keep.sum())
    return SeriesLog(
        pos=pos[keep].astype(np.int64) + int(base_pos),
        util_hist=np.asarray(stacked.util_hist)[keep],
        nodes_down=np.asarray(stacked.nodes_down)[keep],
        feasible=np.asarray(stacked.feasible)[keep],
        frag=np.asarray(stacked.frag)[keep].astype(np.int64),
        score_hi=np.asarray(stacked.score_hi)[keep],
        score_lo=np.asarray(stacked.score_lo)[keep],
        retry_depth=np.full(s, int(retry_depth), np.int64),
    )


def concat_series(logs: Sequence[Optional[SeriesLog]]
                  ) -> Optional[SeriesLog]:
    """Concatenate segment logs along the sample axis (fault segments,
    schedule_additional appends)."""
    logs = [l for l in logs if l is not None]
    if not logs:
        return None
    return SeriesLog(*(
        np.concatenate([np.asarray(getattr(l, f)) for l in logs])
        for f in SeriesLog._fields
    ))


def series_to_record(log: SeriesLog, every: int,
                     policy_names: Sequence[str]) -> dict:
    """The JSONL `series` block: pure-integer columns (deterministic —
    part of the record's bit-identity contract), plus the vocabulary
    needed to render without recomputation."""
    return {
        "schema": SERIES_SCHEMA,
        "every": int(every),
        "util_buckets": UTIL_BUCKETS,
        "frag_categories": list(FRAG_CATEGORY_NAMES),
        "policies": [str(p) for p in policy_names],
        "pos": np.asarray(log.pos).astype(int).tolist(),
        "util_hist": np.asarray(log.util_hist).astype(int).tolist(),
        "nodes_down": np.asarray(log.nodes_down).astype(int).tolist(),
        "feasible": np.asarray(log.feasible).astype(int).tolist(),
        "frag": np.asarray(log.frag).astype(int).tolist(),
        "score_hi": np.asarray(log.score_hi).astype(int).tolist(),
        "score_lo": np.asarray(log.score_lo).astype(int).tolist(),
        "retry_depth": np.asarray(log.retry_depth).astype(int).tolist(),
    }


def series_from_record(d: dict) -> SeriesLog:
    """Inverse of series_to_record (what `report` reads)."""
    if d.get("schema") != SERIES_SCHEMA:
        raise ValueError(
            f"not a {SERIES_SCHEMA} series block "
            f"(schema={d.get('schema')!r})"
        )
    s = len(d["pos"])
    pi = len(d.get("policies", []))
    return SeriesLog(
        pos=np.asarray(d["pos"], np.int64),
        util_hist=np.asarray(d["util_hist"], np.int64).reshape(
            s, d.get("util_buckets", UTIL_BUCKETS)),
        nodes_down=np.asarray(d["nodes_down"], np.int64),
        feasible=np.asarray(d["feasible"], np.int64),
        frag=np.asarray(d["frag"], np.int64).reshape(
            s, len(d.get("frag_categories", FRAG_CATEGORY_NAMES))),
        score_hi=np.asarray(d["score_hi"], np.int64).reshape(s, pi),
        score_lo=np.asarray(d["score_lo"], np.int64).reshape(s, pi),
        retry_depth=np.asarray(
            d.get("retry_depth", [0] * s), np.int64
        ),
    )


def series_tracks(log: SeriesLog) -> dict:
    """Chrome-trace counter-track dict (track name -> one value per
    sample; obs.emitters.chrome_counter_events) — the series' timeline
    view, sharing the emitter the frag/alloc postpass tracks use."""
    out = {
        "series_feasible_nodes": np.asarray(log.feasible).tolist(),
        "series_nodes_down": np.asarray(log.nodes_down).tolist(),
        "series_retry_depth": np.asarray(log.retry_depth).tolist(),
    }
    frag = np.asarray(log.frag)
    for j, name in enumerate(FRAG_CATEGORY_NAMES):
        out[f"series_frag_{name}"] = frag[:, j].tolist()
    return out


_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 40) -> str:
    """Coarse unicode sparkline (strided to `width` points, final value
    always kept — the terminal twin of the Chrome counter tracks)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        stride = -(-len(vals) // width)
        idx = list(range(0, len(vals), stride))
        if idx[-1] != len(vals) - 1:
            idx.append(len(vals) - 1)
        vals = [vals[i] for i in idx]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK[min(int((v - lo) / span * len(_SPARK)), len(_SPARK) - 1)]
        for v in vals
    )


def _stat_line(name: str, vals) -> str:
    a = np.asarray(vals, np.float64)
    if a.size == 0:
        return f"  {name:<28} (no samples)"
    return (
        f"  {name:<28}{a.min():>12.0f}{np.median(a):>12.0f}"
        f"{a.max():>12.0f}  {sparkline(a)}"
    )


def format_report(series: dict) -> str:
    """Terminal summary of a run record's series block: one line per
    scalar series (min / median / max + sparkline), expanded per
    category/bucket/policy for the vector series. Renders straight from
    the JSONL — no recomputation, no simulator."""
    log = series_from_record(series)
    n = len(np.asarray(log.pos))
    out = [
        f"[series] {n} samples, stride {series.get('every')} events "
        f"(pos {log.pos[0] if n else '-'}..{log.pos[-1] if n else '-'})",
        f"  {'series':<28}{'min':>12}{'median':>12}{'max':>12}",
        _stat_line("feasible_nodes", log.feasible),
        _stat_line("nodes_down", log.nodes_down),
        _stat_line("retry_depth", log.retry_depth),
    ]
    frag = np.asarray(log.frag)
    for j, name in enumerate(series.get(
            "frag_categories", FRAG_CATEGORY_NAMES)):
        out.append(_stat_line(f"frag_{name} (milli)", frag[:, j]))
    hist = np.asarray(log.util_hist)
    buckets = hist.shape[1] if hist.ndim == 2 else UTIL_BUCKETS
    for b in range(buckets):
        lo_pct = 100 * b // buckets
        hi_pct = 100 * (b + 1) // buckets
        out.append(_stat_line(
            f"util[{lo_pct}-{hi_pct}%) nodes", hist[:, b]
        ))
    hi = np.asarray(log.score_hi)
    lo = np.asarray(log.score_lo)
    for i, pname in enumerate(series.get("policies", [])):
        out.append(_stat_line(f"score_hi[{pname}]", hi[:, i]))
        out.append(_stat_line(
            f"score_spread[{pname}]", hi[:, i] - lo[:, i]
        ))
    return "\n".join(out)
