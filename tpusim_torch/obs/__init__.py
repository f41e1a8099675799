"""tpusim_torch.obs: run telemetry (the port's copy of tpusim/obs's
replay-side modules; the same exports as tpusim.obs).

  counters   exact event counters riding the replays' carries (the record
             forms of the replay kernels add them on the card)
  decisions  per-event decision provenance: winner, per-policy score
             contributions, top-K runner-ups, tie-break ranks; JSONL
             files behind `explain` / `diff`
  series     the cluster time-series: fixed-stride utilization / frag /
             score-distribution samples taken as the replay runs,
             rendered by `report`
  spans      phase timers with a dispatch/block wall split;
             Recorder/RunTelemetry accumulate them per run
  heartbeat  progress ticks from inside long launches (a host-mapped ring
             the kernels write, drained by a host thread)
  emitters   JSONL run records, Prometheus textfiles, Chrome traces (incl.
             frag/alloc + series counter tracks)

Layering: obs imports nothing from sim/ (the engines and the driver import
obs, never the reverse).
"""

from tpusim_torch.obs.counters import (  # noqa: F401
    COUNTER_FIELDS,
    INVARIANT_FIELDS,
    NUM_COUNTERS,
    counter_delta,
    counters_from_telemetry,
    counters_to_dict,
    zero_counters,
)
from tpusim_torch.obs.decisions import (  # noqa: F401
    DECISION_SCHEMA,
    DECISION_TOPK,
    DecisionLog,
    DecisionRecord,
)
from tpusim_torch.obs.series import (  # noqa: F401
    FRAG_CATEGORY_NAMES,
    SERIES_SCHEMA,
    UTIL_BUCKETS,
    SeriesLog,
    SeriesSample,
)
from tpusim_torch.obs.spans import (  # noqa: F401
    SCHEMA,
    Recorder,
    RunTelemetry,
    Span,
    note_compile_cache,
)
