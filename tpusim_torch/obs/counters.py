"""Exact replay counters, the bit-reproducible half of obs (the port's copy
of tpusim/obs/counters.py).

The counter vector rides each replay's carry (the `ctr` leaf of
FlatTableCarry / BlockedTableCarry, the sequential oracle's loop): integer
adds per event, the same for every engine on the same trace, and, because
the carry is the checkpoint (tpusim_torch.io.storage), exact across
kill/resume and across the fault path's segments. The record forms of the
replay kernels add them on the card and write them back into the carry's
tensor, so they run on across chunks; a launch that records nothing has
them derived from its event outputs instead (counters_from_events), which
gives the same five invariant counts.

Vocabulary (COUNTER_FIELDS order is the array layout, append-only; the
JSONL schema names these fields):

    creates       creation events attempted (EV_CREATE)
    binds         creations that placed (node >= 0)
    fail_creates  creations rejected (no feasible node)
    deletes       deletion events applied (EV_DELETE)
    skips         EV_SKIP events (the port pads no stream, so every skip
                  is the trace's)
    rebuilds      blocked-select summary-row rebuilds (the extrema-drift
                  check of `replay_blocked`). Engine-specific by nature: 0
                  on the flat and sequential paths; cross-engine equality
                  holds for COUNTER_FIELDS[:5] (INVARIANT_FIELDS).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

COUNTER_FIELDS = (
    "creates", "binds", "fail_creates", "deletes", "skips", "rebuilds",
)
NUM_COUNTERS = len(COUNTER_FIELDS)
# engine-invariant prefix (everything but `rebuilds`)
INVARIANT_FIELDS = COUNTER_FIELDS[:5]


def zero_counters(device=None):
    """int32[NUM_COUNTERS] counters at event 0, on `device`."""
    import torch

    return torch.zeros(NUM_COUNTERS, dtype=torch.int32, device=device)


def counter_delta(kc: int, node: int, rebuilt: bool = False):
    """One event's counter increments (host ints) from its clipped kind and
    its placement: the one definition the plain replays and the oracle add
    (the kernels' record forms add the same in end_event). `rebuilt` is
    the blocked replay's summary-row rebuild flag."""
    create = kc == 0
    return (int(create), int(create and node >= 0), int(create and node < 0),
            int(kc == 1), int(kc == 2), int(bool(rebuilt)))


def counters_from_events(ev_kind, event_node, rebuilds=0):
    """The counters of one replay from its event outputs (int32 tensors on
    the replay's device, no sync): the five invariant counts from the
    kinds and the chosen nodes, `rebuilds` (an int32 tensor or int) last.
    What a launch that records nothing adds to its carry's counters."""
    import torch

    kinds = ev_kind.to(torch.int32).clamp(0, 2)
    create = kinds == 0
    placed = create & (event_node >= 0)
    parts = [create.sum(), placed.sum(), (create & ~placed).sum(),
             (kinds == 1).sum(), (kinds == 2).sum()]
    out = torch.stack([p.to(torch.int32) for p in parts])
    return torch.cat([out, torch.as_tensor(rebuilds, dtype=torch.int32,
                                           device=out.device).reshape(1)])


def counters_to_dict(ctr, pad_skips: int = 0) -> Dict[str, int]:
    """Host dict from a counter vector; `pad_skips` = EV_SKIP events a
    caller appended as padding (subtracted so records describe the
    trace)."""
    vals = np.asarray(ctr).astype(np.int64)
    d = {name: int(v) for name, v in zip(COUNTER_FIELDS, vals)}
    d["skips"] = max(d["skips"] - int(pad_skips), 0)
    return d


def counters_from_telemetry(ev_kind, event_node) -> Optional[np.ndarray]:
    """The engine-invariant counters from a replay's per-event telemetry
    on the host (numpy): exact for COUNTER_FIELDS[:5]; `rebuilds` is 0.
    Returns i64[NUM_COUNTERS], or None when the two lengths differ."""
    kinds = np.asarray(ev_kind)
    nodes = np.asarray(event_node)
    if kinds.size != nodes.size:
        return None
    is_c = kinds == 0
    out = np.zeros(NUM_COUNTERS, np.int64)
    out[0] = int(is_c.sum())
    out[1] = int((is_c & (nodes >= 0)).sum())
    out[2] = int((is_c & (nodes < 0)).sum())
    out[3] = int((kinds == 1).sum())
    out[4] = int((kinds == 2).sum())
    return out
