"""The replays' record streams: exact counters, decision provenance and the
cluster time-series (tpusim_torch.obs), as the record forms of the replay
kernels write them and as their plain versions compute them.

A record run launches the record form of `replay` or `replay_blocked`
(kernels/replay_records.cu and replay_blocked_records.cu, the kRecord
instantiations of the replay bodies), given a RecordSpec:

    ctr  int32[6]            the counters (obs.counters order), read at
                             the launch's start and written back at its
                             end, so they run on across chunks
    dec  int32[E, DEC_COLS]  one decision row an event (DEC_* below);
                             non-create events carry no_decision's
                             sentinels
    ser  int32[S, SER_COLS]  one row a real sample (SER_* below): the
                             events whose processed count (ctr[0] + ctr[3]
                             + ctr[4] before the event) sits on the stride;
                             S = series_count(...) is known on the host

Score columns are in the replay configuration's policy order
(fused_engine.make_config moves a per-event policy last); decision_rows /
sample_rows put them back in the caller's order. A learned family's
columns are its policies', not the folded columns of the replay (a node
feature's value computed at the winner, or over the feasible nodes). The
heartbeat is the kernel's ring (obs.heartbeat.RingTicker).

The plain versions (PlainRecords, driven by fused_engine.plain_event_loop
for both plain replays) compute the same rows with torch ops: a decision
from the event type's table rows normalised directly over the pin-masked
feasible nodes (step.build_decision), a sample from the committed state
and the tables at the top of the event (obs.series.build_sample).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpusim_torch.obs.counters import NUM_COUNTERS, counter_delta
from tpusim_torch.obs.decisions import DECISION_TOPK, DecisionRecord
from tpusim_torch.obs.series import (
    FRAG_CATEGORY_NAMES,
    UTIL_BUCKETS,
    SeriesSample,
    build_sample,
)

# decision row: node, total, feasible, block, topk node/total/rank [3 each],
# then raw [pi] and norm [pi]
DEC_NODE, DEC_TOTAL, DEC_FEASIBLE, DEC_BLOCK, DEC_TOPK = 0, 1, 2, 3, 4
DEC_FIXED = DEC_TOPK + 3 * DECISION_TOPK  # 13
# series row: pos, nodes_down, feasible, util_hist [10], frag [7], then
# score_hi [pi] and score_lo [pi]
SER_POS, SER_DOWN, SER_FEASIBLE, SER_HIST = 0, 1, 2, 3
SER_FRAG = SER_HIST + UTIL_BUCKETS
SER_FIXED = SER_FRAG + len(FRAG_CATEGORY_NAMES)  # 20


def dec_cols(num_policies: int) -> int:
    return DEC_FIXED + 2 * num_policies


def ser_cols(num_policies: int) -> int:
    return SER_FIXED + 2 * num_policies


class RecordSpec(NamedTuple):
    """What a replay records: the decision stream, the series at a stride
    (0 = off), heartbeat ticks at a stride (0 = off), and the counters so
    far (int32[6] on the replay's device; zeros where None)."""

    decisions: bool = False
    series_every: int = 0
    heartbeat_every: int = 0
    ctr: Optional[torch.Tensor] = None
    # the stride clock of `ctr` (processed(ctr)) as a host int: where the
    # host sizes the sample rows without reading the card
    processed: int = 0


class Records(NamedTuple):
    """What a record run returns: the counters after it (int32[6]), the
    decision rows (int32[E, DEC_COLS] or None) and the sample rows
    (int32[S, SER_COLS] or None), on the replay's device, in the
    configuration's policy order."""

    ctr: torch.Tensor
    dec: Optional[torch.Tensor]
    ser: Optional[torch.Tensor]


def start_counters(spec: RecordSpec, device) -> torch.Tensor:
    """A copy of the spec's counters (zeros where None): what the launch
    reads and writes back."""
    if spec.ctr is None:
        return torch.zeros(NUM_COUNTERS, dtype=torch.int32, device=device)
    ctr = spec.ctr.to(device=device, dtype=torch.int32).clone()
    if ctr.shape != (NUM_COUNTERS,):
        raise ValueError(f"ctr must be int32[{NUM_COUNTERS}]")
    return ctr


def processed(ctr) -> int:
    """The stride clock of a counter vector (host ints or a tensor):
    creates + deletes + skips."""
    vals = ctr.tolist() if hasattr(ctr, "tolist") else list(ctr)
    return int(vals[0]) + int(vals[3]) + int(vals[4])


def series_count(start: int, events: int, every: int) -> int:
    """Samples a replay of `events` events takes from processed count
    `start`: the multiples of `every` in [start, start + events)."""
    if every <= 0 or events <= 0:
        return 0
    return (start + events - 1) // every - (start - 1) // every \
        if start > 0 else (events - 1) // every + 1


def user_order(x: np.ndarray, order, cols: slice) -> np.ndarray:
    """Columns `cols` of rows `x` (pi of them, in the configuration's
    policy order) in the caller's order: column j is policy order[j]."""
    block = x[:, cols]
    out = np.empty_like(block)
    out[:, list(order)] = block
    return out


def decision_rows(dec: np.ndarray, num_policies: int,
                  order=None) -> DecisionRecord:
    """The DecisionRecord (numpy, stacked over events) of decision rows,
    raw and norm in the caller's policy order."""
    pi = num_policies
    order = range(pi) if order is None else order
    t = DEC_TOPK
    raw = user_order(dec, order, slice(DEC_FIXED, DEC_FIXED + pi))
    norm = user_order(dec, order, slice(DEC_FIXED + pi, DEC_FIXED + 2 * pi))
    return DecisionRecord(
        node=dec[:, DEC_NODE], total=dec[:, DEC_TOTAL], raw=raw, norm=norm,
        topk_node=dec[:, t:t + DECISION_TOPK],
        topk_total=dec[:, t + DECISION_TOPK:t + 2 * DECISION_TOPK],
        topk_rank=dec[:, t + 2 * DECISION_TOPK:t + 3 * DECISION_TOPK],
        feasible=dec[:, DEC_FEASIBLE], block=dec[:, DEC_BLOCK])


def sample_rows(ser: np.ndarray, num_policies: int,
                order=None) -> SeriesSample:
    """The SeriesSample (numpy, stacked over samples) of sample rows,
    score_hi and score_lo in the caller's policy order."""
    pi = num_policies
    order = range(pi) if order is None else order
    return SeriesSample(
        pos=ser[:, SER_POS],
        util_hist=ser[:, SER_HIST:SER_HIST + UTIL_BUCKETS],
        nodes_down=ser[:, SER_DOWN], feasible=ser[:, SER_FEASIBLE],
        frag=ser[:, SER_FRAG:SER_FIXED],
        score_hi=user_order(ser, order, slice(SER_FIXED, SER_FIXED + pi)),
        score_lo=user_order(ser, order,
                            slice(SER_FIXED + pi, SER_FIXED + 2 * pi)))


def on_host(record):
    """A DecisionRecord or SeriesSample (numpy arrays or tensors) with
    every field as a host numpy array."""
    return type(record)(*(x.cpu().numpy() if hasattr(x, "cpu")
                          else np.asarray(x) for x in record))


def decision_row(dec: DecisionRecord) -> list:
    """One DecisionRecord (tensors) as a row of host ints."""
    return ([int(dec.node), int(dec.total), int(dec.feasible),
             int(dec.block)] + dec.topk_node.tolist() + dec.topk_total.tolist()
            + dec.topk_rank.tolist() + dec.raw.tolist() + dec.norm.tolist())


def sample_row(s: SeriesSample) -> list:
    """One SeriesSample (tensors) as a row of host ints."""
    return ([int(s.pos), int(s.nodes_down), int(s.feasible)]
            + s.util_hist.tolist() + s.frag.tolist() + s.score_hi.tolist()
            + s.score_lo.tolist())


def no_decision_row(num_policies: int) -> list:
    return ([-1, 0, 0, -1] + [-1] * DECISION_TOPK + [0] * DECISION_TOPK
            + [-1] * DECISION_TOPK + [0] * (2 * num_policies))


# the heartbeat ring's slots (obs.heartbeat.RingTicker)
RING_SLOTS = 1024


def launch_fields(spec: RecordSpec, e: int, num_policies: int, device,
                  n_real: int):
    """The record form's ReplayArgs fields for `spec` over `e` events of a
    launch on `device` (`n_real` the cluster's nodes before any padding),
    and finish() giving its Records once the launch is queued. With a
    heartbeat, fields["ring"] is the kernels.MappedBuffer the caller's
    RingTicker drains (its device pointer is fields["hb_ring"])."""
    ctr = start_counters(spec, device)
    fields = dict(ctr=ctr, rec_every=int(spec.series_every),
                  hb_every=int(spec.heartbeat_every), rec_nodes=int(n_real))
    dec = ser = None
    if spec.decisions:
        dec = torch.empty((e, dec_cols(num_policies)), dtype=torch.int32,
                          device=device)
        fields["rec_dec"] = dec
    if spec.series_every:
        s = series_count(spec.processed, e, spec.series_every)
        ser = torch.empty((max(s, 1), ser_cols(num_policies)),
                          dtype=torch.int32, device=device)
        fields["rec_ser"] = ser
        ser = ser[:s]
    if spec.heartbeat_every:
        from tpusim_torch.kernels import MappedBuffer

        ring = MappedBuffer(1 + RING_SLOTS)
        fields.update(ring=ring, hb_ring=ring.device_ptr,
                      hb_slots=RING_SLOTS)
    return fields, lambda: Records(ctr, dec, ser)


class PlainRecords:
    """The plain versions' records of one replay: fused_engine.
    plain_event_loop calls `sample` at the top of each event (after the
    column refresh), `decide` after a create's select, and `count` after
    each event's commit. `n_real` is the node count before the blocked
    replay's padding (its pad rows are no nodes of the cluster); `block`
    is the blocked select's block width (0 = flat: block stays -1)."""

    def __init__(self, spec: RecordSpec, cfg, tp, rank, n_real: int,
                 block: int = 0):
        self.spec, self.cfg, self.tp, self.rank = spec, cfg, tp, rank
        self.n_real, self.block = n_real, block
        dev = rank.device
        self.ctr = start_counters(spec, dev).tolist()
        self.dec = [] if spec.decisions else None
        self.ser = [] if spec.series_every else None
        self.node_ids = torch.arange(rank.shape[0], dtype=torch.int32,
                                     device=dev)

    def _rows(self, tables, tid: int, feasible, k_rand):
        """(raws, norms, total) of the event type's rows over `feasible`
        in the configuration's policy order (RandomScore: the event's
        draw)."""
        from tpusim_torch.policies.base import normalize, wrap_i32
        from tpusim_torch.policies.random_policy import random_row

        score, k = tables[0], tables[1].shape[0]
        raws, norms, acc = [], [], None
        for j, (pol, w) in enumerate(zip(self.cfg.policies,
                                         self.cfg.weights)):
            raw = (random_row(k_rand, feasible) if pol.per_event
                   else score[j * k + tid])
            nrm = normalize(pol.normalize, raw, feasible)
            raws.append(raw)
            norms.append(nrm)
            term = nrm.to(torch.int64) * w
            acc = term if acc is None else acc + term
        return torch.stack(raws), torch.stack(norms), wrap_i32(acc)

    def _family(self, rows, live):
        """A learned family's rows [fam, ...] from the folded ones `rows`
        [policies, ...]: a table policy's row, or a node-only feature's
        values on the nodes of `live` (learn.policy.node_features)."""
        if not self.cfg.family:
            return rows
        from tpusim_torch.learn.policy import NODE_FEATURES, node_features

        ids = sorted({-1 - j for j in self.cfg.fam_src if j < 0})
        feats = node_features(live, self.tp, [NODE_FEATURES[i] for i in ids])
        at = {fid: r for r, fid in enumerate(ids)}
        return torch.stack([rows[j] if j >= 0 else feats[at[-1 - j]]
                            for j in self.cfg.fam_src])

    def sample(self, live, tables, tid: int) -> None:
        every = self.spec.series_every
        done = processed(self.ctr)
        if not every or done % every:
            return
        from tpusim_torch.parallel.sharding import trim_nodes

        n, k = self.n_real, tables[1].shape[0]
        feas = tables[2][tid, :n] != 0
        raws = tables[0][:, :n].reshape(-1, k, n)[:, tid]
        extra = len(self.cfg.policies) - raws.shape[0]  # RandomScore's row
        if extra:
            raws = torch.cat([raws, raws.new_zeros((extra, n))])
        state = trim_nodes(live, n)
        self.ser.append(sample_row(build_sample(
            state, self.tp, self._family(raws, state), feas, self.cfg.fam,
            done)))

    def decide(self, kind: int, tables, tid: int, pin: int, k_rand,
               node: int, live=None) -> None:
        if self.dec is None:
            return
        if kind != 0:
            self.dec.append(no_decision_row(len(self.cfg.fam)))
            return
        from tpusim_torch.sim.step import build_decision

        feasible = tables[2][tid] != 0
        if pin >= 0:
            feasible = feasible & (self.node_ids == pin)
        raws, norms, total = self._rows(tables, tid, feasible, k_rand)
        raws, norms = self._family(raws, live), self._family(norms, live)
        dev = self.rank.device
        dec = build_decision(torch.tensor(node, dtype=torch.int32,
                                          device=dev),
                             raws, norms, total, feasible, self.rank)
        if self.block and node >= 0:
            dec = dec._replace(block=torch.tensor(node // self.block))
        self.dec.append(decision_row(dec))

    def count(self, kind: int, node: int) -> None:
        from tpusim_torch.obs import heartbeat

        kc = min(max(kind, 0), 2)
        self.ctr = [a + b for a, b in zip(self.ctr, counter_delta(kc, node))]
        if heartbeat.due(processed(self.ctr), self.spec.heartbeat_every):
            heartbeat.tick(processed(self.ctr))

    def result(self, rebuilds: int = 0) -> Records:
        dev = self.rank.device
        pi = len(self.cfg.fam)
        ctr = list(self.ctr)
        ctr[5] += int(rebuilds)

        def t(rows, cols):
            if rows is None:
                return None
            return torch.tensor(rows, dtype=torch.int32,
                                device=dev).reshape(-1, cols)

        return Records(torch.tensor(ctr, dtype=torch.int32, device=dev),
                       t(self.dec, dec_cols(pi)), t(self.ser, ser_cols(pi)))
