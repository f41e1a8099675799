"""Blocked whole-replay engine for large clusters (counterpart of
tpusim/sim/pallas_engine.py's HBM-residency kernel, `_make_hbm_replay` and
`make_pallas_replay(residency="hbm")`, whose algorithm is the blocked table
engine's: `make_blocked_body`, its init and `_totals` in
tpusim/sim/table_engine.py, `block_reduce` in tpusim/sim/step.py).

The per-event math is the flat replay's (tpusim_torch.sim.fused_engine);
what changes is selectHost. The node axis is padded to whole blocks of
BLOCK = 128 nodes (tpusim_torch.parallel.sharding.pad_nodes), and the
replay keeps per (type, block) summaries beside the tables:

    bt/br/bn      [K, N/128]      the block's max weighted total (-INT_MAX
                                  where no node is feasible), the min
                                  tie-break rank among its maxima, and that
                                  node's id
    brmin/brmax   [nn, K, N/128]  the block's feasible raw extrema of each
                                  min-max or PWR normalised policy
    slo/shi       [nn, K]         the extrema the summaries were built with

Each event refreshes the dirty node's column, then that node's block
summaries for all K types under the stored extrema. The plain version
recomputes the dirty block for every type; the kernel updates each type's
summary from the node's old and new values and rescans the block only
where that cannot decide (`update_block_summaries` is the plain version
of that rule, held to the full refresh by the tests). A drift check compares
the event type's current extrema (the min/max of its block extrema) with
the stored ones; when one moved, the type's summary row is rebuilt over
all N and a rebuild is counted. A create then selects over the N/128
summaries of its type (max total, min rank, min block) instead of over N
nodes; a pinned pod bypasses them, and its Filter bit decides.

The replay returns (ReplayResult, stats) with stats i32[3] = (waits,
starts, rebuilds), the layout of the JAX kernel's DMA counters. The CUDA
kernel issues no asynchronous copies, so waits and starts are 0; rebuilds
is exact.

On CUDA tensors the wrapper `replay_blocked` launches the hand-written
kernel of tpusim_torch/kernels/replay.cu; on CPU tensors it runs the plain
PyTorch version `plain_replay_blocked`, which the tests hold against the
JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from tpusim_torch.parallel.sharding import pad_nodes, trim_nodes
from tpusim_torch.policies.base import (
    NORMALIZE_DEGENERATE,
    minmax_scale_i32,
    wrap_i32,
)
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim.engine import EV_CREATE
from tpusim_torch.sim.residency import BLOCK
from tpusim_torch.sim.table_engine import PodTypes
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

_INT_MAX = torch.iinfo(torch.int32).max


class Summaries(NamedTuple):
    """The block summaries of one replay (module docstring)."""

    bt: torch.Tensor
    br: torch.Tensor
    bn: torch.Tensor
    brmin: torch.Tensor
    brmax: torch.Tensor
    slo: torch.Tensor
    shi: torch.Tensor


def _norm_index(cfg: fe.ReplayConfig):
    """Indices of the normalised policies, in policy order."""
    return [i for i, pol in enumerate(cfg.policies) if pol.normalize != "none"]


def _totals(raws, feas, lo, hi, cfg: fe.ReplayConfig):
    """Weighted normalised totals, -INT_MAX where infeasible (the blocked
    engine's `_totals`). raws i32[n_pol, ..., X]; feas bool[..., X]; lo/hi
    i32[nn, ...]: the extrema each normalised policy is scaled against."""
    total = torch.zeros(feas.shape, dtype=torch.int64, device=feas.device)
    j = 0
    for i, (pol, w) in enumerate(zip(cfg.policies, cfg.weights)):
        raw = raws[i]
        if pol.normalize != "none":
            raw = minmax_scale_i32(raw, feas, lo[j], hi[j],
                                   NORMALIZE_DEGENERATE[pol.normalize])
            j += 1
        total = total + w * raw.to(torch.int64)
    return torch.where(feas, wrap_i32(total), -_INT_MAX)


def block_reduce(total, rank):
    """Per block (max total, min tie-break rank among the maxima, the
    first such lane) over the trailing axis. A block whose max is the
    -INT_MAX sentinel is discarded by the select, so its rank and lane are
    don't-cares."""
    m = total.max(-1).values
    key = torch.where(total == m[..., None], -rank, -_INT_MAX)
    lane = key.argmax(-1).to(torch.int32)
    r = torch.broadcast_to(rank, total.shape).gather(
        -1, lane[..., None].long())[..., 0]
    return m, r, lane


def _block_extrema(raws, feas, index):
    """(min, max) of each normalised policy's raws over the feasible nodes
    of the last axis."""
    sel = raws[index]
    return (torch.where(feas, sel, _INT_MAX).min(-1).values,
            torch.where(feas, sel, -_INT_MAX).max(-1).values)


def plain_init_summaries(tables, rank, cfg: fe.ReplayConfig) -> Summaries:
    """The summaries of the initial tables: the block extrema, the stored
    extrema as their min/max over blocks, then every block's summary under
    the stored extrema (the blocked engine's init)."""
    score, _, feas = tables
    k, n = feas.shape
    nblk, n_pol = n // BLOCK, len(cfg.policies)
    raws = score.view(n_pol, k, nblk, BLOCK)
    feas4 = (feas != 0).view(k, nblk, BLOCK)
    index = _norm_index(cfg)
    if index:
        brmin, brmax = _block_extrema(raws, feas4, index)
        slo, shi = brmin.min(-1).values, brmax.max(-1).values
    else:
        brmin = brmax = score.new_zeros((0, k, nblk))
        slo = shi = score.new_zeros((0, k))
    total = _totals(raws, feas4, slo[..., None], shi[..., None], cfg)
    bt, br, lane = block_reduce(total, rank.view(nblk, BLOCK))
    offs = torch.arange(nblk, dtype=torch.int32, device=score.device) * BLOCK
    return Summaries(bt, br, offs + lane, brmin, brmax, slo, shi)


def refresh_block(summ: Summaries, tables, rank, c: int, rows,
                  cfg: fe.ReplayConfig) -> None:
    """Recompute block c's summaries (and block extrema) of the types
    `rows` (an index or a slice) from the tables, under the stored
    extrema, in place."""
    score, _, feas = tables
    k, n = feas.shape
    cols = slice(c * BLOCK, (c + 1) * BLOCK)
    raw_blk = score.view(len(cfg.policies), k, n)[:, rows, cols]
    feas_blk = feas[rows, cols] != 0
    index = _norm_index(cfg)
    if index:
        summ.brmin[:, rows, c], summ.brmax[:, rows, c] = _block_extrema(
            raw_blk, feas_blk, index)
    total = _totals(raw_blk, feas_blk, summ.slo[:, rows], summ.shi[:, rows],
                    cfg)
    summ.bt[rows, c], summ.br[rows, c], lane = block_reduce(
        total, rank[cols])
    summ.bn[rows, c] = c * BLOCK + lane


def update_block_summaries(summ: Summaries, old, new, node: int, tables,
                           rank, cfg: fe.ReplayConfig) -> torch.Tensor:
    """Block summaries after one node's column changed, from its old and
    new values alone where they decide, in place: the plain version of
    `replay_blocked`'s summary update. `old` and `new` are the column's
    (raw scores i32[n_pol, K], Filter bits bool[K]) before and after the
    refresh; `tables` are the refreshed tables. Only `node` changed in its
    block and the stored extrema are fixed, so per type:

    - the winner is another node: the better of it and the node's new
      candidate (total, rank, node);
    - the winner is the node: it stays if its new total is not below its
      old one;
    - a normalised policy's block extrema widen to the node's new raw
      value where it is feasible;

    and the block is rescanned (`refresh_block`) where the winner was the
    node and lost, or where the node held a block extremum and moved
    inward or became infeasible. Returns the rescanned types, bool[K]."""
    c = node // BLOCK
    (old_raw, old_f), (new_raw, new_f) = old, new
    rescan = torch.zeros_like(old_f)
    index = _norm_index(cfg)
    if index:
        ro, rn = old_raw[index], new_raw[index]
        mn, mx = summ.brmin[:, :, c], summ.brmax[:, :, c]
        rescan |= (old_f & (ro == mn) & (~new_f | (rn > ro))).any(0)
        rescan |= (old_f & (ro == mx) & (~new_f | (rn < ro))).any(0)
        summ.brmin[:, :, c] = torch.where(new_f, torch.minimum(mn, rn), mn)
        summ.brmax[:, :, c] = torch.where(new_f, torch.maximum(mx, rn), mx)
    old_total, new_total = (
        _totals(raw[:, :, None], f[:, None], summ.slo, summ.shi, cfg)[:, 0]
        for raw, f in ((old_raw, old_f), (new_raw, new_f)))
    held_t, held_r, held_n = summ.bt[:, c], summ.br[:, c], summ.bn[:, c]
    rank_d = rank[node]
    other = held_n != node
    wins = other & ((new_total > held_t) | ((new_total == held_t) & (
        (rank_d < held_r) | ((rank_d == held_r) & (node < held_n)))))
    stays = ~other & (new_total >= old_total)
    rescan |= ~other & ~stays
    summ.bt[:, c] = torch.where(wins | stays, new_total, held_t)
    summ.br[:, c] = torch.where(wins, rank_d, held_r)
    summ.bn[:, c] = torch.where(wins, node, held_n)
    rows = rescan.nonzero()[:, 0]
    if rows.numel():
        refresh_block(summ, tables, rank, c, rows, cfg)
    return rescan


def check_blocked(n: int, cfg: fe.ReplayConfig) -> None:
    """The blocked replay takes whole 128-node blocks and no randomized
    configuration (those run the flat replay, as tpusim's table engine
    runs them flat)."""
    if cfg.randomized:
        raise ValueError("a randomized configuration (RandomScore, gpu_sel "
                         "random) runs the flat replay, not replay_blocked")
    if n % BLOCK:
        raise ValueError(f"{n} nodes: the blocked replay takes whole "
                         f"{BLOCK}-node blocks (pad_nodes)")


def plain_replay_blocked(state: NodeState, pods: PodSpec, types: PodTypes,
                         ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                         tp: TypicalPods, rank: torch.Tensor, tables,
                         cfg: fe.ReplayConfig, keep: dict = None,
                         on_refresh=None, faults=None, key=None,
                         start=None, record=None, n_real: int = None):
    """The plain version of the `replay_blocked` kernel: an event loop over
    tensor ops, returning (ReplayResult, stats i32[3]). The node axis of
    `state`, `rank` and the (score, sdev, feas) `tables` of the initial
    state is a whole number of 128-node blocks. `start` and `key` are
    fused_engine.plain_event_loop's: a chunk of a longer stream starts from
    its pods' placements so far, and the chain from `key` advances one step
    an event (the blocked replay draws nothing). With `keep`, the final
    tables and Summaries are stored in it ("tables", "summaries"), and,
    where `key` is given, the chain's key after the last event ("key").
    `on_refresh(dirty, old, new, tables, before, after)`, where given, is
    called after each dirty-block refresh with the dirty column's (raws,
    Filter bits) before and after the column refresh, the refreshed
    tables, and copies of the summaries before and after the block
    refresh. With `faults` (a fault_lane.FaultLane over a merged stream,
    its carry over the padded nodes) it is the plain version of
    `replay_blocked_faults` (fused_engine.plain_event_loop runs the fault
    steps) and returns (ReplayResult, stats, fault_lane.FaultOut). With
    `record` (a records.RecordSpec) it is the plain version of
    `replay_blocked_record`: keep["records"] (keep is then required) gets
    the records.Records, `n_real` the node count before the padding
    (the series leaves the pad rows out)."""
    n, k = state.num_nodes, types.num_types
    check_blocked(n, cfg)
    nblk, n_pol = n // BLOCK, len(cfg.policies)
    index = _norm_index(cfg)
    if cfg.family:  # the node column's rows under cfg's weights, first
        tables = tuple(t.clone() for t in tables)
        fe.learned_rows(tables, state, tp, cfg)
    summ = plain_init_summaries(tables, rank, cfg)
    bt, br, bn, brmin, brmax, slo, shi = summ
    rank_blk = rank.view(nblk, BLOCK)
    offs = torch.arange(nblk, dtype=torch.int32, device=rank.device) * BLOCK
    rebuilds = 0
    shadow = [t.clone() for t in tables] if on_refresh else None

    def column(score, feas, node):
        return score.view(n_pol, k, n)[:, :, node].clone(), feas[:, node] != 0

    def select(tables, dirty, kind, tid, pin, k_rand) -> int:
        nonlocal rebuilds
        score, _, feas = tables
        raws = score.view(n_pol, k, n)
        if dirty >= 0:
            # the dirty block's summaries for all K types
            before = Summaries(*(x.clone() for x in summ)) if shadow else None
            refresh_block(summ, tables, rank, dirty // BLOCK, slice(None),
                          cfg)
            if shadow:
                old, new = (column(shadow[0], shadow[2], dirty),
                            column(score, feas, dirty))
                shadow[0][:, dirty], shadow[2][:, dirty] = (score[:, dirty],
                                                            feas[:, dirty])
                on_refresh(dirty, old, new, tables, before,
                           Summaries(*(x.clone() for x in summ)))
        if index:
            # extrema drift: when the event type's current extrema left the
            # stored ones, rebuild its summary row under the current ones
            lo, hi = brmin[:, tid].min(-1).values, brmax[:, tid].max(-1).values
            if bool(((lo != slo[:, tid]) | (hi != shi[:, tid])).any()):
                total = _totals(raws[:, tid], feas[tid] != 0, lo, hi, cfg)
                bt[tid], br[tid], lane = block_reduce(
                    total.view(nblk, BLOCK), rank_blk)
                bn[tid] = offs + lane
                slo[:, tid], shi[:, tid] = lo, hi
                rebuilds += 1
        if kind != EV_CREATE:
            return -1
        if pin >= 0:
            return pin if pin < n and bool(feas[tid, pin]) else -1
        # selectHost over the N/128 block summaries
        valid = bt[tid] != -_INT_MAX
        best = torch.where(valid, bt[tid], -_INT_MAX).max()
        key = torch.where(valid & (bt[tid] == best), -br[tid], -_INT_MAX)
        c = int(key.argmax())
        return int(bn[tid, c]) if int(key[c]) != -_INT_MAX else -1

    rec = None
    if record is not None:
        from tpusim_torch.sim.records import PlainRecords

        rec = PlainRecords(record, cfg, tp, rank,
                           n if n_real is None else n_real, BLOCK)
    result = fe.plain_event_loop(state, pods, types, ev_kind, ev_pod, tp,
                                 tables, cfg, select, keep, key=key,
                                 faults=faults, start=start, record=rec)
    if rec is not None:
        keep["records"] = rec.result(rebuilds)
    if keep is not None:
        keep["summaries"] = summ
    stats = torch.tensor([0, 0, rebuilds], dtype=torch.int32,
                         device=rank.device)
    if faults is not None:
        return result[0], stats, result[1]
    return result, stats


def _summary_buffers(n: int, k: int, cfg: fe.ReplayConfig, device,
                     b: int = None) -> dict:
    """The blocked replays' summaries and "stats", zeroed ([b, ...] for b
    lanes)."""
    nblk, nn = n // BLOCK, max(len(_norm_index(cfg)), 1)
    lead = () if b is None else (b,)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=torch.int32, device=device)

    return dict(bt=zeros(k, nblk), br=zeros(k, nblk), bn=zeros(k, nblk),
                brmin=zeros(nn, k, nblk), brmax=zeros(nn, k, nblk),
                slo=zeros(nn, k), shi=zeros(nn, k), stats=zeros(3))


def prepare_replay_blocked(state: NodeState, pods: PodSpec, types: PodTypes,
                           ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                           tp: TypicalPods, rank: torch.Tensor, tables,
                           cfg: fe.ReplayConfig, key=None, start=None,
                           key_out: bool = False, record=None,
                           n_real: int = None) -> fe.Launch:
    """The `replay_blocked` launch over CUDA tensors: `replay`'s arguments
    and outputs (fused_engine.prepare_replay's `start`, `key_out`,
    `record` and `n_real` included), the summaries it builds and
    maintains, and "stats". With `record`, finish() returns (ReplayResult,
    stats, records.Records)."""
    check_blocked(state.num_nodes, cfg)
    summaries = _summary_buffers(state.num_nodes, types.num_types, cfg,
                                 rank.device)
    ready = fe.prepare_replay(state, pods, types, ev_kind, ev_pod, tp, rank,
                              tables, cfg, name="replay_blocked", key=key,
                              start=start, key_out=key_out, record=record,
                              n_real=n_real, **summaries)

    def finish():
        out = ready.finish()
        if record is None:
            return out, ready.tensors["stats"]
        return out[0], ready.tensors["stats"], out[1]

    return ready._replace(finish=finish)


def prepare_replay_blocked_faults(state: NodeState, pods: PodSpec,
                                  types: PodTypes, ev_kind: torch.Tensor,
                                  ev_pod: torch.Tensor, tp: TypicalPods,
                                  rank: torch.Tensor, tables,
                                  cfg: fe.ReplayConfig, faults) -> fe.Launch:
    """The `replay_blocked_faults` launch over CUDA tensors:
    prepare_replay_blocked's over the merged stream of the
    fault_lane.FaultLane `faults`. finish() returns (ReplayResult, stats,
    fault_lane.FaultOut)."""
    check_blocked(state.num_nodes, cfg)
    summaries = _summary_buffers(state.num_nodes, types.num_types, cfg,
                                 rank.device)
    ready = fe.prepare_replay_faults(state, pods, types, ev_kind, ev_pod, tp,
                                     rank, tables, cfg, faults,
                                     name="replay_blocked_faults",
                                     **summaries)

    def finish():
        out, fout = ready.finish()
        return out, ready.tensors["stats"], fout

    return ready._replace(finish=finish)


def replay_blocked(state: NodeState, pods: PodSpec, types: PodTypes,
                   ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                   tp: TypicalPods, rank: torch.Tensor, tables,
                   cfg: fe.ReplayConfig, key=None, start=None,
                   keep: dict = None, record=None, n_real: int = None):
    """Replay every event from `state` with the (score, sdev, feas) tables
    of `state` under `cfg`, selecting over 128-node block summaries: the
    `replay_blocked` CUDA kernel on CUDA tensors, plain_replay_blocked on
    CPU tensors. Returns (ReplayResult, stats i32[3]); inputs are left
    unchanged. The node axis is a whole number of blocks. `key`, `start`
    and `keep` are fused_engine.replay's (keep["summaries"] only from the
    plain version). The kernel trusts the events as `replay` does. With
    `record` (a records.RecordSpec; `n_real` the nodes before the padding)
    the record form runs (`replay_blocked_record`, its plain version on
    the CPU): keep (then required) gets "records", the records.Records."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay_blocked(state, pods, types, ev_kind, ev_pod, tp,
                                    rank, tables, cfg, keep=keep, key=key,
                                    start=start, record=record,
                                    n_real=n_real)
    ready = prepare_replay_blocked(
        state, pods, types, ev_kind, ev_pod, tp, rank, tables, cfg, key=key,
        start=start, key_out=keep is not None and key is not None,
        record=record, n_real=n_real)
    fe.launch(ready)
    if record is None:
        (replay_blocked_learned if cfg.learned
         else replay_blocked).launches += 1
        return fe.kept(ready, keep)
    (replay_blocked_learned_record if cfg.learned
     else replay_blocked_record).launches += 1
    out, stats, keep["records"] = fe.kept(ready, keep)
    return out, stats


def replay_blocked_faults(state: NodeState, pods: PodSpec, types: PodTypes,
                          ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                          tp: TypicalPods, rank: torch.Tensor, tables,
                          cfg: fe.ReplayConfig, faults):
    """replay_blocked over a merged stream of fault_lane.compile_fault_plan
    with the fault_lane.FaultLane `faults` (its carry and gcnt over the
    padded nodes): the `replay_blocked_faults` CUDA kernel on CUDA tensors,
    plain_replay_blocked(faults=) on CPU tensors. Returns (ReplayResult,
    stats i32[3], fault_lane.FaultOut)."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay_blocked(state, pods, types, ev_kind, ev_pod, tp,
                                    rank, tables, cfg, faults=faults)
    ready = prepare_replay_blocked_faults(state, pods, types, ev_kind, ev_pod,
                                          tp, rank, tables, cfg, faults)
    fe.launch(ready)
    (replay_blocked_learned_faults if cfg.learned
     else replay_blocked_faults).launches += 1
    return ready.finish()


def plain_replay_blocked_lanes(state: NodeState, types: PodTypes,
                               tp: TypicalPods, tables, cfg: fe.ReplayConfig,
                               lanes, keep: dict = None):
    """The plain version of the `replay_blocked_lanes` kernel:
    plain_replay_blocked lane by lane (fused_engine.Lane), each from
    `state` and the shared tables. Returns (ReplayResult, stats) a lane
    ((ReplayResult, stats, fault_lane.FaultOut) for lanes with faults: the
    plain version of `replay_blocked_lanes_faults`); with `keep`,
    keep["tables"] and keep["summaries"] hold each lane's."""
    outs, finals = [], {"tables": [], "summaries": []}
    for lane in lanes:
        kept = {}
        outs.append(plain_replay_blocked(
            state, lane.pods, fe._lane_types(types, lane), lane.ev_kind,
            lane.ev_pod, tp, lane.rank, tables, fe._lane_config(cfg, lane),
            keep=kept, faults=lane.faults))
        for name in finals:
            finals[name].append(kept[name])
    if keep is not None:
        keep.update(finals)
    return outs


def prepare_replay_blocked_lanes(state: NodeState, types: PodTypes,
                                 tp: TypicalPods, tables,
                                 cfg: fe.ReplayConfig, lanes) -> fe.Launch:
    """The `replay_blocked_lanes` launch over CUDA tensors: the lanes of
    fused_engine.prepare_replay_lanes, each with its own block summaries
    and "stats" ([B, ...] tensors). finish() returns (ReplayResult, stats)
    a lane."""
    check_blocked(state.num_nodes, cfg)
    summaries = _summary_buffers(state.num_nodes, types.num_types, cfg,
                                 state.cpu_left.device, len(lanes))
    ready = fe.prepare_replay_lanes(state, types, tp, tables, cfg, lanes,
                                    name="replay_blocked_lanes",
                                    lane_extra=summaries)
    stats = summaries["stats"]
    return ready._replace(finish=lambda: [
        (out, stats[i]) for i, out in enumerate(ready.finish())])


def prepare_replay_blocked_lanes_faults(state: NodeState, types: PodTypes,
                                        tp: TypicalPods, tables,
                                        cfg: fe.ReplayConfig,
                                        lanes) -> fe.Launch:
    """The `replay_blocked_lanes_faults` launch over CUDA tensors:
    prepare_replay_blocked_lanes' over lanes with merged streams and their
    Lane.faults. finish() returns (ReplayResult, stats,
    fault_lane.FaultOut) a lane."""
    check_blocked(state.num_nodes, cfg)
    summaries = _summary_buffers(state.num_nodes, types.num_types, cfg,
                                 state.cpu_left.device, len(lanes))
    ready = fe.prepare_replay_lanes_faults(
        state, types, tp, tables, cfg, lanes,
        name="replay_blocked_lanes_faults", lane_extra=summaries)
    stats = summaries["stats"]
    return ready._replace(finish=lambda: [
        (out, stats[i], fout)
        for i, (out, fout) in enumerate(ready.finish())])


def replay_blocked_lanes(state: NodeState, types: PodTypes, tp: TypicalPods,
                         tables, cfg: fe.ReplayConfig, lanes):
    """replay_blocked over B lanes of `cfg`'s family (fused_engine.Lane):
    the `replay_blocked_lanes` CUDA kernel on CUDA tensors (a block a lane,
    one launch), plain_replay_blocked_lanes on CPU tensors. Returns
    (ReplayResult, stats i32[3]) a lane; the inputs are left unchanged."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay_blocked_lanes(state, types, tp, tables, cfg,
                                          lanes)
    ready = prepare_replay_blocked_lanes(state, types, tp, tables, cfg, lanes)
    fe.launch(ready)
    (replay_blocked_lanes_learned if cfg.learned
     else replay_blocked_lanes).launches += 1
    return ready.finish()


def replay_blocked_lanes_faults(state: NodeState, types: PodTypes,
                                tp: TypicalPods, tables,
                                cfg: fe.ReplayConfig, lanes):
    """replay_blocked_lanes over lanes with merged streams and their
    Lane.faults (carries over the padded nodes): the
    `replay_blocked_lanes_faults` CUDA kernel on CUDA tensors,
    plain_replay_blocked_lanes on CPU tensors. Returns (ReplayResult,
    stats, fault_lane.FaultOut) a lane."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay_blocked_lanes(state, types, tp, tables, cfg,
                                          lanes)
    ready = prepare_replay_blocked_lanes_faults(state, types, tp, tables,
                                                cfg, lanes)
    fe.launch(ready)
    (replay_blocked_lanes_learned_faults if cfg.learned
     else replay_blocked_lanes_faults).launches += 1
    return ready.finish()


def replay_blocked_record(*args, **kwargs):
    """`replay_blocked` with its `record` (a records.RecordSpec): the
    record form's launch count is this function's."""
    return replay_blocked(*args, **kwargs)


# the learned instantiations (kernels/replay_blocked_learned.cu,
# replay_learned_records.cu, replay_learned_faults.cu), which replay_blocked,
# replay_blocked_lanes and their fault forms launch for a learned
# configuration, counted here
def replay_blocked_learned(*args, **kwargs):
    """replay_blocked of a learned configuration."""
    return replay_blocked(*args, **kwargs)


def replay_blocked_learned_record(*args, **kwargs):
    """replay_blocked_record of a learned configuration."""
    return replay_blocked(*args, **kwargs)


def replay_blocked_lanes_learned(*args, **kwargs):
    """replay_blocked_lanes of a learned configuration."""
    return replay_blocked_lanes(*args, **kwargs)


def replay_blocked_learned_faults(*args, **kwargs):
    """replay_blocked_faults of a learned configuration."""
    return replay_blocked_faults(*args, **kwargs)


def replay_blocked_lanes_learned_faults(*args, **kwargs):
    """replay_blocked_lanes_faults of a learned configuration."""
    return replay_blocked_lanes_faults(*args, **kwargs)


replay_blocked.launches = 0
replay_blocked_record.launches = 0
replay_blocked_lanes.launches = 0
replay_blocked_faults.launches = 0
replay_blocked_lanes_faults.launches = 0
for _fn in (replay_blocked_learned, replay_blocked_learned_record,
            replay_blocked_lanes_learned, replay_blocked_learned_faults,
            replay_blocked_lanes_learned_faults):
    _fn.launches = 0
fe.KERNEL_WRAPPERS.extend([replay_blocked, replay_blocked_record,
                           replay_blocked_lanes,
                           replay_blocked_faults, replay_blocked_lanes_faults,
                           replay_blocked_learned,
                           replay_blocked_learned_record,
                           replay_blocked_lanes_learned,
                           replay_blocked_learned_faults,
                           replay_blocked_lanes_learned_faults])


def make_blocked_replay(policies: Sequence[Tuple[str, int]], gpu_sel: str,
                        device="cuda", dim_ext: str = "share",
                        norm: str = "max"):
    """The blocked replayer for a policy config, the counterpart of
    make_pallas_replay(..., residency="hbm"): the call signature of
    make_fused_replay's replayer, returning (ReplayResult, stats i32[3]).
    It pads the node axis to whole blocks, builds the tables of the padded
    state (`init_tables`), replays (`replay_blocked`) and trims the final
    state back to the cluster's nodes."""
    cfg = fe.make_config(policies, gpu_sel, dim_ext, norm)
    check_blocked(0, cfg)  # a randomized configuration runs flat only
    device = torch.device(device)

    def run(state, pods, types, ev_kind, ev_pod, tp, key=None,
            tiebreak_rank=None):
        state, pods, types, ev_kind, ev_pod, tp, rank = fe.device_inputs(
            device, state, pods, types, ev_kind, ev_pod, tp, tiebreak_rank)
        padded, rank = pad_nodes(state, rank, BLOCK)
        tables = fe.init_tables(padded, types, tp, cfg)
        out, stats = replay_blocked(padded, pods, types, ev_kind, ev_pod, tp,
                                    rank, tables, cfg)
        return out._replace(state=trim_nodes(out.state, state.num_nodes)), \
            stats

    run.config = cfg
    return run
