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
summaries for all K types under the stored extrema. A drift check compares
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


def plain_replay_blocked(state: NodeState, pods: PodSpec, types: PodTypes,
                         ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                         tp: TypicalPods, rank: torch.Tensor, tables,
                         cfg: fe.ReplayConfig):
    """The plain version of the `replay_blocked` kernel: an event loop over
    tensor ops, returning (ReplayResult, stats i32[3]). The node axis of
    `state`, `rank` and the (score, sdev, feas) `tables` of the initial
    state is a whole number of 128-node blocks."""
    n, k = state.num_nodes, types.num_types
    if n % BLOCK:
        raise ValueError(f"{n} nodes: the blocked replay takes whole "
                         f"{BLOCK}-node blocks (pad_nodes)")
    nblk, n_pol = n // BLOCK, len(cfg.policies)
    index = _norm_index(cfg)
    bt, br, bn, brmin, brmax, slo, shi = plain_init_summaries(tables, rank,
                                                              cfg)
    rank_blk = rank.view(nblk, BLOCK)
    offs = torch.arange(nblk, dtype=torch.int32, device=rank.device) * BLOCK
    rebuilds = 0

    def select(tables, dirty, kind, tid, pin) -> int:
        nonlocal rebuilds
        score, _, feas = tables
        raws = score.view(n_pol, k, n)
        if dirty >= 0:
            # the dirty block's summaries for all K types
            c = dirty // BLOCK
            cols = slice(c * BLOCK, (c + 1) * BLOCK)
            raw_blk, feas_blk = raws[:, :, cols], feas[:, cols] != 0
            if index:
                brmin[:, :, c], brmax[:, :, c] = _block_extrema(
                    raw_blk, feas_blk, index)
            total = _totals(raw_blk, feas_blk, slo, shi, cfg)
            bt[:, c], br[:, c], lane = block_reduce(total, rank_blk[c])
            bn[:, c] = c * BLOCK + lane
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

    result = fe.plain_event_loop(state, pods, types, ev_kind, ev_pod, tp,
                                 tables, cfg, select)
    stats = torch.tensor([0, 0, rebuilds], dtype=torch.int32,
                         device=rank.device)
    return result, stats


def prepare_replay_blocked(state: NodeState, pods: PodSpec, types: PodTypes,
                           ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                           tp: TypicalPods, rank: torch.Tensor, tables,
                           cfg: fe.ReplayConfig) -> fe.Launch:
    """The `replay_blocked` launch over CUDA tensors: `replay`'s arguments
    and outputs, the summaries it builds and maintains, and "stats"."""
    n, k = state.num_nodes, types.num_types
    if n % BLOCK:
        raise ValueError(f"{n} nodes: the blocked replay takes whole "
                         f"{BLOCK}-node blocks (pad_nodes)")
    nblk, nn = n // BLOCK, max(len(_norm_index(cfg)), 1)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=rank.device)

    summaries = dict(bt=zeros(k, nblk), br=zeros(k, nblk), bn=zeros(k, nblk),
                     brmin=zeros(nn, k, nblk), brmax=zeros(nn, k, nblk),
                     slo=zeros(nn, k), shi=zeros(nn, k), stats=zeros(3))
    ready = fe.prepare_replay(state, pods, types, ev_kind, ev_pod, tp, rank,
                              tables, cfg, name="replay_blocked", **summaries)
    return ready._replace(
        finish=lambda: (ready.finish(), ready.tensors["stats"]))


def replay_blocked(state: NodeState, pods: PodSpec, types: PodTypes,
                   ev_kind: torch.Tensor, ev_pod: torch.Tensor,
                   tp: TypicalPods, rank: torch.Tensor, tables,
                   cfg: fe.ReplayConfig):
    """Replay every event from `state` with the (score, sdev, feas) tables
    of `state` under `cfg`, selecting over 128-node block summaries: the
    `replay_blocked` CUDA kernel on CUDA tensors, plain_replay_blocked on
    CPU tensors. Returns (ReplayResult, stats i32[3]); inputs are left
    unchanged. The node axis is a whole number of blocks. The kernel
    trusts the events as `replay` does."""
    if state.cpu_left.device.type == "cpu":
        return plain_replay_blocked(state, pods, types, ev_kind, ev_pod, tp,
                                    rank, tables, cfg)
    ready = prepare_replay_blocked(state, pods, types, ev_kind, ev_pod, tp,
                                   rank, tables, cfg)
    fe.launch(ready)
    replay_blocked.launches += 1
    return ready.finish()


replay_blocked.launches = 0
fe.KERNEL_WRAPPERS.append(replay_blocked)


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
