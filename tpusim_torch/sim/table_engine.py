"""Distinct pod types of a trace and the replay's chunk surface
(counterpart of PodTypes, build_pod_types, pad_pod_types,
resolve_block_size and make_table_replay's carry surface in
tpusim/sim/table_engine.py).

The replay keeps [K, N] score, share-device and feasibility tables over the
K distinct (cpu, mem, gpu_milli, gpu_num, gpu_mask) types of the trace. Share-GPU
types come first ([0, Ks)), whole-GPU and CPU-only types after ([Ks, K)), so
the FGD branch of a type is known from its index.

The chunk surface (make_table_replay) cuts one replay into segments that
each launch the CUDA replay kernels (on CPU tensors, their plain versions):

    carry = replay.init_carry(state, pods, types, tp, key, rank)
    carry, (nodes, devs) = replay.run_chunk(carry, pods, types,
                                            ev_kind_seg, ev_pod_seg, tp,
                                            rank)                 # x S
    state, placed, masks, failed = replay.finish(carry)

equals one replay(...) over the concatenated segments at every cut point,
with the carry taken to the host and back between chunks (carry_arrays,
carry_from_arrays: what a checkpoint file does). The carry is the state
between two events: the node state, the placements, device masks and
failed flags so far, the arrived CPU and GPU milli, the event key chain's
key after the events consumed, and the cursor. The tables are not carried:
they are a function of the state, and each chunk starts with one
init_tables launch over it (or, at event 0, the tables a caller already
has, such as a table-cache hit). The JAX carry's software-pipeline register
(`pend`, `dirty`) has no counterpart, for the kernels commit each event
inside it. The obs counters (`ctr`, tpusim_torch.obs.counters) ride the
carry as tpusim's do: a recording replay (make_table_replay's decisions,
series_every, heartbeat_every) launches the kernels' record forms, which
add them on the card and return each chunk's decision and series rows
(sim/records.py); a replay that records nothing adds the counts of each
chunk's event outputs. Either way they survive a checkpoint. A
FlatTableCarry runs `replay`; a BlockedTableCarry runs `replay_blocked` over
the nodes padded to whole 128-node blocks, whose block summaries the kernel
builds from the tables at each chunk's start, as it does at event 0 of a
whole replay. Results equal either way, and equal tpusim's table engine.
The port's carry is its own layout; its checkpoint files do not load in
tpusim, nor tpusim's here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpusim_torch.types import NodeState, PodSpec

# Below this node count tpusim's automatic block size keeps the flat
# select (resolve_block_size; tpusim/sim/table_engine.py:72)
BLOCKED_MIN_NODES = 8192


class PodTypes(NamedTuple):
    share: PodSpec  # [Ks] tensors, pinned == -1
    whole: PodSpec  # [Kw] tensors, pinned == -1
    type_id: torch.Tensor  # i32[P] pod -> global type index

    @property
    def num_share(self) -> int:
        return self.share.cpu.shape[0]

    @property
    def num_types(self) -> int:
        return self.share.cpu.shape[0] + self.whole.cpu.shape[0]

    def stacked(self) -> PodSpec:
        """All K types as one PodSpec, share types first."""
        return PodSpec(*(torch.cat([a, b]) for a, b in zip(self.share, self.whole)))


def _to_specs(uniq: np.ndarray, device) -> PodSpec:
    k = uniq.shape[0]
    cols = [torch.as_tensor(uniq[:, j].astype(np.int32), device=device)
            for j in range(5)]
    return PodSpec(*cols, torch.full((k,), -1, dtype=torch.int32, device=device))


def build_pod_types(specs: PodSpec) -> PodTypes:
    """Host-side dedup of pod resource specs. The pinned node is not part of
    the type: pinning is a per-event mask, not something the tables see."""
    device = specs.cpu.device
    cols = np.stack(
        [a.cpu().numpy() for a in
         (specs.cpu, specs.mem, specs.gpu_milli, specs.gpu_num, specs.gpu_mask)],
        axis=1,
    )
    uniq, inv = np.unique(cols, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    is_share = (uniq[:, 3] == 1) & (uniq[:, 2] > 0) & (uniq[:, 2] < 1000)
    order = np.concatenate([np.flatnonzero(is_share), np.flatnonzero(~is_share)])
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return PodTypes(
        _to_specs(uniq[is_share], device),
        _to_specs(uniq[~is_share], device),
        torch.as_tensor(rank[inv].astype(np.int32), device=device),
    )


def pad_pod_types(types: PodTypes, multiple: int = 16) -> PodTypes:
    """Pad each type group to a multiple of `multiple` with inert types that
    request 2^30 milli-CPU (infeasible on any node) and that no pod
    references."""

    def pad_group(spec: PodSpec, share: bool) -> PodSpec:
        k = spec.cpu.shape[0]
        pad = -(-k // multiple) * multiple - k
        if pad == 0:  # includes k == 0
            return spec

        def fill(a, value):
            return torch.cat([a, a.new_full((pad,), value)])

        gpu = 1 if share else 0
        return PodSpec(
            fill(spec.cpu, 2**30), fill(spec.mem, 2**30),
            fill(spec.gpu_milli, gpu), fill(spec.gpu_num, gpu),
            fill(spec.gpu_mask, 0), fill(spec.pinned, -1),
        )

    ks = types.num_share
    share2 = pad_group(types.share, True)
    ks2 = share2.cpu.shape[0]
    tid = torch.where(types.type_id >= ks, types.type_id + (ks2 - ks),
                      types.type_id)
    return PodTypes(share2, pad_group(types.whole, False), tid)


def resolve_block_size(block_size: int, num_nodes: int, num_types: int) -> int:
    """tpusim's static block-size decision for its blocked table engine
    (tpusim/sim/table_engine.py:75): block_size > 0 forces that size
    (at most num_nodes), < 0 the flat path (returns 0), and 0 picks ~sqrt(
    3 N / K) rounded up to a power of two in [16, 1024], flat below
    BLOCKED_MIN_NODES. The port's replays take one width only: see
    check_block_size and table_tier."""
    if block_size < 0:
        return 0
    if block_size > 0:
        return min(block_size, num_nodes)
    if num_nodes < BLOCKED_MIN_NODES:
        return 0
    b = int(math.sqrt(3.0 * num_nodes / max(num_types, 1)))
    b = max(16, min(1024, 1 << max(b - 1, 1).bit_length()))
    return min(b, num_nodes)


def check_block_size(block_size: int) -> None:
    """SimulatorConfig.block_size as the port runs it: -1 (any negative)
    the flat `replay`, 0 the residency rule, BLOCK (128) `replay_blocked`,
    whose width is the kernel's kBlock. Any other width raises."""
    from tpusim_torch.sim.residency import BLOCK

    if block_size > 0 and block_size != BLOCK:
        raise NotImplementedError(
            f"block_size {block_size}: the port's blocked replay runs "
            f"{BLOCK}-node blocks only; other widths need ROADMAP queue 1, "
            "item 6 (block widths other than 128)")


def table_tier(block_size: int, setting: str, randomized: bool, n: int,
               k: int, num_pol: int, device) -> str:
    """The tier a replay runs in ("vmem": the flat `replay`, "hbm":
    `replay_blocked`): a randomized configuration flat; else block_size
    -1 flat, 128 blocked, and 0 residency.replay_tier under `setting`
    against the L2 cache of the card `device` names (none on the CPU)."""
    from tpusim_torch.sim import residency

    check_block_size(block_size)
    if randomized or block_size < 0:
        return "vmem"
    if block_size > 0:
        return "hbm"
    device = torch.device(device)
    l2 = (torch.cuda.get_device_properties(device).L2_cache_size
          if device.type == "cuda" else None)
    return residency.replay_tier(setting, randomized, n, k, num_pol, l2)


class FlatTableCarry(NamedTuple):
    """The replay's state between two events (module docstring); the next
    chunk runs the flat `replay`. Every leaf but `tables` is an exact dtype
    and goes into a checkpoint (carry_arrays)."""

    state: NodeState
    placed: torch.Tensor  # i32[P], -1 = not placed
    masks: torch.Tensor  # bool[P, 8]
    failed: torch.Tensor  # bool[P]
    arr_cpu: torch.Tensor  # i32[] arrived milli-CPU so far
    arr_gpu: torch.Tensor  # i32[] arrived milli-GPU so far
    key: torch.Tensor  # i32[2]: the bits of the chain's key after `cursor`
    ctr: torch.Tensor  # i32[6] obs counters after `cursor` (obs.counters)
    cursor: int  # events consumed
    # the tables of `state` where a caller already has them (event 0 of a
    # table-cache hit), else None; never in a checkpoint
    tables: Optional[tuple] = None


class BlockedTableCarry(NamedTuple):
    """FlatTableCarry's leaves; the next chunk runs `replay_blocked` over
    the state padded to whole 128-node blocks (`tables`, where given, are
    those of the padded state)."""

    state: NodeState
    placed: torch.Tensor
    masks: torch.Tensor
    failed: torch.Tensor
    arr_cpu: torch.Tensor
    arr_gpu: torch.Tensor
    key: torch.Tensor
    ctr: torch.Tensor
    cursor: int
    tables: Optional[tuple] = None


# the leaves a checkpoint holds, with the state's fields as "state.<name>"
CARRY_LEAVES = ("placed", "masks", "failed", "arr_cpu", "arr_gpu", "key",
                "ctr")


def carry_arrays(carry, extra: dict = None) -> dict:
    """A carry as {leaf name: numpy array} on the host, the cursor under
    "cursor", with the tensors of `extra` under their names: one fetch."""
    from tpusim_torch.sim.fetch import device_fetch

    extra = extra or {}
    host = device_fetch((carry.state, tuple(getattr(carry, f)
                                            for f in CARRY_LEAVES),
                         tuple(extra.values())))
    out = {f"state.{name}": x.numpy()
           for name, x in host[0]._asdict().items()}
    out.update({f: x.numpy() for f, x in zip(CARRY_LEAVES, host[1])})
    out.update({name: x.numpy() for name, x in zip(extra, host[2])})
    out["key"] = out["key"].view(np.uint32)
    out["cursor"] = np.int64(carry.cursor)
    return out


def carry_layout(state: NodeState, num_pods: int) -> dict:
    """{leaf name: (shape, numpy dtype)} of the carries of a replay from
    `state` over `num_pods` pods (what a loaded checkpoint must match)."""
    out = {f"state.{name}": (tuple(x.shape), np.dtype(str(x.dtype)[6:]))
           for name, x in state._asdict().items()}
    ndev = state.gpu_left.shape[1]
    out.update(placed=((num_pods,), np.dtype(np.int32)),
               masks=((num_pods, ndev), np.dtype(bool)),
               failed=((num_pods,), np.dtype(bool)),
               arr_cpu=((), np.dtype(np.int32)),
               arr_gpu=((), np.dtype(np.int32)),
               key=((2,), np.dtype(np.uint32)),
               ctr=((6,), np.dtype(np.int32)),
               cursor=((), np.dtype(np.int64)))
    return out


def check_carry_arrays(arrays: dict, layout: dict) -> None:
    """Raise ValueError unless `arrays` has every leaf of `layout` with its
    shape and dtype."""
    for name, (shape, dtype) in layout.items():
        if name not in arrays:
            raise ValueError(f"carry leaf {name} missing")
        a = arrays[name]
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(f"carry layout mismatch at {name}: "
                             f"{a.shape} {a.dtype}, want {shape} {dtype}")


def carry_from_arrays(cls, arrays: dict, device):
    """The carry of class `cls` that carry_arrays wrote, on `device`."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = NodeState(*(t(arrays[f"state.{name}"])
                        for name in NodeState._fields))
    leaves = {f: t(arrays[f]) for f in CARRY_LEAVES if f != "key"}
    key = t(np.asarray(arrays["key"], np.uint32).view(np.int32))
    return cls(state, key=key, cursor=int(arrays["cursor"]), **leaves)


def make_table_replay(policies, gpu_sel: str = "best", block_size: int = 0,
                      dim_ext: str = "share", norm: str = "max",
                      residency: str = "auto", decisions: bool = False,
                      series_every: int = 0, heartbeat_every: int = 0):
    """The chunk surface for a policy config (the counterpart of tpusim's
    make_table_replay, policies as [(name, weight)]): `replay(state, pods,
    types, ev_kind, ev_pod, tp, key, tiebreak_rank=None, tables=None)`
    returns a ReplayResult, and `replay.init_carry`, `replay.run_chunk`
    and `replay.finish` cut it into chunks (module docstring). Inputs are
    tensors on one device: the CUDA kernels run on a CUDA device, their
    plain versions on the CPU, and the caller checks the events (as
    make_fused_replay's replayer does). `block_size` and `residency`
    (table_residency) pick the kernel (table_tier) when init_carry sees
    the shape; a randomized configuration always runs the flat `replay`.
    `tables` are the (score, sdev, feas) tables of `state` (of the padded
    state where the blocked replay runs) where the caller has them: the
    first chunk then launches no init_tables. After each run_chunk,
    `replay.last_stats` holds the blocked chunk's [waits, starts,
    rebuilds] (None after a flat one).

    With `decisions`, `series_every` > 0 or `heartbeat_every` > 0 (tpusim's
    recording builds) each chunk launches the kernels' record forms and
    run_chunk returns (carry', (event_node, event_dev, records.Records)),
    the chunk's decision and sample rows in the Records; `replay` returns
    them as its ReplayResult's decisions and series (records.
    decision_rows, sample_rows: the caller's policy order)."""
    from tpusim_torch.parallel.sharding import pad_nodes, trim_nodes
    from tpusim_torch.policies.base import wrap_i32
    from tpusim_torch.sim import fused_engine as fe
    from tpusim_torch.sim import hbm_engine
    from tpusim_torch.sim.engine import EV_CREATE, ReplayResult
    from tpusim_torch.sim.residency import BLOCK

    from tpusim_torch.obs.counters import counters_from_events, zero_counters
    from tpusim_torch.sim import records as rec

    check_block_size(block_size)
    cfg = fe.make_config(policies, gpu_sel, dim_ext, norm)
    recording = bool(decisions or series_every or heartbeat_every)

    def rank_of(state, tiebreak_rank):
        if tiebreak_rank is None:
            return torch.arange(state.num_nodes, dtype=torch.int32,
                                device=state.cpu_left.device)
        return tiebreak_rank

    def tier_of(state, types) -> str:
        return table_tier(block_size, residency, cfg.randomized,
                          state.num_nodes, types.num_types, cfg.num_tables,
                          state.cpu_left.device)

    def init_carry(state, pods, types, tp, key, tiebreak_rank=None,
                   tables=None):
        """The carry at event 0: nothing placed, the root `key`."""
        dev = state.cpu_left.device
        p = pods.cpu.shape[0]
        cls = (BlockedTableCarry if tier_of(state, types) == "hbm"
               else FlatTableCarry)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return cls(state,
                   torch.full((p,), -1, dtype=torch.int32, device=dev),
                   torch.zeros((p, state.gpu_left.shape[1]), dtype=torch.bool,
                               device=dev),
                   torch.zeros(p, dtype=torch.bool, device=dev),
                   zero, zero.clone(), fe.key_tensor(fe.root_key(key, cfg)
                                                     or (0, 0), dev),
                   zero_counters(dev), 0, tables)

    def run_chunk(carry, pods, types, ev_kind, ev_pod, tp,
                  tiebreak_rank=None):
        """Advance `carry` over the events ev_kind/ev_pod (tensors on the
        carry's device): one init_tables launch over the carry's state
        (unless it holds tables) and one launch of its replay kernel,
        started from the carry's placements and key. Returns (carry',
        (event_node, event_dev)) of these events."""
        state = carry.state
        n = state.num_nodes
        rank = rank_of(state, tiebreak_rank)
        blocked = isinstance(carry, BlockedTableCarry)
        if blocked:
            state, rank = pad_nodes(state, rank, BLOCK)
        tables = carry.tables
        if tables is None:
            tables = fe.init_tables(state, types, tp, cfg)
        start = (carry.placed, fe.mask_bits(carry.masks),
                 carry.failed.to(torch.int32))
        keep = {}
        spec = (rec.RecordSpec(bool(decisions), int(series_every),
                               int(heartbeat_every), carry.ctr, carry.cursor)
                if recording else None)
        if blocked:
            out, stats = hbm_engine.replay_blocked(
                state, pods, types, ev_kind, ev_pod, tp, rank, tables, cfg,
                key=carry.key, start=start, keep=keep, record=spec,
                n_real=n)
            out = out._replace(state=trim_nodes(out.state, n))
            replay.last_stats = stats
        else:
            out = fe.replay(state, pods, types, ev_kind, ev_pod, tp, rank,
                            tables, cfg, key=carry.key, start=start,
                            keep=keep, record=spec)
            replay.last_stats = None
        if recording:
            records = keep["records"]
            ctr = records.ctr
        else:
            ctr = carry.ctr + counters_from_events(
                ev_kind, out.event_node,
                0 if replay.last_stats is None else replay.last_stats[2])
        creates = ev_kind == EV_CREATE
        arrived = [
            wrap_i32(arr.to(torch.int64) + torch.where(
                creates, col[ev_pod.long()].to(torch.int64), 0).sum())
            for arr, col in ((carry.arr_cpu, pods.cpu),
                             (carry.arr_gpu, pods.gpu_milli * pods.gpu_num))]
        nxt = type(carry)(out.state, out.placed_node, out.dev_mask,
                          out.ever_failed, *arrived, keep["key"], ctr,
                          carry.cursor + int(ev_kind.shape[0]))
        if recording:
            return nxt, (out.event_node, out.event_dev, records)
        return nxt, (out.event_node, out.event_dev)

    def finish(carry):
        """(state, placed, masks, failed) of a carry."""
        return carry.state, carry.placed, carry.masks, carry.failed

    def replay(state, pods, types, ev_kind, ev_pod, tp, key,
               tiebreak_rank=None, tables=None) -> ReplayResult:
        carry = init_carry(state, pods, types, tp, key, tiebreak_rank,
                           tables)
        carry, ys = run_chunk(carry, pods, types, ev_kind, ev_pod, tp,
                              tiebreak_rank)
        st, placed, masks, failed = finish(carry)
        decs = sers = None
        if recording:
            decs, sers = rows_of(ys[2])
        return ReplayResult(st, placed, masks, failed, None, ys[0], ys[1],
                            carry.ctr, decs, sers)

    def rows_of(records):
        """(DecisionRecord, SeriesSample) of a chunk's Records, numpy on
        the host in the caller's policy order (None where not recorded)."""
        pi = len(cfg.fam)
        dec = (None if records.dec is None else rec.decision_rows(
            records.dec.cpu().numpy(), pi, cfg.order))
        ser = (None if records.ser is None else rec.sample_rows(
            records.ser.cpu().numpy(), pi, cfg.order))
        return dec, ser

    replay.init_carry = init_carry
    replay.run_chunk = run_chunk
    replay.finish = finish
    replay.tier_of = tier_of
    replay.rows_of = rows_of
    replay.recording = recording
    replay.last_stats = None
    return replay
