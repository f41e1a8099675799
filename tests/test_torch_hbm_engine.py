"""The port's blocked replay (tpusim_torch.sim.hbm_engine, the counterpart
of the JAX package's HBM-residency kernel) against the JAX package, with
zero tolerance: plain_replay_blocked must equal tpusim's blocked table
engine at block_size=128 (make_table_replay, the reference's own pin for
that kernel) in placements, device masks, failure flags, per-event
telemetry and final state, and its rebuild count (stats[2]) must equal the
engine's counters[5]. Also: the port's flat plain replay and pad_nodes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import random_cluster, random_pods
from tests.test_table_engine import _events_with_deletes
from tests.test_torch_fused_engine import _assert_replays_equal
from tests.test_torch_types_trace import (
    assert_tree_equal,
    port_specs,
    port_state,
    port_typical,
    port_types,
)
from tpusim.parallel.sharding import pad_nodes as jpad_nodes
from tpusim.policies import make_policy
from tpusim.sim.table_engine import build_pod_types, make_table_replay
from tpusim_torch.parallel.sharding import pad_nodes, trim_nodes
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he

# (policies, gpu_sel, dim_ext, norm, seed, nodes): no node count is a
# multiple of 128, so every case replays with a padded last block
CASES = [
    ([("FGDScore", 1000)], "FGDScore", "share", "max", 61, 300),
    ([("FGDScore", 1000)], "best", "share", "max", 62, 260),
    ([("FGDScore", 1000)], "worst", "share", "max", 63, 400),
    ([("BestFitScore", 1000)], "best", "share", "max", 64, 300),
    ([("PWRScore", 1000)], "PWRScore", "share", "max", 65, 520),
    ([("PWRScore", 500), ("FGDScore", 500)], "FGDScore", "share", "max", 66,
     300),
    ([("GpuPackingScore", 1000)], "best", "share", "max", 67, 300),
    ([("GpuClusteringScore", 1000)], "best", "share", "max", 68, 300),
    ([("DotProductScore", 1000)], "DotProductScore", "divide", "node", 69,
     300),
    # 17 blocks, more than the CUDA kernel's 16 warps: the normalised rows
    # rebuild summary rows of several blocks a warp
    ([("BestFitScore", 1000)], "best", "share", "max", 70, 2100),
    ([("PWRScore", 500), ("FGDScore", 500)], "FGDScore", "share", "max", 73,
     2100),
]


def _case_id(case):
    policies, gpu_sel, dim_ext, norm, _, n = case
    names = "+".join(f"{name}{w}" for name, w in policies)
    return f"{names}-{gpu_sel}-{dim_ext}-{norm}-n{n}"


def _random_case(seed, num_nodes, num_pods=150):
    """A seeded cluster, pods with create/delete events (~200 events) and
    four pinned pods, one to a node of the padded last block."""
    rng = np.random.default_rng(seed)
    jstate, jtp = random_cluster(rng, num_nodes=num_nodes)
    jpods = random_pods(rng, num_pods=num_pods)
    pin = np.full(num_pods, -1, np.int32)
    pin[[3, 40, 41, 90]] = [5, 130, 131, num_nodes - 1]
    jpods = jpods._replace(pinned=jnp.asarray(pin))
    ev_kind, ev_pod = _events_with_deletes(num_pods, rng)
    rank = jnp.asarray(rng.permutation(num_nodes).astype(np.int32))
    return jstate, jtp, jpods, ev_kind, ev_pod, rank


def _port_args(jstate, jtp, jpods, ev_kind, ev_pod, rank):
    """The make_*_replay arguments of a JAX case, as the port's tensors."""
    return (port_state(jstate), port_specs(jpods),
            port_types(build_pod_types(jpods)),
            torch.as_tensor(np.array(ev_kind)),
            torch.as_tensor(np.array(ev_pod)), port_typical(jtp), None,
            torch.as_tensor(np.array(rank)))


@functools.lru_cache(maxsize=None)
def _jax_replay(policies, gpu_sel, dim_ext, norm):
    """tpusim's blocked table engine for a config, one object per config so
    that cases of the same shapes share its compiled replay."""
    return make_table_replay(
        [(make_policy(name, dim_ext, norm), w) for name, w in policies],
        gpu_sel=gpu_sel, block_size=128)


def _both(policies, gpu_sel, dim_ext, norm, case):
    """(port result, port stats, JAX blocked-engine result) of one case."""
    jstate, jtp, jpods, ev_kind, ev_pod, rank = case
    key = tuple(map(tuple, policies))
    want = _jax_replay(key, gpu_sel, dim_ext, norm)(
        jstate, jpods, build_pod_types(jpods), ev_kind, ev_pod, jtp,
        jax.random.PRNGKey(3), rank)
    got, stats = he.make_blocked_replay(policies, gpu_sel, "cpu", dim_ext,
                                        norm)(*_port_args(*case))
    return got, stats, want


def _assert_matches_engine(got, stats, want):
    _assert_replays_equal(got, want)
    counters = np.asarray(want.counters)
    assert stats.tolist() == [0, 0, int(counters[5])], (stats, counters)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_blocked_matches_blocked_engine(case):
    policies, gpu_sel, dim_ext, norm, seed, n = case
    got, stats, want = _both(policies, gpu_sel, dim_ext, norm,
                             _random_case(seed, n))
    _assert_matches_engine(got, stats, want)
    assert int((got.event_node >= 0).sum()) > 100


def _edge_case(name):
    """Traces for the blocked layout's boundaries, on 200 nodes (two
    blocks, the second padded), from one set of 12 pods: four tiny CPU-only
    pods pinned to nodes 3 and 7 (block 0), 140 (block 1) and 9 (block 0
    again), and eight share-GPU pods. Consecutive pinned pods in the same
    block, a single event, a first event that is a skip, and share pods
    that FGD packs, so the winner lies in the block the previous create
    refreshed. All but the single event have 12 events, so they share one
    compiled JAX replay."""
    rng = np.random.default_rng(17)
    jstate, jtp = random_cluster(rng, num_nodes=200)
    jpods = random_pods(rng, num_pods=12)
    small = np.arange(12) < 4
    jpods = jpods._replace(
        cpu=jnp.full(12, 1000, jnp.int32),
        mem=jnp.where(small, 512, 1024).astype(jnp.int32),
        gpu_milli=jnp.where(small, 0, 250).astype(jnp.int32),
        gpu_num=jnp.where(small, 0, 1).astype(jnp.int32),
        gpu_mask=jnp.zeros(12, jnp.int32),
        pinned=jnp.asarray(np.where(small, [3, 7, 140, 9] + [0] * 8, -1),
                           jnp.int32))
    rank = jnp.asarray(rng.permutation(200).astype(np.int32))
    kinds, idxs = {
        # a delete re-touches the block it freed
        "same_block_twice": ([0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0],
                             [0, 1, 2, 3, 1, 4, 5, 0, 6, 7, 8, 9]),
        "single_event": ([0], [4]),
        "first_event_skip": ([2, 0, 0, 2, 0, 1, 0, 0, 0, 1, 0, 0],
                             [4, 4, 5, 6, 7, 5, 8, 9, 10, 4, 11, 0]),
        "winner_in_dirty_block": ([0] * 12, list(range(4, 12)) + [0, 1, 2, 3]),
    }[name]
    return (jstate, jtp, jpods, jnp.asarray(kinds, jnp.int32),
            jnp.asarray(idxs, jnp.int32), rank)


@pytest.mark.parametrize("name", ["same_block_twice", "single_event",
                                  "first_event_skip", "winner_in_dirty_block"])
def test_blocked_edge_cases_match_blocked_engine(name):
    case = _edge_case(name)
    got, stats, want = _both([("FGDScore", 1000)], "FGDScore", "share",
                             "max", case)
    _assert_matches_engine(got, stats, want)
    nodes = got.event_node.tolist()
    if name == "same_block_twice":
        assert nodes[:4] == [3, 7, 140, 9]
    elif name == "first_event_skip":
        assert nodes[0] == -1 and nodes[1] >= 0
    elif name == "winner_in_dirty_block":
        # most of the eight share pods land in the block the previous
        # create refreshed
        same = sum(a // 128 == b // 128 for a, b in zip(nodes[:8], nodes[1:8]))
        assert same >= 5


@pytest.mark.parametrize("case", [CASES[0], CASES[3]],
                         ids=_case_id)
def test_plain_blocked_equals_flat_plain(case):
    """The blocked select picks what the flat select picks."""
    policies, gpu_sel, dim_ext, norm, seed, n = case
    args = _port_args(*_random_case(seed + 100, n))
    got, _ = he.make_blocked_replay(policies, gpu_sel, "cpu", dim_ext,
                                    norm)(*args)
    want = fe.make_fused_replay(policies, gpu_sel, "cpu", dim_ext,
                                norm)(*args)
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for a, b in zip(got.state, want.state):
        assert torch.equal(a, b)


def test_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors replay_blocked runs plain_replay_blocked and launches
    nothing; a node axis that is not whole blocks is refused."""
    jstate, jtp, jpods, ev_kind, ev_pod, rank = _random_case(71, 300, 100)
    state, pods, types, evk, evp, tp, _, rank = _port_args(
        jstate, jtp, jpods, ev_kind, ev_pod, rank)
    cfg = fe.make_config([("BestFitScore", 1000)], "best")
    padded, rank_p = pad_nodes(state, rank, 128)
    tables = fe.plain_init_tables(padded, types, tp, cfg)
    fe.reset_launch_counts()
    args = (padded, pods, types, evk, evp, tp, rank_p, tables, cfg)
    got, stats = he.replay_blocked(*args)
    want, want_stats = he.plain_replay_blocked(*args)
    assert torch.equal(stats, want_stats) and int(stats[2]) > 0
    assert torch.equal(got.placed_node, want.placed_node)
    assert all(fn.launches == 0 for fn in fe.KERNEL_WRAPPERS)
    with pytest.raises(ValueError, match="128-node blocks"):
        he.replay_blocked(state, pods, types, evk, evp, tp, rank,
                          fe.plain_init_tables(state, types, tp, cfg), cfg)


def test_pad_nodes_matches_jax():
    rng = np.random.default_rng(5)
    jstate, _ = random_cluster(rng, num_nodes=300)
    jrank = jnp.asarray(rng.permutation(300).astype(np.int32))
    want_state, want_rank = jpad_nodes(jstate, jrank, 128)
    state, rank = port_state(jstate), torch.as_tensor(np.array(jrank))
    got_state, got_rank = pad_nodes(state, rank, 128)
    assert got_state.num_nodes == 384
    assert_tree_equal(got_state, want_state)
    assert np.array_equal(got_rank.numpy(), np.asarray(want_rank))
    assert_tree_equal(trim_nodes(got_state, 300), jstate)
    # the padded rows are infeasible for every pod type
    types = port_types(build_pod_types(random_pods(rng, num_pods=50)))
    feas = fe.feas_column(trim_nodes(got_state, 384), types.stacked())
    assert feas[:, 300:].sum() == 0
