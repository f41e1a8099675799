"""The blocked replay's incremental block summaries
(tpusim_torch.sim.hbm_engine.update_block_summaries, the plain version of
the rule the replay_blocked kernel follows) against the full dirty-block
refresh of plain_replay_blocked, which test_torch_hbm_engine.py holds to
the JAX package's blocked table engine: all seven summary arrays must be
equal after every event, with zero tolerance. Also: the final tables the
plain replays leave, and replays past the limits of what the kernels'
staged forms hold (against tpusim's table engine)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import random_cluster, random_pods
from tests.test_torch_fused_engine import _assert_replays_equal
from tests.test_torch_hbm_engine import _port_args, _random_case
from tests.test_torch_types_trace import (
    port_specs,
    port_state,
    port_typical,
    port_types,
)
from tpusim.policies import make_policy
from tpusim.sim.table_engine import build_pod_types, make_table_replay
from tpusim.types import make_typical_pods
from tpusim_torch import kernels
from tpusim_torch.parallel.sharding import pad_nodes
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he

FGD = ([("FGDScore", 1000)], "FGDScore")
BESTFIT = ([("BestFitScore", 1000)], "best")
PWR_FGD = ([("PWRScore", 500), ("FGDScore", 500)], "FGDScore")


def _clone(summ):
    return he.Summaries(*(x.clone() for x in summ))


def _assert_summaries_equal(got, want, where):
    for name, a, b in zip(he.Summaries._fields, got, want):
        assert torch.equal(a, b), (name, where)


@pytest.mark.parametrize("row,seed,nodes", [
    (FGD, 81, 300), (BESTFIT, 82, 300), (PWR_FGD, 83, 520)],
    ids=["FGD", "BestFit", "PWR+FGD"])
def test_incremental_summaries_match_full_refresh(row, seed, nodes):
    """After every event of a random blocked trace (~200 events, creates
    and deletes, pinned pods, a padded last block) the rule's summaries
    equal the full refresh of the dirty block."""
    policies, gpu_sel = row
    state, pods, types, evk, evp, tp, _, rank = _port_args(
        *_random_case(seed, nodes))
    state, rank = pad_nodes(state, rank, 128)
    cfg = fe.make_config(policies, gpu_sel)
    tables = fe.plain_init_tables(state, types, tp, cfg)
    seen = {"refreshes": 0, "rescans": 0}

    def on_refresh(dirty, old, new, tables, before, after):
        summ = _clone(before)
        rescan = he.update_block_summaries(summ, old, new, dirty, tables,
                                           rank, cfg)
        _assert_summaries_equal(summ, after, seen["refreshes"])
        seen["refreshes"] += 1
        seen["rescans"] += int(rescan.sum())

    he.plain_replay_blocked(state, pods, types, evk, evp, tp, rank, tables,
                            cfg, on_refresh=on_refresh)
    assert seen["refreshes"] > 150
    # the rule decides most (type, event) pairs without a rescan
    assert 0 < seen["rescans"] < seen["refreshes"] * types.num_types // 2


N, K = 256, 2  # two blocks, two pod types


def _tables(cfg, seed=0):
    """Hand-made tables: distinct raw scores per (type, node), every node
    feasible, ranks a seeded permutation."""
    rng = np.random.default_rng(seed)
    n_pol = len(cfg.policies)
    score = torch.as_tensor(rng.permutation(n_pol * K * N).reshape(
        n_pol * K, N) % 997, dtype=torch.int32)
    feas = torch.ones((K, N), dtype=torch.int32)
    rank = torch.as_tensor(rng.permutation(N), dtype=torch.int32)
    return score, feas, rank


def _change(cfg, score, feas, rank, node, new_raw, new_feas):
    """Change one node's column; returns (rescanned types, the rule's
    summaries) after asserting they equal the full refresh's."""
    n_pol = len(cfg.policies)
    sdev = torch.full((K, N), -1, dtype=torch.int32)
    summ = he.plain_init_summaries((score, sdev, feas), rank, cfg)

    def column(score, feas):
        return score.view(n_pol, K, N)[:, :, node].clone(), feas[:, node] != 0

    old = column(score, feas)
    score, feas = score.clone(), feas.clone()
    score.view(n_pol, K, N)[:, :, node] = torch.as_tensor(
        new_raw, dtype=torch.int32).view(n_pol, K)
    feas[:, node] = torch.as_tensor(new_feas, dtype=torch.int32)
    tables = (score, sdev, feas)
    got = _clone(summ)
    rescan = he.update_block_summaries(got, old, column(score, feas), node,
                                       tables, rank, cfg)
    want = _clone(summ)
    he.refresh_block(want, tables, rank, node // 128, slice(None), cfg)
    _assert_summaries_equal(got, want, node)
    return rescan.tolist(), got


def test_winner_that_loses_is_rescanned():
    cfg = fe.make_config(*FGD)
    score, feas, rank = _tables(cfg)
    sdev = torch.full((K, N), -1, dtype=torch.int32)
    w = int(he.plain_init_summaries((score, sdev, feas), rank, cfg).bn[0, 0])
    rescan, got = _change(cfg, score, feas, rank, w, [-1, score[1, w]],
                          [1, 1])
    assert rescan == [True, False] and int(got.bn[0, 0]) != w
    # a winner whose total rises keeps its block without a rescan
    rescan, got = _change(cfg, score, feas, rank, w, [5000, score[1, w]],
                          [1, 1])
    assert rescan == [False, False] and int(got.bn[0, 0]) == w


def test_tie_is_won_by_rank():
    cfg = fe.make_config(*FGD)
    score, feas, rank = _tables(cfg)
    sdev = torch.full((K, N), -1, dtype=torch.int32)
    w = int(he.plain_init_summaries((score, sdev, feas), rank, cfg).bn[0, 0])
    block = range(128)
    low = min((x for x in block if rank[x] < rank[w]), key=lambda x: rank[x])
    high = max((x for x in block if rank[x] > rank[w]), key=lambda x: rank[x])
    rescan, got = _change(cfg, score, feas, rank, low, [score[0, w],
                                                        score[1, low]], [1, 1])
    assert rescan == [False, False] and int(got.bn[0, 0]) == low
    rescan, got = _change(cfg, score, feas, rank, high, [score[0, w],
                                                         score[1, high]],
                          [1, 1])
    assert rescan == [False, False] and int(got.bn[0, 0]) == w


def test_node_that_becomes_infeasible():
    cfg = fe.make_config(*FGD)
    score, feas, rank = _tables(cfg)
    sdev = torch.full((K, N), -1, dtype=torch.int32)
    w = int(he.plain_init_summaries((score, sdev, feas), rank, cfg).bn[0, 0])
    rescan, got = _change(cfg, score, feas, rank, w, [score[0, w],
                                                      score[1, w]], [0, 1])
    assert rescan[0] and int(got.bn[0, 0]) != w
    other = (w + 1) % 128
    rescan, _ = _change(cfg, score, feas, rank, other,
                        [score[0, other], score[1, other]], [0, 1])
    assert rescan[0] == (other == w)


def test_node_holding_block_min_and_max():
    """BestFit is min-max normalised: a node that alone holds its block's
    feasible extrema and moves needs a rescan; one that widens them does
    not."""
    cfg = fe.make_config(*BESTFIT)
    score, feas, rank = _tables(cfg)
    feas[0, :128] = 0
    feas[0, 7] = 1  # node 7 alone is feasible for type 0 in block 0
    rescan, got = _change(cfg, score, feas, rank, 7, [score[0, 7] + 1,
                                                      score[1, 7]], [1, 1])
    assert rescan == [True, False]
    assert int(got.brmin[0, 0, 0]) == int(got.brmax[0, 0, 0]) == \
        int(score[0, 7]) + 1
    # two feasible nodes: the one holding the min drops lower
    feas[0, 9] = 1
    lo, hi = sorted((7, 9), key=lambda x: int(score[0, x]))
    rescan, got = _change(cfg, score, feas, rank, lo, [score[0, lo] - 5,
                                                       score[1, lo]], [1, 1])
    assert not rescan[0] and int(got.brmin[0, 0, 0]) == int(score[0, lo]) - 5
    # ... or the one holding the max becomes infeasible
    rescan, got = _change(cfg, score, feas, rank, hi, [score[0, hi],
                                                       score[1, hi]], [0, 1])
    assert rescan[0] and int(got.brmax[0, 0, 0]) == int(score[0, lo])


def test_block_with_no_feasible_node():
    for row in (FGD, BESTFIT):
        cfg = fe.make_config(*row)
        score, feas, rank = _tables(cfg)
        feas[0, :128] = 0
        rescan, got = _change(cfg, score, feas, rank, 3, [score[0, 3] + 7,
                                                          score[1, 3]],
                              [0, 1])
        assert not rescan[0] and int(got.bt[0, 0]) == -2**31 + 1
        # the node becomes feasible: it wins the block
        rescan, got = _change(cfg, score, feas, rank, 3, [score[0, 3],
                                                          score[1, 3]],
                              [1, 1])
        assert not rescan[0] and int(got.bn[0, 0]) == 3


@pytest.mark.parametrize("row", [FGD, PWR_FGD], ids=["FGD", "PWR+FGD"])
def test_final_tables_are_the_final_state_but_the_last_column(row):
    """The tables a replay leaves are those of its final node state, but
    for the column of the last event's node, which is refreshed only at
    the next event; the blocked replay leaves the same tables."""
    policies, gpu_sel = row
    state, pods, types, evk, evp, tp, _, rank = _port_args(
        *_random_case(84, 300, 100))
    state, rank = pad_nodes(state, rank, 128)
    cfg = fe.make_config(policies, gpu_sel)
    tables = fe.plain_init_tables(state, types, tp, cfg)
    keep, keep_blocked = {}, {}
    res = fe.plain_replay(state, pods, types, evk, evp, tp, rank, tables,
                          cfg, keep=keep)
    he.plain_replay_blocked(state, pods, types, evk, evp, tp, rank, tables,
                            cfg, keep=keep_blocked)
    fresh = fe.plain_init_tables(res.state, types, tp, cfg)
    last = int(res.event_node[-1])
    assert last >= 0
    for got, blocked, want in zip(keep["tables"], keep_blocked["tables"],
                                  fresh):
        assert torch.equal(got, blocked)
        assert torch.equal(torch.cat([got[:, :last], got[:, last + 1:]], 1),
                           torch.cat([want[:, :last], want[:, last + 1:]], 1))
    assert not all(torch.equal(a[:, last], b[:, last])
                   for a, b in zip(keep["tables"], fresh))
    assert set(keep_blocked["summaries"]._fields) == set(he.Summaries._fields)


@pytest.mark.parametrize("which", ["types", "typical"])
def test_staged_size_limits(which):
    """One pod type (K = 2049) or one typical pod (T = 1025) past what the
    kernels' staged forms hold, where the host launches their global
    forms: the plain replay on a small cluster equals tpusim's table
    engine (placements, masks, failures, telemetry, final state)."""
    rng = np.random.default_rng(91 if which == "types" else 92)
    jstate, jtp = random_cluster(rng, num_nodes=12)
    k = kernels.MAX_TYPES + 1 if which == "types" else 40
    jpods = random_pods(rng, num_pods=k)
    # distinct CPU requests: one pod type a pod
    jpods = jpods._replace(cpu=jnp.asarray(
        100 + 7 * np.arange(k, dtype=np.int32)))
    if which == "typical":
        t = kernels.MAX_TYPICAL + 1
        freq = rng.random(t).astype(np.float32)
        jtp = make_typical_pods(list(zip(
            rng.choice([1000, 4000, 8000], t).tolist(),
            rng.choice([0, 100, 250, 500, 1000], t).tolist(),
            rng.choice([1, 2], t).tolist(), rng.choice([0, 1, 6], t).tolist(),
            (freq / freq.sum()).tolist())))
    ev_kind = np.zeros(40, np.int32)
    ev_pod = rng.permutation(k)[:40].astype(np.int32)
    jtypes = build_pod_types(jpods)
    assert not kernels.staged(jtypes.share.cpu.shape[0]
                              + jtypes.whole.cpu.shape[0],
                              int(jtp.cpu.shape[0]))
    want = make_table_replay([(make_policy("FGDScore"), 1000)],
                             gpu_sel="FGDScore")(
        jstate, jpods, jtypes, jnp.asarray(ev_kind), jnp.asarray(ev_pod),
        jtp, jax.random.PRNGKey(0), jnp.arange(12, dtype=jnp.int32))
    got = fe.make_fused_replay([("FGDScore", 1000)], "FGDScore", "cpu")(
        port_state(jstate), port_specs(jpods), port_types(jtypes),
        torch.as_tensor(ev_kind), torch.as_tensor(ev_pod), port_typical(jtp))
    _assert_replays_equal(got, want)
    assert (got.event_node >= 0).sum() > 10
