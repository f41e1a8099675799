"""RandomScore, gpu_sel random and Simon in the port against tpusim, with
zero tolerance: the Simon column against tpusim's compiled table build on
the openb node list, RandomScore's per-event draw and the random device
pick (with the exclusive and flatten helpers) against tpusim's functions
on the same keys, the port's plain flat and blocked replays against
tpusim's table engine (which is what tpusim's Simulator runs for these
configurations) under each of them and their mixes, and the per-event
report of the openb prefix under 01-Random."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.fixtures import random_cluster, random_pods
from tests.test_table_engine import _events_with_deletes
from tests.test_torch_fused_engine import _assert_replays_equal
from tests.test_torch_report import (
    _configs,
    _experiment_files,
    janalyze_sim,
)
from tests.test_torch_types_trace import (
    NODE_CSV,
    openb_rows,
    port_specs,
    port_state,
    port_typical,
    port_types,
)
from tpusim.io import trace as jtrace
from tpusim.io.trace import pods_to_specs
from tpusim.ops.resource import allocate_exclusive as jallocate_exclusive
from tpusim.ops.resource import allocate_share_random as jallocate_random
from tpusim.ops.resource import flatten_gpu_left as jflatten_gpu_left
from tpusim.policies import make_policy
from tpusim.policies.base import ScoreContext
from tpusim.policies.random_policy import random_score as jrandom_score
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.table_engine import (
    build_pod_types,
    make_table_builders,
    make_table_replay,
)
from tpusim_torch.analysis import analyze_sim
from tpusim_torch.ops import prng
from tpusim_torch.ops.resource import (
    allocate_exclusive,
    allocate_share_random,
    flatten_gpu_left,
)
from tpusim_torch.policies.base import ScoreContext as PScoreContext
from tpusim_torch.policies.random_policy import random_score
from tpusim_torch.policies.simon import simon_column
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he
from tpusim_torch.sim.driver import Simulator as PSimulator

PROFILE = [("Simon", 1), ("BestFitScore", 1), ("RandomScore", 1),
           ("DotProductScore", 1), ("FGDScore", 1), ("PWRScore", 1)]
# (label, policies, gpu_sel)
CONFIGS = [
    ("Random", [("RandomScore", 1000)], "best"),
    ("Random-gpusel-random", [("RandomScore", 1000)], "random"),
    ("Random+FGD", [("RandomScore", 500), ("FGDScore", 500)], "FGDScore"),
    ("Simon", [("Simon", 1000)], "best"),
    ("Simon+FGD", [("Simon", 500), ("FGDScore", 500)], "FGDScore"),
    ("profile", PROFILE, "best"),
]
BLOCKED = ["Simon", "Simon+FGD"]


def _key(words):
    return jnp.asarray(np.asarray(words, np.uint32))


@pytest.mark.parametrize("node_csv", ["gpu_node", "all_node"])
def test_simon_column_matches_compiled_table_build(node_csv):
    """Every pod type of the openb trace on every node of the openb node
    list (the paper's GPU nodes, and all nodes with the CPU-only ones)."""
    from tests.test_torch_types_trace import openb_prepared

    jsim, jtr, _, _ = openb_prepared()
    path = NODE_CSV.replace("gpu_node", node_csv)
    jstate = JSimulator(jtrace.load_node_csv(path)).init_state
    jtypes = build_pod_types(pods_to_specs(jtr))
    _, init = make_table_builders([(make_policy("Simon"), 1)], -1)
    want = np.asarray(jax.jit(init)(jstate, jtypes, jsim.typical,
                                    jax.random.PRNGKey(0))[0][0])
    types = port_types(jtypes)
    got, sdev = simon_column(port_state(jstate), types.stacked(),
                             types.num_share, None)
    assert got.shape == want.shape and want.shape[1] == \
        jstate.cpu_left.shape[0]
    assert np.array_equal(got.numpy(), want)
    assert (sdev == -1).all() and len(np.unique(want)) > 10


@pytest.mark.parametrize("n", [1, 97, 1213])
def test_random_score_matches_jax(n):
    """RandomScore's row on several keys and feasibility masks: none, one,
    some and all nodes feasible."""
    rng = np.random.default_rng(n)
    jstate, _ = random_cluster(rng, num_nodes=n)
    pod = jax.tree.map(lambda a: a[0], random_pods(rng, 1))
    for i, frac in enumerate((0.0, 1 / n, 0.3, 1.0)):
        feas = rng.random(n) < frac
        key = prng.split(prng.prng_key(100 + i))[1]
        ctx = ScoreContext(tp=None, feasible=jnp.asarray(feas),
                           rng=_key(key))
        want = np.asarray(jrandom_score(jstate, pod, ctx).raw_scores)
        got = random_score(None, None, PScoreContext(
            None, torch.as_tensor(feas), key)).raw_scores
        assert np.array_equal(got.numpy(), want), (n, frac)


def test_allocate_share_random_matches_jax():
    """The random device pick on rows of free milli with none, one and
    several fitting devices, the first on ties of the draw."""
    rng = np.random.default_rng(3)
    for i in range(200):
        g = rng.choice([0, 100, 250, 500, 750, 1000], 8).astype(np.int32)
        milli = int(rng.choice([100, 250, 500, 750, 1001]))
        key = prng.split(prng.prng_key(i))[0]
        want = int(jallocate_random(jnp.asarray(g), milli, _key(key)))
        got = int(allocate_share_random(torch.as_tensor(g), milli, key))
        assert got == want, (g.tolist(), milli)


def test_exclusive_and_flatten_match_jax():
    """The other two resource helpers the port took with the random pick:
    the first fully free devices covering a whole-GPU request, and the
    devices sorted most free first, on batches of random rows."""
    rng = np.random.default_rng(4)
    g = rng.choice([0, 250, 500, 1000], (300, 8)).astype(np.int32)
    total = rng.choice([0, 500, 1000, 2000, 3000, 4000, 8000], 300)
    total = total.astype(np.int32)
    want = np.stack([np.asarray(jallocate_exclusive(jnp.asarray(r), int(t)))
                     for r, t in zip(g, total)])
    got = allocate_exclusive(torch.as_tensor(g), torch.as_tensor(total))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(flatten_gpu_left(torch.as_tensor(g)).numpy(),
                          np.asarray(jflatten_gpu_left(jnp.asarray(g))))


def _case(seed, num_nodes=24, num_pods=60):
    rng = np.random.default_rng(seed)
    jstate, jtp = random_cluster(rng, num_nodes=num_nodes)
    jpods = random_pods(rng, num_pods=num_pods)
    pin = np.full(num_pods, -1, np.int32)
    pin[[4, 17, 33]] = [2, 0, num_nodes - 1]
    jpods = jpods._replace(pinned=jnp.asarray(pin))
    ev_kind, ev_pod = _events_with_deletes(num_pods, rng)
    rank = jnp.asarray(rng.permutation(num_nodes).astype(np.int32))
    return jstate, jtp, jpods, ev_kind, ev_pod, rank


@pytest.mark.parametrize("label,policies,gpu_sel", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_flat_replay_matches_table_engine(label, policies, gpu_sel):
    """The port's plain flat replay against tpusim's flat table engine,
    from the same root key: placements, masks, failures, telemetry and the
    final state."""
    jstate, jtp, jpods, ev_kind, ev_pod, rank = _case(60 + len(label))
    jtypes = build_pod_types(jpods)
    want = make_table_replay([(make_policy(n), w) for n, w in policies],
                             gpu_sel=gpu_sel, block_size=-1)(
        jstate, jpods, jtypes, ev_kind, ev_pod, jtp,
        jax.random.PRNGKey(11), rank)
    got = fe.make_fused_replay(policies, gpu_sel, "cpu")(
        port_state(jstate), port_specs(jpods), port_types(jtypes),
        torch.as_tensor(np.array(ev_kind)), torch.as_tensor(np.array(ev_pod)),
        port_typical(jtp), prng.prng_key(11),
        torch.as_tensor(np.array(rank)))
    _assert_replays_equal(got, want)
    assert (got.event_node >= 0).sum() > 20


@pytest.mark.parametrize("label", BLOCKED)
def test_blocked_replay_matches_blocked_table_engine(label):
    """Simon through replay_blocked's min-max path: the port's plain
    blocked replay against tpusim's blocked table engine (128-node
    blocks), on a cluster of three blocks once padded."""
    policies, gpu_sel = {c[0]: c[1:] for c in CONFIGS}[label]
    jstate, jtp, jpods, ev_kind, ev_pod, rank = _case(70 + len(label), 300,
                                                      150)
    jtypes = build_pod_types(jpods)
    want = make_table_replay([(make_policy(n), w) for n, w in policies],
                             gpu_sel=gpu_sel, block_size=128)(
        jstate, jpods, jtypes, ev_kind, ev_pod, jtp,
        jax.random.PRNGKey(3), rank)
    got, stats = he.make_blocked_replay(policies, gpu_sel, "cpu")(
        port_state(jstate), port_specs(jpods), port_types(jtypes),
        torch.as_tensor(np.array(ev_kind)), torch.as_tensor(np.array(ev_pod)),
        port_typical(jtp), None, torch.as_tensor(np.array(rank)))
    _assert_replays_equal(got, want)
    assert stats.tolist() == [0, 0, int(np.asarray(want.counters)[5])]


@pytest.mark.parametrize("label,policies,gpu_sel", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_random_score_has_no_table_rows(label, policies, gpu_sel):
    """RandomScore goes last in the configuration, with its weight, and the
    score table holds rows for the other policies only."""
    cfg = fe.make_config(policies, gpu_sel)
    others = [(n, w) for n, w in policies if n != "RandomScore"]
    rand = [(n, w) for n, w in policies if n == "RandomScore"]
    assert [(p.name, w) for p, w in zip(cfg.policies, cfg.weights)] == \
        others + rand
    assert cfg.num_tables == len(others)
    jstate, jtp, jpods = _case(90)[:3]
    state, types = port_state(jstate), port_types(build_pod_types(jpods))
    score, sdev, feas = fe.plain_init_tables(state, types, port_typical(jtp),
                                             cfg)
    assert score.shape == (len(others) * types.num_types, state.num_nodes)
    assert sdev.shape == feas.shape == (types.num_types, state.num_nodes)


def test_randomized_configs_refuse_the_blocked_replay():
    with pytest.raises(ValueError, match="flat replay"):
        he.make_blocked_replay([("RandomScore", 1000)], "best", "cpu")
    with pytest.raises(ValueError, match="flat replay"):
        he.make_blocked_replay([("FGDScore", 1000)], "random", "cpu")


def test_openb_prefix_report_under_01_random(tmp_path):
    """Simulator.run(), finish() and analyze_sim on the first 256 openb
    pods, shuffled and tuned to 1.3, under 01-Random: simon.log without its
    [Engine] line and the analysis CSVs, byte for byte; the replay ran
    flat under the "hbm" residency too."""
    import dataclasses

    jn, jp, pn, pp = openb_rows()
    jcfg, pcfg = _configs("01-Random", 1.3)
    mid, policies, gpu_sel, dim_ext = chip_smoke.METHODS[0][:4]
    assert mid == "01-Random"
    meta = chip_smoke.row_meta(policies, gpu_sel, dim_ext)
    jsim = JSimulator(jn, jcfg)
    jsim.set_workload_pods(jp[:256])
    jsim.run()
    psim = PSimulator(pn, dataclasses.replace(pcfg, table_residency="hbm"),
                      device="cpu")
    psim.set_workload_pods(pp[:256])
    pres = psim.run()
    assert psim.last_engine == "plain_replay" and \
        psim.last_residency == "vmem"
    assert pres.events > 256 and pres.unscheduled_pods
    want = _experiment_files(jsim, tmp_path / "jax", meta, janalyze_sim)
    got = _experiment_files(psim, tmp_path / "port", meta, analyze_sim)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
