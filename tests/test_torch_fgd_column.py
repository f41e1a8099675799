"""The port's FGD and Filter column functions against the JAX package:
`fgd_column` / `feas_column` (and the plain table build they make) must be
exactly equal to tpusim.policies.fgd.fgd_score and
tpusim.sim.step.filter_nodes, through make_table_builders, for every node x
type; the port's per-pod FGD scorer likewise; the frag score meets the
reference's golden values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import (
    FRAG_SCORE_GOLDENS,
    random_cluster,
    random_pods,
    typical_pods_gpu,
    typical_pods_with_nongpu,
)
from tests.test_torch_types_trace import (
    openb_prepared,
    port_specs,
    port_state,
    port_typical,
    port_types,
)
from tpusim.io.trace import pods_to_specs
from tpusim.policies import ScoreContext, make_policy
from tpusim.sim.table_engine import build_pod_types, make_table_builders
from tpusim_torch.constants import GPU_MODEL_IDS
from tpusim_torch.ops.frag import node_frag_amounts
from tpusim_torch.policies import fgd as pfgd
from tpusim_torch.policies.base import ScoreContext as PScoreContext
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.types import NodeState, PodSpec


FGD = fe.make_config([("FGDScore", 1000)], "FGDScore")


def _jax_tables(jstate, jtypes, jtp):
    """JAX (score, sdev, feas) [K, N] tables through the table builders."""
    _, init = make_table_builders([(make_policy("FGDScore"), 1000)], 0)
    s, d, f = jax.jit(init)(jstate, jtypes, jtp, jax.random.PRNGKey(0))
    return np.asarray(s)[0], np.asarray(d), np.asarray(f).astype(np.int32)


def _assert_tables(port, jax_tables):
    for name, got, want in zip(("score", "sdev", "feas"), port, jax_tables):
        bad = np.argwhere(got.numpy() != want)
        assert bad.size == 0, (
            f"{name}: {len(bad)} of {want.size} (type, node) entries differ, "
            f"first {bad[:5].tolist()}"
        )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_columns_match_jax_random(seed):
    rng = np.random.default_rng(seed)
    jstate, jtp = random_cluster(rng, num_nodes=48)
    jpods = random_pods(rng, num_pods=80)
    jtypes = build_pod_types(jpods)
    tables = fe.plain_init_tables(port_state(jstate), port_types(jtypes),
                                  port_typical(jtp), FGD)
    _assert_tables(tables, _jax_tables(jstate, jtypes, jtp))


def test_columns_match_jax_openb_tables():
    """The full openb [K, N] tables at the start of the paper's run."""
    jsim, jtr, _, _ = openb_prepared()
    jtypes = build_pod_types(pods_to_specs(jtr))
    tables = fe.plain_init_tables(port_state(jsim.init_state),
                                  port_types(jtypes), port_typical(jsim.typical),
                                  FGD)
    assert tables[0].shape == (151, 1213)
    _assert_tables(tables, _jax_tables(jsim.init_state, jtypes, jsim.typical))


def test_single_node_column_matches_batch():
    """The per-event refresh (one node) equals the batched table build."""
    rng = np.random.default_rng(9)
    jstate, jtp = random_cluster(rng, num_nodes=20)
    jtypes = build_pod_types(random_pods(rng, num_pods=60))
    state, types, tp = (port_state(jstate), port_types(jtypes),
                        port_typical(jtp))
    specs, ks = types.stacked(), types.num_share
    score, sdev = pfgd.fgd_column(state, specs, ks, tp)
    feas = fe.feas_column(state, specs)
    for d in (0, 7, 19):
        one = NodeState(*(a[d:d + 1] for a in state))
        s1, d1 = pfgd.fgd_column(one, specs, ks, tp)
        assert torch.equal(s1[:, 0], score[:, d])
        assert torch.equal(d1[:, 0], sdev[:, d])
        assert torch.equal(fe.feas_column(one, specs)[:, 0], feas[:, d])


@pytest.mark.parametrize("seed", [0, 1])
def test_policy_fgd_score_matches_jax(seed):
    """The plain per-pod scorer against tpusim.policies.fgd.fgd_score, and
    against the column form, on a partly filled cluster."""
    rng = np.random.default_rng(seed)
    jstate, jtp = random_cluster(rng, num_nodes=32)
    used = rng.choice([0, 100, 250, 500, 1000], size=(32, 8))
    jstate = jstate._replace(
        gpu_left=jnp.maximum(jstate.gpu_left - jnp.asarray(used, jnp.int32), 0),
        cpu_left=jstate.cpu_left - jnp.asarray(
            rng.choice([0, 4000, 16000], 32), jnp.int32),
    )
    jpods = random_pods(rng, num_pods=30)
    ctx = ScoreContext(tp=jtp, feasible=jnp.ones(32, bool), rng=None)
    state, tp, pods = port_state(jstate), port_typical(jtp), port_specs(jpods)
    jtypes = build_pod_types(jpods)
    types = port_types(jtypes)
    col_s, col_d = pfgd.fgd_column(state, types.stacked(), types.num_share, tp)
    fgd = make_policy("FGDScore")
    score_one = jax.jit(lambda pod: fgd(jstate, pod, ctx))
    for i in range(30):
        want = score_one(jax.tree.map(lambda a: a[i], jpods))
        pod = PodSpec(*(a[i] for a in pods))
        score, dev = pfgd.fgd_score(state, pod,
                                    PScoreContext(tp, None, None))
        assert np.array_equal(score.numpy(), np.asarray(want.raw_scores)), i
        assert np.array_equal(dev.numpy(), np.asarray(want.share_dev)), i
        tid = int(types.type_id[i])
        assert torch.equal(col_s[tid], score), i
        if bool(pod.is_gpu_share()):
            assert torch.equal(col_d[tid], dev), i


@pytest.mark.parametrize("num_nodes,seed", [(20, 0), (100, 1), (700, 2)])
def test_cluster_frag_report_matches_jax(num_nodes, seed):
    """The Cluster Analysis amounts, bit for bit, on partly filled clusters
    below, at and well above one 32-node summation window. The frag total
    and ratios come from the idle total, which the port sums over the seven
    amounts and the reference over every contribution: they agree to 1e-6
    of the idle total (1e-4 percentage points), a few float32 roundings."""
    from tpusim.ops.frag import cluster_frag_report as jreport
    from tpusim_torch.ops.frag import cluster_frag_report

    rng = np.random.default_rng(seed)
    jstate, jtp = random_cluster(rng, num_nodes=num_nodes)
    used = rng.choice([0, 100, 250, 500, 1000], size=(num_nodes, 8))
    jstate = jstate._replace(
        gpu_left=jnp.maximum(jstate.gpu_left - jnp.asarray(used, jnp.int32), 0),
        cpu_left=jstate.cpu_left - jnp.asarray(
            rng.choice([0, 4000, 16000], num_nodes), jnp.int32),
    )
    want = [np.asarray(v) for v in jreport(jstate, jtp)]
    got = cluster_frag_report(port_state(jstate), port_typical(jtp))
    assert got[0].dtype == np.float32
    assert np.array_equal(got[0], want[0])
    idle = float(want[0].sum())
    assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-6 * idle)
    for g, w in zip(got[2:], want[2:]):  # percent of idle
        assert float(g) == pytest.approx(float(w), abs=1e-4)


@pytest.mark.parametrize(
    "case", FRAG_SCORE_GOLDENS, ids=lambda c: f"{c[2]}-{c[0]}cpu"
)
def test_frag_score_goldens(case):
    """The frag score FGD differentiates meets frag_test.go's goldens, by
    the decomposition fgd_column uses and by the per-class amounts."""
    cpu_left, gpus, model, dist, expected = case
    jtp = typical_pods_gpu() if dist == "gpu" else typical_pods_with_nongpu()
    tp = port_typical(jtp)
    g = np.zeros((1, 8), np.int32)
    g[0, : len(gpus)] = gpus
    cpu = torch.tensor([cpu_left], dtype=torch.int32)
    gpu_type = torch.tensor([GPU_MODEL_IDS[model]], dtype=torch.int32)
    gl = torch.as_tensor(g)
    score = float(pfgd.frag_score(cpu, gl, gpu_type, tp)[0])
    amounts = node_frag_amounts(cpu, gl, gpu_type, tp)[0]
    assert score == pytest.approx(expected, abs=0.05)
    assert float(amounts.sum() - amounts[2]) == pytest.approx(expected, abs=0.05)
