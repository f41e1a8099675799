"""The report half's building blocks against the JAX package, at tolerance
0: the float32 sums in the reference's order (the blocked cumulative sum,
the tree sum, the vectorised lane sum), the frag classes and scores, the
resource helpers the frag classes use, and the Bellman value function in
its host recursion and its C++ evaluator."""

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
    typical_rows_gpu_host,
)
from tests.test_torch_types_trace import jfields, port_state, port_typical
from tpusim.constants import GPU_MODEL_IDS
from tpusim.native import BellmanEvaluator as JBellman
from tpusim.ops import frag as jfrag
from tpusim.ops import resource as jres
from tpusim.policies import make_policy
from tpusim.sim.engine import EV_CREATE
from tpusim.sim.engine import make_replay as jmake_replay
from tpusim.types import NodeState as JNodeState
from tpusim_torch.native import BellmanEvaluator
from tpusim_torch.ops import frag as pfrag
from tpusim_torch.ops import resource as pres
from tpusim_torch.sim.metrics import xla_cumsum

LENGTHS = (1, 15, 16, 17, 256, 4097, 10811)


def _f32(rng, shape):
    return (rng.standard_normal(shape) * 1000).astype(np.float32)


@pytest.mark.parametrize("length", LENGTHS)
def test_xla_cumsum_matches_jnp_cumsum(length):
    """Bit-equal to jnp.cumsum on XLA's CPU, on a series of report rows
    and on a single series."""
    rng = np.random.default_rng(length)
    cumsum = jax.jit(lambda a: jnp.cumsum(a, axis=0))
    for shape in ((length, 7), (length,)):
        x = _f32(rng, shape)
        want = np.asarray(cumsum(x))
        got = xla_cumsum(torch.as_tensor(x)).numpy()
        assert np.array_equal(got, want), shape
    x = _f32(rng, (3, length))
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    assert np.array_equal(xla_cumsum(torch.as_tensor(x), 1).numpy(), want)


@pytest.mark.parametrize("length", LENGTHS)
def test_tree_sum_matches_xla_sum(length):
    """tree_sum over one axis against .sum(0), alone and under jax.vmap;
    the host `_tree_sum` agrees."""
    rng = np.random.default_rng(100 + length)
    x = _f32(rng, (length, 7))
    want = np.asarray(jax.jit(lambda a: a.sum(0))(x))
    assert np.array_equal(pfrag.tree_sum(torch.as_tensor(x), 1).numpy(), want)
    assert np.array_equal(pfrag._tree_sum(x, 1), want)
    xb = _f32(rng, (3, length, 7))
    want = np.asarray(jax.jit(jax.vmap(lambda a: a.sum(0)))(xb))
    got = pfrag.tree_sum(torch.as_tensor(xb).movedim(1, 0), 1).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(5, 7, 7), (40, 48, 7), (1213, 48, 7)])
def test_tree_sum_two_axes_matches_xla_sum(shape):
    rng = np.random.default_rng(sum(shape))
    x = _f32(rng, shape)
    want = np.asarray(jax.jit(lambda a: a.sum((0, 1)))(x))
    assert np.array_equal(pfrag.tree_sum(torch.as_tensor(x), 2).numpy(), want)


def test_lane_sum_order():
    """16 strided lanes folded in halves (`vector_sum`, one stage of 16
    lanes): each lane's sum, then lanes k and k + 8, k + 4, k + 2, k + 1;
    the per-event rows take that order at 32 typical pods (8 lanes in 2
    parts) and a window's tree order past 32."""
    x = torch.arange(40, dtype=torch.float32)[:, None] ** 3
    lanes = [x[k::16].sum(0) for k in range(16)]
    while len(lanes) > 1:
        lanes = [lanes[k] + lanes[k + len(lanes) // 2]
                 for k in range(len(lanes) // 2)]
    assert torch.equal(pfrag.vector_sum(x, [(16, 1, 48)]), lanes[0])
    assert torch.equal(pfrag.tree_sum(x, 1, lanes=True), pfrag.tree_sum(x, 1))
    assert torch.equal(pfrag.tree_sum(x[:32], 1, lanes=True),
                       pfrag.vector_sum(x[:32], [(16, 1, 32)]))


def _used_cluster(seed, num_nodes):
    """A random cluster with devices partly used and some CPU taken."""
    rng = np.random.default_rng(seed)
    state, tp = random_cluster(rng, num_nodes)
    f = jfields(state)
    slot = np.arange(8)[None, :] < f["gpu_cnt"][:, None]
    take = rng.choice([0, 0, 100, 250, 500, 750, 1000], f["gpu_left"].shape)
    f["gpu_left"] = np.where(slot, f["gpu_left"] - take, 0).astype(np.int32)
    f["cpu_left"] = (f["cpu_left"]
                     - rng.integers(0, 4, num_nodes) * 8000).astype(np.int32)
    return JNodeState(**{k: jnp.asarray(v) for k, v in f.items()}), tp


@pytest.mark.parametrize("seed", [0, 1])
def test_frag_class_and_rows_match_jax(seed):
    """frag_class, node_frag_rows, node_frag_score, frag_sum_except_q3 and
    frag_sum_q1q2q4 per node, against the JAX functions under jax.vmap,
    on partly used random clusters and both fixture distributions."""
    state, tp = _used_cluster(seed, 70)
    for jtp in (tp, typical_pods_with_nongpu()):
        ps, ptp = port_state(state), port_typical(jtp)
        args = (state.cpu_left, state.gpu_left, state.gpu_type)
        cls = jax.vmap(jfrag.frag_class, (0, 0, 0, None))(*args, jtp)
        got = pfrag.frag_class(ps.cpu_left, ps.gpu_left, ps.gpu_type, ptp)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(cls))
        rows = np.asarray(jax.vmap(jfrag.node_frag_amounts,
                                   (0, 0, 0, None))(*args, jtp))
        prow = pfrag.node_frag_rows(ps.cpu_left, ps.gpu_left, ps.gpu_type,
                                    ptp)
        assert np.array_equal(prow.numpy(), rows)
        score = jax.vmap(jfrag.node_frag_score, (0, 0, 0, None))(*args, jtp)
        pscore = pfrag.node_frag_score(ps.cpu_left, ps.gpu_left,
                                       ps.gpu_type, ptp)
        assert np.array_equal(pscore.numpy(), np.asarray(score))
        for jf, pf in ((jfrag.frag_sum_except_q3, pfrag.frag_sum_except_q3),
                       (jfrag.frag_sum_q1q2q4, pfrag.frag_sum_q1q2q4)):
            want = np.asarray(jax.jit(jf)(jnp.asarray(rows)))
            assert np.array_equal(pf(torch.as_tensor(rows)).numpy(), want)


@pytest.mark.parametrize("case", FRAG_SCORE_GOLDENS,
                         ids=lambda c: f"{c[2]}-{c[0]}cpu")
def test_frag_score_goldens(case):
    """The reference's golden node scores (frag_test.go:100-163), equal to
    the JAX package's value."""
    cpu_left, gpus, model, dist, expected = case
    jtp = typical_pods_gpu() if dist == "gpu" else typical_pods_with_nongpu()
    g = np.zeros(8, np.int32)
    g[:len(gpus)] = gpus
    t = GPU_MODEL_IDS[model]
    got = float(pfrag.node_frag_score(
        torch.tensor([cpu_left], dtype=torch.int32),
        torch.as_tensor(g)[None], torch.tensor([t], dtype=torch.int32),
        port_typical(jtp))[0])
    want = float(jfrag.node_frag_score(jnp.int32(cpu_left), jnp.asarray(g),
                                       jnp.int32(t), jtp))
    assert got == want
    assert got == pytest.approx(expected, abs=0.05)


@pytest.mark.parametrize("seed", [2, 3])
def test_resource_helpers_match_jax(seed):
    state, _ = _used_cluster(seed, 40)
    pods = random_pods(np.random.default_rng(seed), 25)
    gl = port_state(state).gpu_left
    want_host = jax.vmap(jax.vmap(jres.can_host_on_gpu, (None, 0, 0)),
                         (0, None, None))(state.gpu_left, pods.gpu_milli,
                                          pods.gpu_num)
    got = pres.can_host_on_gpu(gl[:, None, :],
                               torch.as_tensor(np.asarray(pods.gpu_milli)),
                               torch.as_tensor(np.asarray(pods.gpu_num)))
    assert np.array_equal(got.numpy(), np.asarray(want_host))
    want_frag = jax.vmap(jax.vmap(jres.gpu_frag_milli, (None, 0)),
                         (0, None))(state.gpu_left, pods.gpu_milli)
    got = pres.gpu_frag_milli(gl[:, None, :],
                              torch.as_tensor(np.asarray(pods.gpu_milli)))
    assert np.array_equal(got.numpy(), np.asarray(want_frag))


def test_bellman_eight_gpu_golden():
    """frag_test.go:89-98: 78000 mCPU, 8 GPUs [6 x 1000, 535, 70], V100M32,
    the 35-spec distribution: 160.73, from both of the port's versions."""
    node = (78000, [1000] * 6 + [535, 70], GPU_MODEL_IDS["V100M32"])
    rows = typical_rows_gpu_host()
    want = jfrag.node_frag_bellman(node, rows)
    assert pfrag.node_frag_bellman(node, rows) == want
    assert BellmanEvaluator(rows).eval(*node) == want
    assert want == pytest.approx(160.73, abs=0.05)


@pytest.mark.parametrize("seed", [4, 5])
def test_bellman_matches_jax_on_used_clusters(seed):
    """Every node of a partly used cluster: the port's host recursion and
    its C++ evaluator against the JAX package's recursion, exactly, with
    a memo shared across the nodes as in a run."""
    state, _ = _used_cluster(seed, 40)
    rows = typical_rows_gpu_host()
    f = jfields(state)
    jmemo, pmemo = {}, {}
    ev = BellmanEvaluator(rows)
    for c, g, t in zip(f["cpu_left"], f["gpu_left"], f["gpu_type"]):
        node = (int(c), [int(x) for x in g], int(t))
        want = jfrag.node_frag_bellman(node, rows, memo=jmemo)
        assert pfrag.node_frag_bellman(node, rows, memo=pmemo) == want
        assert ev.eval(*node) == want
    assert ev.truncations() == 0
    assert ev.memo_size() == len(pmemo)


def test_bellman_depth_guard_counts_truncations():
    rows = typical_rows_gpu_host()
    node = (96000, [1000] * 8, GPU_MODEL_IDS["V100M32"])
    stats = {}
    want = pfrag.node_frag_bellman(node, rows, max_depth=3, stats=stats)
    ev = BellmanEvaluator(rows, max_depth=3)
    assert ev.eval(*node) == want
    assert ev.truncations() == stats["truncations"] > 0
    assert ev.max_depth_seen() == stats["max_depth_seen"] == 3


@pytest.mark.parametrize("seed", [6, 7])
def test_bellman_series_matches_jax(seed):
    """eval_series on a replay's telemetry (creates and deletes on a
    random cluster) against the JAX package's evaluator, exactly."""
    rng = np.random.default_rng(seed)
    state, tp = random_cluster(rng, 24)
    pods = random_pods(rng, 60)
    kinds = np.zeros(90, np.int32)
    idx = np.concatenate([np.arange(60), rng.integers(0, 60, 30)])
    kinds[60:] = 1
    order = np.argsort(rng.random(90), kind="stable")
    kinds, idx = kinds[order], idx[order].astype(np.int32)
    replay = jmake_replay([(make_policy("FGDScore"), 1000)], "FGDScore",
                          report=False)
    out = replay(state, pods, jnp.asarray(kinds), jnp.asarray(idx), tp,
                 jax.random.PRNGKey(0))
    rows = typical_rows_gpu_host()
    f = jfields(state)
    args = (f["cpu_left"], f["gpu_left"], f["gpu_type"],
            np.asarray(out.event_node), np.asarray(out.event_dev),
            np.where(kinds == EV_CREATE, 1, -1).astype(np.int8),
            np.asarray(pods.cpu)[idx], np.asarray(pods.gpu_milli)[idx])
    want = JBellman(rows).eval_series(*args)
    got = BellmanEvaluator(rows).eval_series(*args)
    assert got.dtype == np.float64
    assert np.array_equal(got, want)
    assert (np.asarray(out.event_node) >= 0).sum() > 30


def test_report_lines_match_jax_and_line_helpers():
    """batch_event_report_msgs and event_report_series on seeded series
    (creates, deletes, skips, failed creates, zero idle rows) against the
    JAX package's, string for string; each event's lines equal the
    one-line emitters'."""
    from tpusim.sim import reports as jrep
    from tpusim_torch.sim import reports as prep

    rng = np.random.default_rng(9)
    e = 60
    amounts = (rng.random((e, 7)) * 5e5).astype(np.float32)
    amounts[5] = 0.0
    ints = [rng.integers(0, 10**6, e).astype(np.int32) for _ in range(6)]
    pc, pg = (rng.integers(0, 10**5, e).astype(np.float32) for _ in range(2))
    bellman = rng.random(e) * 4e5
    kinds = rng.choice([0, 0, 1, 2], e).astype(np.int32)
    names = np.array([f"pod-{i % 17}" for i in range(e)])
    failed = rng.random(e) < 0.2
    args = (amounts, 6212, *ints, pc, pg)
    kw = dict(kinds=kinds, pod_names=names, failed=failed)
    for b in (bellman, None):
        got = prep.batch_event_report_msgs(*args, bellman=b, **kw)
        assert got == jrep.batch_event_report_msgs(*args, bellman=b, **kw)
        for k, v in prep.event_report_series(amounts, pc, pg, b).items():
            assert np.array_equal(
                v, jrep.event_report_series(amounts, pc, pg, b)[k]), k
    got = prep.batch_event_report_msgs(*args, bellman=bellman)
    log = prep.LogSink()
    for i in range(e):
        prep.report_frag_line(log, amounts[i])
        idle = float(amounts[i].sum(dtype=np.float32))
        prep.report_bellman_line(log, float(bellman[i]), idle)
        prep.report_alloc_lines(log, ints[0][i], ints[1][i], ints[2][i], 6212,
                                ints[3][i], ints[4][i], ints[5][i])
        prep.report_power_line(log, float(pc[i]), float(pg[i]))
    sink = prep.LogSink()
    sink.info_many(got)
    assert sink.lines == log.lines
