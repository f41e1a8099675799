"""The sequential oracle's step against the JAX package's, at tolerance 0:
each policy's per-pod scorer (every DotProduct pair, RandomScore under
drawn keys) against tpusim's jitted per-pod kernel, and every function of
tpusim_torch/sim/step.py against tpusim/sim/step.py, on seeded numpy
states (partly used random clusters, pods of every kind, pinned pods)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import random_pods
from tests.test_torch_policies import used_cluster
from tests.test_torch_types_trace import jfields, port_state, port_typical
from tpusim.policies import ScoreContext as JContext
from tpusim.policies import jit_policy
from tpusim.policies import make_policy as jmake_policy
from tpusim.policies.clustering import pod_affinity_class as jaffinity
from tpusim.sim import step as jstep
from tpusim_torch.ops import prng
from tpusim_torch.policies import ScoreContext, make_policy
from tpusim_torch.policies.clustering import pod_affinity_class
from tpusim_torch.policies.dotprod import DIM_EXT_METHODS, NORM_METHODS
from tpusim_torch.sim import step as pstep
from tpusim_torch.types import NodeState, PodSpec

SCORER_CASES = [
    ("FGDScore", "share", "max"),
    ("BestFitScore", "share", "max"),
    ("GpuPackingScore", "share", "max"),
    ("GpuClusteringScore", "share", "max"),
    ("PWRScore", "share", "max"),
    ("Simon", "share", "max"),
    ("RandomScore", "share", "max"),
] + [("DotProductScore", d, n) for d in DIM_EXT_METHODS for n in NORM_METHODS]

GPU_SELS = ("best", "worst", "random", "FGDScore")


def _key(words):
    return jnp.asarray(np.asarray(words, np.uint32))


def _pods(rng, n):
    """Random pods of every kind, a few pinned to a node."""
    pods = random_pods(rng, n)
    pinned = np.where(rng.random(n) < 0.15, rng.integers(0, 40, n), -1)
    return pods._replace(pinned=jnp.asarray(pinned, jnp.int32))


def _host(jpod) -> PodSpec:
    """One JAX pod (scalar fields) as the port's pod of Python ints."""
    return PodSpec(*(int(v) for v in jpod))


def _cases(seeds=(0, 1), n=40, num_pods=20):
    """(JAX state, typical pods, JAX pods, port state, port typical pods)
    of partly used random clusters."""
    for seed in seeds:
        rng = np.random.default_rng(200 + seed)
        jstate, jtp = used_cluster(seed, n)
        jpods = _pods(rng, num_pods)
        yield (jstate, jtp, jpods, port_state(jstate), port_typical(jtp),
               rng)


def _pod(jpods, i):
    return jax.tree.map(lambda a: a[i], jpods)


@pytest.mark.parametrize("name,dim_ext,norm", SCORER_CASES,
                         ids=lambda v: str(v))
def test_per_pod_scorer_matches_jax(name, dim_ext, norm):
    """Raw scores and share-device picks of the per-pod scorer on every
    node, pod by pod; RandomScore under a drawn key and Filter mask each
    pod."""
    jfn = jit_policy(jmake_policy(name, dim_ext, norm))
    pol = make_policy(name, dim_ext, norm)
    assert pol.normalize == jfn.normalize
    for jstate, jtp, jpods, state, tp, rng in _cases():
        n = state.num_nodes
        for i in range(jpods.cpu.shape[0]):
            key = prng.split(prng.prng_key(int(rng.integers(1 << 30))))[0]
            feas = rng.random(n) < 0.6
            jres = jfn(jstate, _pod(jpods, i),
                       JContext(jtp, jnp.asarray(feas), _key(key)))
            res = pol.scorer(state, _host(_pod(jpods, i)),
                             ScoreContext(tp, torch.as_tensor(feas), key))
            np.testing.assert_array_equal(res.raw_scores.numpy(),
                                          np.asarray(jres.raw_scores))
            np.testing.assert_array_equal(res.share_dev.numpy(),
                                          np.asarray(jres.share_dev))
            assert res.raw_scores.dtype == res.share_dev.dtype == torch.int32


def test_affinity_class_and_weights_match_jax():
    """pod_affinity_class on every kind of pod; resolve_weights on the
    configured and given rows, and its shape check."""
    rng = np.random.default_rng(3)
    jpods = _pods(rng, 60)
    for i in range(60):
        assert pod_affinity_class(_host(_pod(jpods, i))) == int(
            jaffinity(_pod(jpods, i)))
    policies = [(make_policy("FGDScore"), 7), (make_policy("PWRScore"), 3)]
    jpol = [(None, 7), (None, 3)]
    assert pstep.resolve_weights(policies) == tuple(
        np.asarray(jstep.resolve_weights(jpol)).tolist())
    assert pstep.resolve_weights(policies, [5, -2]) == tuple(
        np.asarray(jstep.resolve_weights(jpol, [5, -2])).tolist())
    with pytest.raises(ValueError, match="does not match"):
        pstep.resolve_weights(policies, [1])


def test_filter_nodes_matches_jax():
    """The Filter mask of every pod kind (pinned ones included)."""
    for jstate, _, jpods, state, _, _ in _cases(num_pods=60):
        for i in range(60):
            want = np.asarray(jstep.filter_nodes(jstate, _pod(jpods, i)))
            got = pstep.filter_nodes(state, _host(_pod(jpods, i)))
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gpu_sel", GPU_SELS)
def test_choose_devices_matches_jax(gpu_sel):
    """The Reserve device mask on node rows of every fill, for share pods
    (each gpuSelMethod; a policy pick of -1 falls back to best fit) and
    whole and CPU pods."""
    rng = np.random.default_rng(11)
    jpods = _pods(rng, 80)
    for i in range(80):
        g = rng.choice([0, 100, 250, 500, 750, 1000], 8).astype(np.int32)
        pick = int(rng.integers(-1, 8))
        key = prng.split(prng.prng_key(i))[1]
        want = jstep.choose_devices(jnp.asarray(g), _pod(jpods, i),
                                    jnp.int32(pick), gpu_sel, _key(key))
        got = pstep.choose_devices(torch.as_tensor(g), _host(_pod(jpods, i)),
                                   torch.tensor(pick, dtype=torch.int32),
                                   gpu_sel, key)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_reductions_match_jax():
    """packed_argmax, packed_topk and block_reduce on seeded totals with
    ties, every entry invalid, and one valid entry."""
    rng = np.random.default_rng(5)
    argmax = jax.jit(jstep.packed_argmax)
    topk = jax.jit(jstep.packed_topk, static_argnums=3)
    block = jax.jit(jstep.block_reduce)
    for trial in range(32):
        m = (1, 5, 17, 40)[trial % 4]
        total = rng.integers(-3, 4, m).astype(np.int32)
        frac = (0.0, 1.0 / m, 0.5, 1.0)[trial // 4 % 4]
        valid = rng.random(m) < frac
        rank = rng.permutation(m).astype(np.int32)
        args = (jnp.asarray(total), jnp.asarray(valid), jnp.asarray(rank))
        targs = tuple(torch.as_tensor(a) for a in (total, valid, rank))
        for got, want in zip(pstep.packed_argmax(*targs), argmax(*args)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(pstep.packed_topk(*targs, 4),
                             topk(*args, 4)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tot = rng.integers(-3, 4, (3, m)).astype(np.int32)
        tot[0] = -(2**31 - 1)
        for got, want in zip(pstep.block_reduce(torch.as_tensor(tot),
                                                targs[2]),
                             block(jnp.asarray(tot), args[2])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _same_state(got: NodeState, want):
    for name, w in jfields(want).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), w,
                                      err_msg=name)


def _policies(rows, dim_ext="share", norm="max"):
    return ([(make_policy(n, dim_ext, norm), w) for n, w in rows],
            [(jmake_policy(n, dim_ext, norm), w) for n, w in rows])


PROFILE = [("Simon", 1), ("BestFitScore", 1), ("RandomScore", 1),
           ("DotProductScore", 1), ("FGDScore", 1), ("PWRScore", 1)]


@pytest.mark.parametrize("rows,gpu_sel", [
    ([("FGDScore", 1000)], "FGDScore"),
    ([("FGDScore", 500), ("PWRScore", 500)], "PWRScore"),
    (PROFILE, "random"),
], ids=["fgd", "pwr-fgd", "profile"])
def test_score_select_bind_unschedule_match_jax(rows, gpu_sel):
    """score_pod_rows, score_pod, select_and_bind (packed_argmax, then
    bind_selected), schedule_one and unschedule, chained over each case's
    pods: every output and the state after each."""
    ppol, jpol = _policies(rows)
    for jstate, jtp, jpods, state, tp, rng in _cases(seeds=(1,)):
        rank = rng.permutation(state.num_nodes).astype(np.int32)
        jrank, prank = jnp.asarray(rank), torch.as_tensor(rank)
        for i in range(jpods.cpu.shape[0]):
            jpod, pod = _pod(jpods, i), _host(_pod(jpods, i))
            key = prng.prng_key(int(rng.integers(1 << 30)))
            k_rand, k_sel = prng.split(key)
            w = rng.integers(-3, 1000, len(rows)).tolist()
            want = jax.jit(jstep.score_pod_rows, static_argnums=(3, 4))(
                jstate, jpod, _key(k_rand), tuple(jpol), gpu_sel, jtp, w)
            got = pstep.score_pod_rows(state, pod, k_rand, ppol, gpu_sel, tp,
                                       w)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(x))
            for g, x in zip(pstep.score_pod(state, pod, k_rand, ppol,
                                            gpu_sel, tp, w), got):
                assert torch.equal(g, x)
            jnew, jpl = jstep.select_and_bind(jstate, jpod, *want[:3],
                                              gpu_sel, _key(k_sel), jrank)
            new, pl = pstep.select_and_bind(state, pod, *got[:3], gpu_sel,
                                            k_sel, prank)
            _same_state(new, jnew)
            for g, x in zip(pl, jpl):
                np.testing.assert_array_equal(g.numpy(), np.asarray(x))
            snew, spl = pstep.schedule_one(state, pod, key, ppol, gpu_sel,
                                           tp, prank, w)
            _same_state(snew, jnew)
            assert torch.equal(spl.node, pl.node)
            back = pstep.unschedule(new, pod, pl)
            _same_state(back, jstep.unschedule(jnew, jpod, jpl))
            if i % 2:  # keep every other pod bound for the next cycles
                jstate, state = jnew, new


def test_pending_commits_match_jax():
    """make_pending_commit and apply_commit for creates (placed and
    failed), deletes and skips, on a partly used cluster with the dummy
    bookkeeping row."""
    jstate, _, jpods, state, _, rng = next(_cases(seeds=(4,)))
    p = int(jpods.cpu.shape[0])
    jbook = (jnp.full(p + 1, -1, jnp.int32),
             jnp.zeros((p + 1, 8), jnp.bool_), jnp.zeros(p + 1, jnp.bool_))
    pbook = tuple(torch.as_tensor(np.array(a)) for a in jbook)
    _same_state(state, jstate)
    for step in range(40):
        kind, idx = int(rng.integers(0, 3)), int(rng.integers(0, p))
        node = int(rng.choice([-1, int(rng.integers(0, state.num_nodes))]))
        mask = rng.random(8) < 0.3
        jpc = jstep.make_pending_commit(jnp.int32(kind), jnp.int32(idx),
                                        jnp.int32(node), jnp.asarray(mask),
                                        _pod(jpods, idx), p)
        ppc = pstep.make_pending_commit(
            kind, idx, torch.tensor(node, dtype=torch.int32),
            torch.as_tensor(mask), _host(_pod(jpods, idx)), p)
        want = jstep.apply_commit(jstate, *jbook, jpc)
        got = pstep.apply_commit(state, *pbook, ppc)
        _same_state(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        jstate, jbook, state, pbook = want[0], want[1:], got[0], got[1:]
    none = pstep.no_pending_commit(p)
    jnone = jstep.no_pending_commit(p)
    same = pstep.apply_commit(state, *pbook, none)
    _same_state(same[0], jstep.apply_commit(jstate, *jbook, jnone)[0])
