"""The learned features' float32 sum orders (tpusim_torch.learn.policy
feature_plans, ops/frag.py plan_sum) against the JAX package's compiled
feature kernels, on the CPU.

At typical-pod counts whose sums XLA vectorises (the plans' vector loops)
and at tree-sum counts, on a seeded cluster whose typical-pod frequencies
are whole hundredths (their float32 subset sums land on and just by integer
percents): q3_sat_pct's and frag_pct's columns equal tpusim's
feature_policy kernels under jax.jit, as tpusim's engines run them, and the
three raw float32 sums equal those of the same expressions compiled by XLA,
bit for bit. Then the plans as the CUDA kernels read them (plan_words,
ReplayArgs.ln_plan), added in the kernels' loops (replay.cu plan_sum,
mirrored here in float32), equal plan_sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusim.learn.policy as jpolicy
import tpusim_torch.learn.policy as ppolicy
from tests.test_torch_types_trace import port_state, port_typical
from tpusim.constants import Q3_SATISFIED
from tpusim.ops.frag import frag_class, node_frag_score
from tpusim.policies.base import ScoreContext as JContext
from tpusim.types import TypicalPods as JTypical
from tpusim.types import make_node_state, make_pod
from tpusim_torch.ops.frag import plan_sum
from tpusim_torch.types import PodSpec

# counts with vector loops in q3_sat_pct's sum (5-32), in the Q3 amount's
# (16-32), and in the contributions' windows (64, 96); 48 a tree sum
COUNTS = (5, 8, 16, 20, 21, 23, 24, 32, 48, 64, 96)
NODES = 160


def _case(t: int, cents: bool):
    """NODES seeded nodes (1-8 devices of 0-1000 free milli, any cpu) and t
    typical pods whose requests put most nodes in several frag classes, of
    frequencies that are whole hundredths, about a quarter of them 0
    (`cents`: sums on and just by integer percents), else any float32 (sums
    whose last bits show their order)."""
    rng = np.random.default_rng(1000 + t)
    cnt = rng.choice([1, 2, 4, 8], NODES)
    state = make_node_state(cpu_cap=[96000] * NODES, mem_cap=[262144] * NODES,
                            gpu_cnt=cnt.tolist(), gpu_type=[0] * NODES)
    g = np.zeros((NODES, 8), np.int32)
    for i in range(NODES):
        g[i, :cnt[i]] = rng.choice([0, 100, 250, 500, 750, 1000], cnt[i])
    state = state._replace(
        gpu_left=jnp.asarray(g),
        cpu_left=jnp.asarray(rng.integers(0, 96000, NODES), jnp.int32))
    milli = rng.choice([0, 100, 250, 500, 1000], t)
    num = np.where(milli == 1000, rng.choice([1, 2, 4], t),
                   np.where(milli == 0, 0, 1))
    live = rng.random(t) < 0.75
    live[0] = True
    if cents:
        freq = np.bincount(rng.choice(np.flatnonzero(live), 100),
                           minlength=t).astype(np.float32) / np.float32(100)
    else:
        freq = rng.random(t).astype(np.float32) / np.float32(t / 2)
    tp = JTypical(cpu=jnp.asarray(rng.integers(0, 40000, t), jnp.int32),
                  gpu_milli=jnp.asarray(milli, jnp.int32),
                  gpu_num=jnp.asarray(num, jnp.int32),
                  gpu_mask=jnp.zeros(t, jnp.int32),
                  freq=jnp.asarray(freq.astype(np.float32)))
    return state, tp


def _raw_sat(state, tp):
    """q3_sat_pct's float32 sum as tpusim's feature kernel computes it
    (tpusim/learn/policy.py _q3_sat_pct under its vmap over nodes, without
    the floor)."""

    def one(cpu_left, gpu_left, gpu_type):
        cls = frag_class(cpu_left, gpu_left, gpu_type, tp)
        return jnp.where(cls == Q3_SATISFIED, tp.freq, 0.0).sum()

    return jax.vmap(one)(state.cpu_left, state.gpu_left, state.gpu_type)


def _raw_frag(state, tp):
    """frag_pct's frag score (ops/frag.py node_frag_score under the vmap):
    the contributions' sum minus the Q3 amount."""
    return jax.vmap(lambda c, g, y: node_frag_score(c, g, y, tp))(
        state.cpu_left, state.gpu_left, state.gpu_type)


@pytest.mark.parametrize("cents", (True, False))
@pytest.mark.parametrize("t", COUNTS)
def test_feature_sums_follow_tpusims_compiled_order(t, cents):
    """q3_sat_pct's and frag_pct's columns equal tpusim's feature kernels
    under jax.jit, and the port's q3_sat and frag_score its compiled raw
    float32 sums, bit for bit, at t typical pods."""
    state, tp = _case(t, cents)
    pstate, ptp = port_state(state), port_typical(tp)
    pod = make_pod(cpu=1000, mem=1024, gpu_milli=500, gpu_num=1)
    ctx = JContext(tp=tp, feasible=jnp.ones(NODES, bool), rng=None)
    types = PodSpec(*(torch.tensor([int(getattr(pod, f))], dtype=torch.int32)
                      for f in PodSpec._fields))
    for feature in ("q3_sat_pct", "frag_pct"):
        want = np.asarray(jax.jit(jpolicy.feature_policy(feature))(
            state, pod, ctx).raw_scores)
        got, _ = ppolicy.feature_column(feature)(pstate, types, 1, ptp)
        assert np.array_equal(got[0].numpy(), want), (feature, t)
    # each compiled alone, as each feature kernel is (compiled together,
    # XLA fuses the two sums into one loop of another order)
    sat = np.asarray(jax.jit(_raw_sat)(state, tp))
    frag = np.asarray(jax.jit(_raw_frag)(state, tp))
    assert np.array_equal(ppolicy.q3_sat(pstate, ptp).numpy().view(np.int32),
                          sat.view(np.int32))
    assert np.array_equal(
        ppolicy.frag_score(pstate, ptp).numpy().view(np.int32),
        frag.view(np.int32))


def _kernel_sum(words, x):
    """replay.cu plan_sum in float32 on the host: `words` one plan's
    PLAN_WORDS words, x [T, terms] every pod's terms (0 where none)."""
    f32 = np.float32
    window, lead, nst = words[1:4]
    count, terms = x.shape
    total = f32(0)
    for ws in range(-lead, count, window):
        acc, off = f32(0), 0
        for st in range(nst):
            vf, uf, m = words[4 + 3 * st:7 + 3 * st]
            lanes = vf * uf
            slot = []
            for lane in range(lanes):
                c = acc if lane == 0 else f32(0)
                for r in range(off + lane, off + m, lanes):
                    if 0 <= ws + r < count:
                        for k in range(terms):
                            c = f32(c + x[ws + r, k])
                slot.append(c)
            for q in range(1, uf):
                for lane in range(vf):
                    slot[lane] = f32(slot[q * vf + lane] + slot[lane])
            h = vf // 2
            while h >= 1:
                for lane in range(h):
                    slot[lane] = f32(slot[lane] + slot[lane + h])
                h //= 2
            acc, off = slot[0], off + m
        for t in range(max(ws + off, 0), min(ws + window, count)):
            for k in range(terms):
                acc = f32(acc + x[t, k])
        total = f32(total + acc)
    return total


@pytest.mark.parametrize("t", tuple(range(1, 33)) + (48, 64, 96, 1024))
def test_kernel_plan_words_drive_plan_sum_order(t):
    """The plans as the kernels read them (plan_words), added in the
    kernels' loops (every pod's terms, zeros for the classes and pods
    without one), equal plan_sum over the same terms bit for bit."""
    rng = np.random.default_rng(t)
    words = ppolicy.plan_words(t)
    per_sum = len(words) // 3
    for which, plan in enumerate(ppolicy.feature_plans(t)):
        w = words[which * per_sum:(which + 1) * per_sum]
        assert w[:3] == [plan.per_pod, plan.window, plan.lead]
        for _ in range(3 if t < 1024 else 1):
            x = rng.random((t, plan.per_pod)).astype(np.float32)
            x[rng.random(x.shape) < 0.6] = 0  # the absent classes and pods
            x *= np.float32(1e3) ** rng.integers(0, 3, x.shape)
            want = plan_sum(torch.as_tensor(x.reshape(-1, 1)), plan)
            assert np.float32(_kernel_sum(w, x)).view(np.int32) == \
                want.numpy()[0].view(np.int32), (t, which)
