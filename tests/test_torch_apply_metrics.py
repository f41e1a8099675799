"""The metrics post-pass on small clusters against the JAX package's, bit
for bit: the initial frag total, the initial per-node rows and the
per-event rows follow the orders XLA's CPU build gives them when no axis
is longer than 32 (tpusim_torch.ops.frag: `node_stages`, `pod_stages`,
`row_stages`). The clusters are partly used, the typical pods seeded like
tests/test_torch_report.py's, the telemetry a seeded stream of creations
and deletions over 512 events (the JAX driver's event bucket)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import random_cluster
from tests.test_torch_types_trace import (
    jfields,
    port_specs,
    port_state,
    port_typical,
)
from tpusim.sim import metrics as jmetrics
from tpusim.types import NodeState as JNodeState
from tpusim.types import PodSpec as JPodSpec
from tpusim.types import TypicalPods as JTypicalPods
from tpusim_torch.sim.metrics import compute_event_metrics

NODES = (1, 2, 5, 20, 32)
TYPICAL = (1, 4, 8, 9, 12, 16, 17, 24, 32)
EVENTS = 512


def _case(n, t):
    rng = np.random.default_rng(1000 * n + t)
    state, _ = random_cluster(rng, n)
    f = jfields(state)
    slot = np.arange(8)[None, :] < f["gpu_cnt"][:, None]
    take = rng.choice([0, 0, 100, 250, 500, 750, 1000], f["gpu_left"].shape)
    f["gpu_left"] = np.where(slot, f["gpu_left"] - take, 0).astype(np.int32)
    f["cpu_left"] = (f["cpu_left"] - rng.integers(0, 4, n) * 8000).astype(
        np.int32)
    state = JNodeState(**{k: jnp.asarray(v) for k, v in f.items()})
    # typical pods as tests/test_torch_report.py seeds them, the last few
    # of frequency 0 when there are more than five
    milli = rng.choice([0, 100, 250, 500, 1000], t)
    num = np.where(milli == 1000, rng.integers(1, 9, t), (milli > 0) * 1)
    freq = rng.random(t).astype(np.float32)
    if t > 5:
        freq[t - 5:] = 0
    freq /= freq.sum()
    cols = (rng.integers(0, 64000, t), milli, num,
            rng.choice([0, 0, 1 << 4, (1 << 7) | (1 << 8)], t))
    tp = JTypicalPods(*(jnp.asarray(c, jnp.int32) for c in cols),
                      jnp.asarray(freq))
    # a stream of creations and deletions, each on a node and devices of
    # that node, some touching no node
    p = EVENTS
    gpu_milli = rng.choice([0, 100, 250, 500, 1000], p)
    gpu_num = np.where(gpu_milli == 1000, rng.integers(1, 3, p),
                       (gpu_milli > 0) * 1)
    specs = JPodSpec(*(jnp.asarray(a, jnp.int32) for a in (
        rng.choice([1000, 2000, 4000], p), np.full(p, 1024), gpu_milli,
        gpu_num, np.zeros(p), np.full(p, -1))))
    kind = (rng.random(EVENTS) < 0.2).astype(np.int32)  # 1 = a deletion
    node = rng.integers(0, n, EVENTS).astype(np.int32)
    node[rng.random(EVENTS) < 0.1] = -1
    cnt = f["gpu_cnt"][np.maximum(node, 0)]
    dev = (np.arange(8)[None, :] < np.maximum(cnt, 1)[:, None]) & (
        rng.random((EVENTS, 8)) < 0.3)
    dev &= node[:, None] >= 0
    pods = np.arange(EVENTS, dtype=np.int32)
    return state, specs, kind, pods, node, dev, tp


@pytest.mark.parametrize("t", TYPICAL)
@pytest.mark.parametrize("n", NODES)
def test_postpass_matches_jax_on_small_clusters(n, t):
    """Every field of compute_event_metrics bit-equal to the JAX package's
    on n nodes and t typical pods. (One typical pod has frequency 1, so
    its sums are of whole milli values, exact in any order.)"""
    state, specs, kind, pods, node, dev, tp = _case(n, t)
    want = jmetrics.compute_event_metrics(
        state, specs, jnp.asarray(kind), jnp.asarray(pods),
        jnp.asarray(node), jnp.asarray(dev), tp)
    got = compute_event_metrics(
        port_state(state), port_specs(specs), torch.as_tensor(kind),
        torch.as_tensor(pods), torch.as_tensor(node), torch.as_tensor(dev),
        port_typical(tp))
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
