"""The port's policy columns, normalisers, tanh and power model against the
JAX package, with zero tolerance: every plain column must equal what
tpusim's table builders (make_table_builders, i.e. the policies themselves)
put in the [K, N] tables, for every node x type, on an idle and on a partly
used random cluster."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import random_cluster, random_pods
from tests.test_torch_types_trace import (
    port_state,
    port_typical,
    port_types,
)
from tpusim.ops import energy as jenergy
from tpusim.policies import base as jbase
from tpusim.policies import make_policy as jmake_policy
from tpusim.sim.table_engine import build_pod_types, make_table_builders
from tpusim_torch.ops import energy as penergy
from tpusim_torch.policies import base as pbase
from tpusim_torch.policies import make_policy
from tpusim_torch.policies.dotprod import (
    DIM_EXT_METHODS,
    NORM_METHODS,
    xla_tanh_f32,
)

COLUMN_CASES = [
    ("BestFitScore", "share", "max"),
    ("GpuPackingScore", "share", "max"),
    ("GpuClusteringScore", "share", "max"),
    ("PWRScore", "share", "max"),
] + [("DotProductScore", d, n) for d in DIM_EXT_METHODS for n in NORM_METHODS]


def used_cluster(seed, num_nodes=48):
    """A random cluster, partly used: devices at random milli left, CPU
    taken, GPU-affinity counts set; and its typical pods."""
    rng = np.random.default_rng(seed)
    jstate, jtp = random_cluster(rng, num_nodes=num_nodes)
    cnt = np.asarray(jstate.gpu_cnt)
    real = np.arange(8)[None, :] < cnt[:, None]
    left = rng.choice([0, 100, 250, 500, 750, 900, 1000], size=(num_nodes, 8))
    cap = np.asarray(jstate.cpu_cap)
    aff = rng.choice([0, 0, 1, 2], size=(num_nodes, 9)) * (cnt[:, None] > 0)
    return jstate._replace(
        gpu_left=jnp.asarray(np.where(real, left, 0), jnp.int32),
        cpu_left=jnp.asarray(cap - rng.choice([0, 1000, 7000, 33000],
                                              num_nodes).clip(max=cap),
                             jnp.int32),
        aff_cnt=jnp.asarray(aff, jnp.int32),
    ), jtp


def _jax_tables(name, dim_ext, norm, jstate, jtypes, jtp):
    _, init = make_table_builders(
        [(jmake_policy(name, dim_ext, norm), 1000)], 0)
    s, d, _ = jax.jit(init)(jstate, jtypes, jtp, jax.random.PRNGKey(0))
    return np.asarray(s)[0], np.asarray(d)


@pytest.mark.parametrize("name,dim_ext,norm", COLUMN_CASES,
                         ids=lambda v: str(v))
def test_column_matches_table_builders(name, dim_ext, norm):
    """Raw score and share-device pick of every (type, node) pair."""
    policy = make_policy(name, dim_ext, norm)
    for seed, used in ((0, False), (1, True), (2, True)):
        rng = np.random.default_rng(100 + seed)
        jstate, jtp = (used_cluster(seed) if used
                       else random_cluster(rng, num_nodes=48))
        jtypes = build_pod_types(random_pods(rng, num_pods=80))
        types = port_types(jtypes)
        got = policy.column(port_state(jstate), types.stacked(),
                            types.num_share, port_typical(jtp))
        want = _jax_tables(name, dim_ext, norm, jstate, jtypes, jtp)
        for what, g, w in zip(("raw", "sdev"), got, want):
            assert g.dtype == torch.int32
            bad = np.argwhere(g.numpy() != w)
            assert bad.size == 0, (
                f"seed {seed} {what}: {len(bad)} of {w.size} (type, node) "
                f"entries differ, first {bad[:3].tolist()}: "
                f"{g.numpy()[tuple(bad[0])]} != {w[tuple(bad[0])]}")


@pytest.mark.parametrize("mode", ["minmax", "pwr"])
def test_normalizers_match_jax(mode):
    """Random rows, all-equal rows, rows with one or no feasible entry,
    and a range wide enough to wrap the int32 product."""
    rng = np.random.default_rng(5)
    rows = [rng.integers(-3000, 101, 64) for _ in range(20)]
    rows += [np.full(64, 7), np.full(64, -250)]
    rows += [rng.integers(-(2**31) + 1, 2**31 - 1, 64)]
    jfn = {"minmax": jbase.minmax_normalize_i32,
           "pwr": jbase.pwr_normalize_i32}[mode]
    pfn = {"minmax": pbase.minmax_normalize_i32,
           "pwr": pbase.pwr_normalize_i32}[mode]
    for i, row in enumerate(rows):
        for feas in (rng.random(64) < 0.6, np.eye(64, dtype=bool)[3],
                     np.zeros(64, bool)):
            scores = row.astype(np.int32)
            want = np.asarray(jax.jit(jfn)(jnp.asarray(scores),
                                           jnp.asarray(feas)))
            got = pfn(torch.as_tensor(scores), torch.as_tensor(feas))
            assert np.array_equal(got.numpy(), want), i
            got = pbase.normalize(mode, torch.as_tensor(scores),
                                  torch.as_tensor(feas))
            assert np.array_equal(got.numpy(), want), i


def test_xla_tanh_matches_jnp_tanh():
    """About 1M seeded float32 inputs: dense in [-2, 2], the small-|x|
    pass-through, the clamp, and wide magnitudes."""
    rng = np.random.default_rng(7)
    x = np.concatenate([
        rng.uniform(-2, 2, 600_000),
        rng.uniform(-0.001, 0.001, 100_000),
        rng.uniform(-0.0004, 0.0004, 50_000),
        rng.uniform(-12, 12, 200_000),
        rng.standard_normal(50_000) * 1e3,
        [0.0, -0.0, 0.0004, -0.0004, 7.99881172180175781, 8.0, -8.0, 1e30],
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.tanh)(jnp.asarray(x)))
    got = xla_tanh_f32(torch.as_tensor(x)).numpy()
    bad = np.flatnonzero(got.view(np.int32) != want.view(np.int32))
    assert bad.size == 0, f"{bad.size} differ, first x={x[bad[:3]]}"


def test_energy_matches_jax():
    """Per-node CPU and GPU watts and the busy delta on partly used random
    clusters, over every CPU model and GPU model in the tables."""
    for seed in (0, 1):
        jstate, _ = used_cluster(seed, num_nodes=64)
        rng = np.random.default_rng(seed)
        jstate = jstate._replace(
            cpu_type=jnp.asarray(rng.integers(0, 6, 64), jnp.int32),
            gpu_type=jnp.where(jstate.gpu_cnt > 0,
                               jnp.asarray(rng.integers(0, 14, 64)), -1
                               ).astype(jnp.int32),
            cpu_cap=jnp.asarray(rng.integers(1000, 200_000, 64), jnp.int32),
        )
        jstate = jstate._replace(cpu_left=jnp.asarray(
            rng.integers(0, np.asarray(jstate.cpu_cap) + 1), jnp.int32))
        s = port_state(jstate)
        want = jax.jit(jax.vmap(jenergy.node_power))(
            jstate.cpu_left, jstate.cpu_cap, jstate.gpu_left,
            jstate.gpu_cnt, jstate.gpu_type, jstate.cpu_type)
        got = penergy.node_power(s.cpu_left, s.cpu_cap, s.gpu_left,
                                 s.gpu_cnt, s.gpu_type, s.cpu_type)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        busy = jax.jit(jax.vmap(jenergy.gpu_busy_delta_watts))(
            jstate.gpu_type)
        assert np.array_equal(
            penergy.gpu_busy_delta_watts(s.gpu_type).numpy(),
            np.asarray(busy))
