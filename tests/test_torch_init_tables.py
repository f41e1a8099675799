"""The plain table build, plain_init_tables (what the init_tables kernel is
held to on the card), against the JAX package's table builders, with zero
tolerance, on the states where the kernel branches: GPU nodes whose devices
hold 1, 2, 3 or 8 distinct free values, CPU-only nodes, share types that
fit no device, whole types whose Sub takes devices of different free
values, typical pods of frequency 0, and node counts on either side of the
kernel's 32-node tile; and the type order from which the kernel cuts its
batches. The states come from chip_smoke.init_case_fields,
which the card's checks use too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    INIT_NODES, INIT_ROWS, init_case, init_case_fields, init_config,
)
from tests.test_torch_types_trace import port_typical, port_types
from tpusim.policies import make_policy
from tpusim.sim.table_engine import build_pod_types, make_table_builders
from tpusim.types import NodeState, PodSpec, TypicalPods
from tpusim_torch import types as tt
from tpusim_torch.sim import fused_engine as fe


def _jax_case(seed, num_nodes):
    node, pods, typical = init_case_fields(seed, num_nodes)

    def tree(cls, fields, floats=()):
        return cls(**{k: jnp.asarray(np.asarray(
            v, np.float32 if k in floats else np.int32))
            for k, v in fields.items()})

    return (tree(NodeState, node), build_pod_types(tree(PodSpec, pods)),
            tree(TypicalPods, typical, ("freq",)))


def _jax_tables(cfg, jstate, jtypes, jtp):
    """(score [n_pol * K, N], sdev, feas) through make_table_builders."""
    policies = [(make_policy(p.name, cfg.dim_ext, cfg.norm), w)
                for p, w in zip(cfg.policies, cfg.weights)]
    _, init = make_table_builders(policies, cfg.sel_idx)
    s, d, f = jax.jit(init)(jstate, jtypes, jtp, jax.random.PRNGKey(0))
    s = np.asarray(s)
    return (s.reshape(-1, s.shape[-1]), np.asarray(d),
            np.asarray(f).astype(np.int32))


@pytest.mark.parametrize("nodes", INIT_NODES)
@pytest.mark.parametrize("row", INIT_ROWS)
def test_plain_init_tables_matches_table_builders(row, nodes):
    seed = 400 + INIT_NODES.index(nodes)
    jstate, jtypes, jtp = _jax_case(seed, nodes)
    cfg = init_config(row)
    node, _, _ = init_case_fields(seed, nodes)
    got = fe.plain_init_tables(tt.node_state_from_numpy(node, "cpu"),
                               port_types(jtypes), port_typical(jtp), cfg)
    for name, g, w in zip(("score", "sdev", "feas"), got,
                          _jax_tables(cfg, jstate, jtypes, jtp)):
        assert g.shape == w.shape, name
        bad = np.argwhere(g.numpy() != w)
        assert bad.size == 0, (
            f"{name}: {len(bad)} of {w.size} entries differ, first "
            f"{bad[:3].tolist()}")


def test_init_cases_reach_every_branch():
    """The largest case holds what the docstring promises, and the port's
    pod types of it equal the JAX package's."""
    seed, nodes = 400 + INIT_NODES.index(640), 640
    state, types, tp = init_case(seed, nodes, "cpu")
    g, cnt = state.gpu_left.numpy(), state.gpu_cnt.numpy()
    distinct = {len(set(row[:c])) for row, c in zip(g, cnt) if c}
    assert {1, 2, 3, 8} <= distinct and (cnt == 0).any()
    assert (tp.freq.numpy() == 0).any() and (tp.freq.numpy() > 0).any()
    share = types.share
    best = g.max(1)
    assert any((best < m).mean() > 0.5 for m in share.gpu_milli.tolist())
    # a fractional request on several devices: Sub may take unequal values
    whole = types.whole
    assert ((whole.gpu_num > 1) & (whole.gpu_milli < 1000)).any()
    mixed = [(row[:c] >= 300).sum() >= 2 and len(set(row[:c][row[:c] >= 300]))
             > 1 for row, c in zip(g, cnt) if c]
    assert any(mixed)
    _, jtypes, _ = _jax_case(seed, nodes)
    want = port_types(jtypes)
    for a, b in zip(types.stacked(), want.stacked()):
        assert np.array_equal(a.numpy(), b.numpy())
    assert types.num_share == want.num_share


@pytest.mark.parametrize("nodes", INIT_NODES[-2:])
def test_type_batches_group_fgd_keys(nodes):
    """The kernel's type order, from which it cuts its batches: every type
    once, FGD's key (share or whole, milli, GPU count) ascending, ties by
    index, so that the types of one key stand together."""
    _, types, _ = init_case(400 + INIT_NODES.index(nodes), nodes, "cpu")
    order = fe.type_order(types)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(types.num_types))
    specs = types.stacked()
    keys = [(int(k >= types.num_share), int(specs.gpu_milli[k]),
             int(specs.gpu_num[k]), int(k)) for k in order.tolist()]
    assert keys == sorted(keys)
    assert len({key[:3] for key in keys}) < types.num_types
