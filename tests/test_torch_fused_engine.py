"""The port's fused replay against the JAX package, with zero tolerance:
plain_replay (the CPU side of the replay wrapper) must equal
make_pallas_replay(interpret=True) on randomized create/delete mixes and
make_table_replay on a prefix of the openb FGD trace, in placements, device
masks, failure flags, per-event telemetry and final state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import random_cluster, random_pods
from tests.test_table_engine import _events_with_deletes
from tests.test_torch_types_trace import (
    assert_tree_equal,
    openb_prepared,
    port_specs,
    port_state,
    port_typical,
    port_types,
)
from tpusim.io.trace import build_events, pods_to_specs
from tpusim.policies import make_policy
from tpusim.sim.pallas_engine import make_pallas_replay
from tpusim.sim.table_engine import build_pod_types, make_table_replay
from tpusim_torch.sim import fused_engine as fe


def _assert_replays_equal(got, want):
    """Every output of a port ReplayResult against a JAX ReplayResult."""
    for field in ("placed_node", "dev_mask", "ever_failed", "event_node",
                  "event_dev"):
        g = getattr(got, field).cpu().numpy()
        w = np.asarray(getattr(want, field))
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{field} differs first at {bad[:3].tolist()}"
    assert_tree_equal(got.state, want.state)


def _random_case(seed, num_nodes=24, num_pods=40, pinned=False):
    rng = np.random.default_rng(seed)
    jstate, jtp = random_cluster(rng, num_nodes=num_nodes)
    jpods = random_pods(rng, num_pods=num_pods)
    if pinned:  # a few nodeSelector-pinned pods, one to a node that is full
        pin = np.full(num_pods, -1, np.int32)
        pin[[2, 11, 23]] = [3, 0, num_nodes - 1]
        jpods = jpods._replace(pinned=jnp.asarray(pin))
    ev_kind, ev_pod = _events_with_deletes(num_pods, rng)
    rank = jnp.asarray(rng.permutation(num_nodes).astype(np.int32))
    return jstate, jtp, jpods, ev_kind, ev_pod, rank


@pytest.mark.parametrize(
    "seed,gpu_sel,pinned",
    [(11, "FGDScore", False), (12, "FGDScore", True), (13, "best", False)],
)
def test_plain_replay_matches_pallas_interpret(seed, gpu_sel, pinned):
    jstate, jtp, jpods, ev_kind, ev_pod, rank = _random_case(seed,
                                                             pinned=pinned)
    jtypes = build_pod_types(jpods)
    want = make_pallas_replay([(make_policy("FGDScore"), 1000)],
                              gpu_sel=gpu_sel, interpret=True)(
        jstate, jpods, jtypes, ev_kind, ev_pod, jtp,
        jax.random.PRNGKey(3), rank,
    )
    got = fe.make_fused_replay([("FGDScore", 1000)], gpu_sel, "cpu")(
        port_state(jstate), port_specs(jpods), port_types(jtypes),
        torch.as_tensor(np.array(ev_kind)), torch.as_tensor(np.array(ev_pod)),
        port_typical(jtp), None, torch.as_tensor(np.array(rank)),
    )
    _assert_replays_equal(got, want)
    assert (got.event_node >= 0).any() and got.ever_failed.any() == \
        bool(np.asarray(want.ever_failed).any())


def test_plain_replay_matches_table_engine_openb_prefix():
    """The first 256 events of the paper's openb FGD trace."""
    jsim, jtr, _, _ = openb_prepared()
    jspecs = pods_to_specs(jtr)
    jtypes = build_pod_types(jspecs)
    ev_kind, ev_pod = (a[:256] for a in build_events(jtr))
    want = make_table_replay([(make_policy("FGDScore"), 1000)],
                             gpu_sel="FGDScore")(
        jsim.init_state, jspecs, jtypes, jnp.asarray(ev_kind),
        jnp.asarray(ev_pod), jsim.typical, jax.random.PRNGKey(42), jsim.rank,
    )
    got = fe.make_fused_replay([("FGDScore", 1000)], "FGDScore", "cpu")(
        port_state(jsim.init_state), port_specs(jspecs), port_types(jtypes),
        torch.as_tensor(ev_kind), torch.as_tensor(ev_pod),
        port_typical(jsim.typical), None,
        torch.as_tensor(np.array(jsim.rank)),
    )
    _assert_replays_equal(got, want)
    assert int((got.event_node >= 0).sum()) > 200


def test_wrappers_take_plain_path_on_cpu():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    jstate, jtp, jpods, ev_kind, ev_pod, rank = _random_case(21, 16, 24)
    state, tp = port_state(jstate), port_typical(jtp)
    types = port_types(build_pod_types(jpods))
    cfg = fe.make_config([("FGDScore", 1000)], "FGDScore")
    fe.reset_launch_counts()
    tables = fe.init_tables(state, types, tp, cfg)
    for got, want in zip(tables, fe.plain_init_tables(state, types, tp, cfg)):
        assert torch.equal(got, want)
    args = (state, port_specs(jpods), types,
            torch.as_tensor(np.array(ev_kind)),
            torch.as_tensor(np.array(ev_pod)), tp,
            torch.as_tensor(np.array(rank)), tables, cfg)
    got, want = fe.replay(*args), fe.plain_replay(*args)
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert fe.init_tables.launches == 0 and fe.replay.launches == 0
    # the replay leaves its inputs unchanged
    assert torch.equal(state.gpu_left, port_state(jstate).gpu_left)


@pytest.mark.parametrize(
    "policies,gpu_sel",
    [([("RandomScore", 1000)], "best"),
     ([("Simon", 1000)], "best"),
     ([("FGDScore", 1000)], "random"),
     ([("RandomScore", 500), ("FGDScore", 500)], "FGDScore")],
)
def test_uncovered_configs_raise(policies, gpu_sel):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fe.make_fused_replay(policies, gpu_sel, "cpu")


@pytest.mark.parametrize(
    "policies,gpu_sel,match",
    [([("BestFitScore", 1000)], "PWRScore", "gpu_sel"),
     ([("FGDScore", 1000)], "Best", "gpu_sel"),
     ([("FGDScore", 2**31)], "FGDScore", "int32")],
)
def test_unknown_gpu_sel_is_a_value_error(policies, gpu_sel, match):
    """A self-select gpu_sel naming no enabled policy, or no method at all,
    is refused as make_pallas_replay refuses it; so is a weight the
    kernel's int32 descriptor cannot hold."""
    with pytest.raises(ValueError, match=match):
        fe.make_fused_replay(policies, gpu_sel, "cpu")


def test_replay_rejects_out_of_range_indices():
    """Event indices the kernel would read without bounds checks fail on
    the host, before the stream moves to the device."""
    jstate, jtp, jpods, ev_kind, ev_pod, rank = _random_case(22, 8, 6)
    replayer = fe.make_fused_replay([("FGDScore", 1000)], "FGDScore", "cpu")
    kind = torch.as_tensor(np.array(ev_kind))
    pod = torch.as_tensor(np.array(ev_pod))

    def replay(kind=kind, pod=pod):
        return replayer(port_state(jstate), port_specs(jpods),
                        port_types(build_pod_types(jpods)), kind, pod,
                        port_typical(jtp), None,
                        torch.as_tensor(np.array(rank)))

    with pytest.raises(ValueError, match="shape mismatch"):
        replay(pod=pod[:-1])
    with pytest.raises(ValueError, match="out of range"):
        replay(pod=torch.full_like(pod, -1))
    with pytest.raises(ValueError, match="unknown kind"):
        replay(kind=torch.full_like(kind, 7))
