"""The port's fused replay under the paper's other policies, against the JAX
package, with zero tolerance: the plain replay of make_fused_replay(...,
"cpu") must equal tpusim's table replay (make_table_replay, the reference's
own pin for its fused kernel) on randomized create/delete mixes, in
placements, device masks, failure flags, per-event telemetry and final
state; two of the configurations are held against the Pallas kernel in
interpreter mode too."""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_fused_engine import _assert_replays_equal, _random_case
from tests.test_torch_types_trace import (
    port_specs,
    port_state,
    port_typical,
    port_types,
)
from tpusim.policies import make_policy
from tpusim.sim.pallas_engine import make_pallas_replay, supports
from tpusim.sim.table_engine import build_pod_types, make_table_replay
from tpusim_torch.sim import fused_engine as fe

# (policies, gpu_sel, dim_ext, norm, seed)
CASES = [
    ([("BestFitScore", 1000)], "best", "share", "max", 41),
    ([("GpuPackingScore", 1000)], "worst", "share", "max", 42),
    ([("GpuClusteringScore", 1000)], "best", "share", "max", 43),
    ([("PWRScore", 1000)], "PWRScore", "share", "max", 44),
    ([("DotProductScore", 1000)], "best", "merge", "max", 45),
    ([("DotProductScore", 1000)], "DotProductScore", "share", "pod", 46),
    ([("PWRScore", 500), ("FGDScore", 500)], "FGDScore", "share", "max", 47),
    ([("FGDScore", 1000)], "worst", "share", "max", 48),
]


def _case_id(case):
    policies, gpu_sel, dim_ext, norm, _ = case
    names = "+".join(f"{n}{w}" for n, w in policies)
    return f"{names}-{gpu_sel}-{dim_ext}-{norm}"


def _replay_both(jreplay, policies, gpu_sel, dim_ext, norm, seed):
    jstate, jtp, jpods, ev_kind, ev_pod, rank = _random_case(
        seed, pinned=seed % 2 == 0)
    jtypes = build_pod_types(jpods)
    want = jreplay(jstate, jpods, jtypes, ev_kind, ev_pod, jtp,
                   jax.random.PRNGKey(3), rank)
    got = fe.make_fused_replay(policies, gpu_sel, "cpu", dim_ext, norm)(
        port_state(jstate), port_specs(jpods), port_types(jtypes),
        torch.as_tensor(np.array(ev_kind)), torch.as_tensor(np.array(ev_pod)),
        port_typical(jtp), None, torch.as_tensor(np.array(rank)),
    )
    return got, want


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_replay_matches_table_engine(case):
    policies, gpu_sel, dim_ext, norm, seed = case
    jpolicies = [(make_policy(n, dim_ext, norm), w) for n, w in policies]
    got, want = _replay_both(make_table_replay(jpolicies, gpu_sel=gpu_sel),
                             *case)
    _assert_replays_equal(got, want)
    assert int((got.event_node >= 0).sum()) > 10


@pytest.mark.parametrize("case", [CASES[6], CASES[5]], ids=_case_id)
def test_plain_replay_matches_pallas_interpret(case):
    """The weighted PWR+FGD mix (normalisation, i32 sum, self-select) and
    DotProduct share/pod (tanh, self-select through the pool slot)."""
    policies, gpu_sel, dim_ext, norm, seed = case
    jpolicies = [(make_policy(n, dim_ext, norm), w) for n, w in policies]
    got, want = _replay_both(
        make_pallas_replay(jpolicies, gpu_sel=gpu_sel, interpret=True), *case)
    _assert_replays_equal(got, want)


def test_config_tables_stack_policies():
    """A two-policy config's score table is [2K, N], policy-major, and its
    share-device table is the selector's."""
    jstate, jtp, jpods, *_ = _random_case(49, 12, 20)
    state, tp = port_state(jstate), port_typical(jtp)
    types = port_types(build_pod_types(jpods))
    cfg = fe.make_config([("PWRScore", 500), ("FGDScore", 500)], "FGDScore")
    score, sdev, feas = fe.plain_init_tables(state, types, tp, cfg)
    k, n = types.num_types, state.num_nodes
    assert score.shape == (2 * k, n) and sdev.shape == feas.shape == (k, n)
    fgd_s, fgd_d = cfg.policies[1].column(state, types.stacked(),
                                          types.num_share, tp)
    pwr_s, _ = cfg.policies[0].column(state, types.stacked(),
                                      types.num_share, tp)
    assert torch.equal(score[:k], pwr_s) and torch.equal(score[k:], fgd_s)
    assert torch.equal(sdev, fgd_d)
    best = fe.plain_init_tables(state, types, tp,
                                fe.make_config([("PWRScore", 1)], "best"))
    assert (best[1] == -1).all()


@pytest.mark.parametrize("names", [
    ["FGDScore"], ["PWRScore"], ["BestFitScore"], ["GpuPackingScore"],
    ["GpuClusteringScore"], ["DotProductScore"], ["RandomScore"], ["Simon"],
    ["PWRScore", "FGDScore"], ["DotProductScore", "BestFitScore"],
    ["RandomScore", "FGDScore"],
])
def test_covers_what_pallas_supports(names):
    """make_config accepts a (policies, gpu_sel) config exactly where the
    reference's fused kernel does (pallas_engine.supports)."""
    for gpu_sel in ("best", "worst", "random", "FGDScore", "PWRScore",
                    "DotProductScore", "Simon"):
        want = supports([(make_policy(n), 1) for n in names], gpu_sel)
        try:
            fe.make_config([(n, 1) for n in names], gpu_sel)
            got = True
        except (NotImplementedError, ValueError):
            got = False
        assert got == want, (names, gpu_sel)
