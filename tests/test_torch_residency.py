"""Where the port's replay tables live (tpusim_torch.sim.residency, the
Hopper analogue of the JAX package's residency probes) and the Simulator's
table_residency knob: the L2 rule at openb, at 100k nodes and at its exact
boundary; the blocked replay's extra bytes against its summaries; "hbm"
(the blocked replay) against "vmem" (the flat one) through
Simulator.run() on an openb prefix; a bad knob."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_driver import ROWS, method_configs
from tests.test_torch_hbm_engine import _port_args, _random_case
from tests.test_torch_types_trace import openb_rows
from tpusim_torch import bench_scale as pbench
from tpusim_torch.parallel.sharding import pad_nodes
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he
from tpusim_torch.sim import residency
from tpusim_torch.sim.driver import Simulator as PSimulator

_MIB = 2**20


@pytest.mark.parametrize("n,k,num_pol,l2,want", [
    (1213, 151, 1, 50 * _MIB, "vmem"),  # openb, FGD
    (1213, 151, 2, 50 * _MIB, "vmem"),  # openb, PWR+FGD
    (100_000, 151, 1, 50 * _MIB, "hbm"),  # the scale configuration
    (100_000, 151, 1, residency.table_bytes(100_000, 151, 1), "vmem"),
    (100_000, 151, 1, residency.table_bytes(100_000, 151, 1) - 1, "hbm"),
], ids=["openb", "openb-2pol", "100k", "boundary", "boundary-1"])
def test_select_residency(n, k, num_pol, l2, want):
    assert residency.select_residency(n, k, num_pol, l2) == want
    assert residency.table_bytes(n, k, num_pol) == \
        (num_pol + 2) * k * (-(-n // 128) * 128) * 4


@pytest.mark.parametrize("setting,randomized,l2,want", [
    ("auto", False, 50 * _MIB, "vmem"),
    ("auto", False, 1, "hbm"),
    ("auto", False, None, "vmem"),  # no card
    ("hbm", False, 50 * _MIB, "hbm"),
    ("vmem", False, 1, "vmem"),
    ("auto", True, 1, "vmem"),
    ("hbm", True, 50 * _MIB, "vmem"),
    ("hbm", True, None, "vmem"),
], ids=["auto", "auto-small-l2", "auto-no-card", "hbm", "vmem",
        "random-auto", "random-hbm", "random-hbm-no-card"])
def test_replay_tier(setting, randomized, l2, want):
    """The tier choice: a randomized configuration runs the flat replay
    whatever the setting; else the setting, or the L2 rule under auto."""
    assert residency.replay_tier(setting, randomized, 1213, 151, 1,
                                 l2) == want


def test_blocked_extra_bytes_match_summaries():
    """blocked_extra_bytes counts the summaries and the padded rank."""
    jstate, jtp, jpods, *_, rank = _random_case(72, 300, 100)
    state, _, types, _, _, tp, _, rank = _port_args(
        jstate, jtp, jpods, jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
        rank)
    cfg = fe.make_config([("PWRScore", 500), ("FGDScore", 500)], "FGDScore")
    padded, rank_p = pad_nodes(state, rank, 128)
    s = he.plain_init_summaries(fe.plain_init_tables(padded, types, tp, cfg),
                                rank_p, cfg)
    held = sum(x.numel() * 4 for x in s) + rank_p.numel() * 4
    nn = residency.num_normalized(cfg.policies)
    assert nn == 1
    assert residency.blocked_extra_bytes(300, types.num_types, nn) == held


@pytest.mark.parametrize("row", ["06-FGD", "05-BestFit"])
def test_table_residency_knob(row):
    """"hbm" (the blocked replay) against "vmem" (the flat one) through
    Simulator.run() on the first 256 openb pods: the same placements,
    masks and final state, and the Simulator names the kernel that ran."""
    _, _, pnodes, ppods = openb_rows()
    _, pcfg = method_configs(ROWS[row], tune=0.0)
    runs = {}
    for tier in ("vmem", "hbm"):
        sim = PSimulator(pnodes, dataclasses.replace(
            pcfg, table_residency=tier), device="cpu")
        sim.set_workload_pods(ppods[:256])
        runs[tier] = (sim, sim.run())
    (flat_sim, flat), (blocked_sim, blocked) = runs["vmem"], runs["hbm"]
    assert np.array_equal(blocked.placed_node, flat.placed_node)
    assert np.array_equal(blocked.dev_mask, flat.dev_mask)
    for a, b in zip(blocked.state, flat.state):
        assert torch.equal(a, b)
    assert (flat_sim.last_engine, flat_sim.last_residency) == \
        ("plain_replay", "vmem")
    assert flat_sim.last_kernel_stats is None
    assert (blocked_sim.last_engine, blocked_sim.last_residency) == \
        ("plain_replay_blocked", "hbm")
    assert blocked_sim.last_kernel_stats[:2] == [0, 0]
    assert any("plain_replay_blocked (hbm residency)" in line
               for line in blocked_sim.log.lines)


def test_bad_table_residency_raises():
    _, _, pnodes, _ = openb_rows()
    cfg = dataclasses.replace(pbench.scale_config(), table_residency="l2")
    with pytest.raises(ValueError, match="table_residency"):
        PSimulator(pnodes[:10], cfg, device="cpu")
