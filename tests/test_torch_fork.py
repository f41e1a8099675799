"""Warm-state forks of the port's chunked replay
(Simulator.schedule_pods_fork) against tpusim's, with zero tolerance: the
counterparts of tests/test_fork.py. A warm fork resumed from the base
run's checkpoint ladder equals the cold replay of the spliced stream and
tpusim's fork; it walks back to the rung at or before the fork event; a
weight change finds no source; checkpoint_keep bounds the ladder; the fork
tail's event kinds are tpusim's; the fork guards raise as tpusim's do."""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_types_trace import assert_tree_equal
from tpusim.io.trace import NodeRow as JNodeRow
from tpusim.io.trace import PodRow as JPodRow
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim_torch.io.storage import iter_checkpoints
from tpusim_torch.io.trace import NodeRow, PodRow, build_events
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.engine import EV_CREATE, EV_DELETE

# a tail over the base workload's pods: delete two placed pods, create one
# of them again
TAIL_KIND = [EV_DELETE, EV_DELETE, EV_CREATE]
TAIL_POD = [0, 3, 0]


def _rows():
    rng = np.random.default_rng(11)
    nodes = [(f"n{i}", 32000, 131072, int(g), "V100M16" if g else "")
             for i, g in enumerate(rng.choice([0, 2, 4, 8], 10))]
    pods = [(f"p{i}", int(rng.choice([1000, 4000])), 1024,
             int(rng.choice([0, 1])), 500) for i in range(24)]
    return nodes, pods


def _sim(ckdir, every=4, keep=-1, weight=1000, engine="auto"):
    nodes, _ = _rows()
    return Simulator([NodeRow(*r) for r in nodes], SimulatorConfig(
        policies=(("FGDScore", weight),), gpu_sel_method="FGDScore",
        checkpoint_every=every, checkpoint_keep=keep,
        checkpoint_dir=str(ckdir), engine=engine), device="cpu")


def _pods():
    return [PodRow(*p) for p in _rows()[1]]


def _assert_equal(r0, r1):
    assert np.array_equal(r0.placed_node, r1.placed_node)
    assert np.array_equal(r0.dev_mask, r1.dev_mask)
    assert np.array_equal(r0.creation_rank, r1.creation_rank)
    for a, b in zip(r0.state, r1.state):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_fork(fev, weight=1000):
    """tpusim's schedule_pods_fork of the same inputs, cold (no base)."""
    import tempfile

    nodes, pods = _rows()
    sim = JSimulator([JNodeRow(*r) for r in nodes], JConfig(
        policies=(("FGDScore", weight),), gpu_sel_method="FGDScore",
        checkpoint_every=4, checkpoint_keep=-1,
        checkpoint_dir=tempfile.mkdtemp()))
    return sim.schedule_pods_fork([JPodRow(*p) for p in pods], fev,
                                  TAIL_KIND, TAIL_POD)


def _assert_matches_jax(got, want):
    assert np.array_equal(got.placed_node, np.asarray(want.placed_node))
    assert np.array_equal(got.dev_mask, np.asarray(want.dev_mask))
    assert np.array_equal(got.creation_rank, np.asarray(want.creation_rank))
    assert_tree_equal(got.state, want.state)


def test_fork_warm_equals_cold_and_tpusim(tmp_path):
    """A fork resumed mid-trace from the base ladder equals the cold replay
    of the spliced stream and tpusim's fork, and ran only the tail and the
    walk-back; the cold fork says [Degrade]."""
    pods = _pods()
    e = len(build_events(pods, False)[0])
    fev = e - 2
    _sim(tmp_path / "a").schedule_pods(pods)
    warm = _sim(tmp_path / "a")
    rw = warm.schedule_pods_fork(pods, fev, TAIL_KIND, TAIL_POD)
    cold = _sim(tmp_path / "b")
    rc = cold.schedule_pods_fork(pods, fev, TAIL_KIND, TAIL_POD)
    _assert_equal(rw, rc)
    _assert_matches_jax(rw, _jax_fork(fev))
    assert warm.last_fork["degrade"] is False
    assert warm.last_fork["source_cursor"] == 20
    assert warm.last_fork["events_executed"] <= len(TAIL_KIND) + 4
    assert warm.last_fork["events_total"] == fev + len(TAIL_KIND)
    assert cold.last_fork["degrade"] is True
    assert cold.last_fork["source_cursor"] == 0
    assert any("[Degrade]" in line and "fork source" in line
               for line in cold.log.lines)


def test_fork_boundary_and_midchunk_walkback(tmp_path):
    """A fork on a rung resumes there; a fork between rungs walks back to
    the rung below, never up; both equal their cold replays and tpusim."""
    pods = _pods()
    _sim(tmp_path / "a").schedule_pods(pods)
    for fev, rung in ((8, 8), (10, 8)):
        warm = _sim(tmp_path / "a")
        got = warm.schedule_pods_fork(pods, fev, TAIL_KIND, TAIL_POD)
        assert warm.last_fork["source_cursor"] == rung
        cold = _sim(tmp_path / f"cold{fev}")
        _assert_equal(got, cold.schedule_pods_fork(pods, fev, TAIL_KIND,
                                                   TAIL_POD))
        _assert_matches_jax(got, _jax_fork(fev))


def test_weight_change_fork_finds_no_source(tmp_path):
    """The weights are part of the run digest: a fork under other weights
    finds no base checkpoint and replays in full, correctly, under its
    own weights."""
    pods = _pods()
    _sim(tmp_path / "a", weight=1000).schedule_pods(pods)
    other = _sim(tmp_path / "a", weight=500)
    got = other.schedule_pods_fork(pods, 8, TAIL_KIND, TAIL_POD)
    assert other.last_fork["degrade"] is True
    assert other.last_fork["source_cursor"] == 0
    _assert_matches_jax(got, _jax_fork(8, 500))


@pytest.mark.parametrize("keep,rungs", [(0, 0), (-1, None), (2, 2)])
def test_checkpoint_keep_retention(tmp_path, keep, rungs):
    """0 prunes the ladder when the run ends, -1 keeps every rung (every,
    2 every, ... below the event count), N > 0 the newest N."""
    pods = _pods()
    e = len(build_events(pods, False)[0])
    sim = _sim(tmp_path, keep=keep)
    sim.schedule_pods(pods)
    ladder = iter_checkpoints(str(tmp_path), sim.last_run_digest)
    want = (e - 1) // 4 if rungs is None else rungs
    assert len(ladder) == want
    assert [c for c, _ in ladder] == sorted((c for c, _ in ladder),
                                            reverse=True)


def test_fork_ev_kinds_pin():
    """A fork tail's kinds are tpusim's event vocabulary (the service's
    fork-tail wire format names them)."""
    from tpusim.svc.jobs import FORK_EV_KINDS

    assert (EV_CREATE, EV_DELETE) == FORK_EV_KINDS


@pytest.mark.parametrize("case", ["no-chunks", "pallas", "sequential",
                                  "out-of-range"])
def test_fork_guards_raise(tmp_path, case):
    """tpusim's fork guards: the chunked path, the table (or auto) engine,
    the fork event within the base stream."""
    pods = _pods()
    sim = {"no-chunks": lambda: _sim(tmp_path, every=0),
           "pallas": lambda: _sim(tmp_path, engine="pallas"),
           "sequential": lambda: _sim(tmp_path, engine="sequential"),
           "out-of-range": lambda: _sim(tmp_path)}[case]()
    fev = 999 if case == "out-of-range" else 8
    match = {"no-chunks": "chunked path", "pallas": "not 'pallas'",
             "sequential": "not 'sequential'",
             "out-of-range": "outside the base stream"}[case]
    with pytest.raises(ValueError, match=match):
        sim.schedule_pods_fork(pods, fev, TAIL_KIND, TAIL_POD)


@pytest.mark.slow
def test_fork_digests_pin_chip_smoke(tmp_path):
    """chip_smoke.FORK_SHA256: tpusim's replay of the prepared openb 06-FGD
    trace spliced at CKPT_FORK_EVENT with FORK_TAIL (its run_events, as its
    schedule_pods runs a stream), and the port's warm fork of the same
    stream on the CPU."""
    import dataclasses
    import hashlib

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from tests.test_torch_driver import ROWS, method_configs
    from tests.test_torch_types_trace import openb_rows
    from tpusim.io.trace import build_events as jbuild_events
    from tpusim.io.trace import pods_to_specs as jpods_to_specs

    def digest(a, dtype):
        return hashlib.sha256(np.ascontiguousarray(a, dtype).tobytes()) \
            .hexdigest()

    fev = chip_smoke.CKPT_FORK_EVENT
    kinds, idx = (np.asarray(t, np.int32) for t in chip_smoke.FORK_TAIL)
    jn, jp, pn, pp = openb_rows()
    jcfg, pcfg = (dataclasses.replace(c, report_per_event=False)
                  for c in method_configs(ROWS["06-FGD"]))
    jsim = JSimulator(jn, jcfg)
    jsim.set_workload_pods(jp)
    jsim.set_typical_pods()
    trace = jsim.prepare_pods()
    bk, bp = jbuild_events(trace, False)
    out = jsim.run_events(
        jsim.init_state, jpods_to_specs(trace, jsim.node_index),
        jnp.asarray(np.concatenate([bk[:fev], kinds])),
        jnp.asarray(np.concatenate([bp[:fev], idx])),
        jax.random.PRNGKey(jcfg.seed))
    want = (digest(np.asarray(out.placed_node), np.int32),
            digest(np.asarray(out.dev_mask), np.uint8))
    assert want == chip_smoke.FORK_SHA256

    pcfg = dataclasses.replace(pcfg, checkpoint_every=chip_smoke.CKPT_EVERY,
                               checkpoint_keep=-1,
                               checkpoint_dir=str(tmp_path))
    base = Simulator(pn, pcfg, device="cpu")
    base.set_workload_pods(pp)
    base.set_typical_pods()
    base.schedule_pods(base.prepare_pods())
    warm = Simulator(pn, pcfg, device="cpu")
    warm.set_workload_pods(pp)
    warm.set_typical_pods()
    res = warm.schedule_pods_fork(warm.prepare_pods(), fev, kinds, idx)
    assert warm.last_fork["source_cursor"] == fev
    assert (digest(res.placed_node, np.int32),
            digest(res.dev_mask, np.uint8)) == chip_smoke.FORK_SHA256
