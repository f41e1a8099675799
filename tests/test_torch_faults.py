"""The fault host loop against the JAX package, at tolerance 0: fold_in
against jax.random.fold_in; the seeded schedule, its validation, the
eviction draw, the retry queue and the node fail/recover transitions; the
whole Simulator.run_with_faults (placements, masks, creation ranks, the
unscheduled pods and their reasons, the disruption metrics, the log
without its [Engine] lines, the analysis CSVs) against tpusim's default
fault_mode with per-event reports on and off (its in-scan lane with them
off), under fault_mode="segments", for 01-Random and for an explicit
schedule; apply's --fault-* flags on the example bundle; what still
raises; and, slow-marked, the digests chip_smoke.py holds the card's fault
runs to."""

import dataclasses
import hashlib
import os

import jax
import numpy as np
import pytest
import chip_smoke
from tests.test_torch_apply import _apply_both
from tests.test_torch_driver import ROWS, method_configs
from tests.test_torch_report import _experiment_files
from tests.test_torch_report_ops import _used_cluster
from tests.test_torch_types_trace import (
    REPO,
    jfields,
    openb_rows,
    port_state,
)
from tpusim.sim import faults as jfaults
from tpusim.sim import queues as jqueues
from tpusim.sim.driver import Simulator as JSimulator
from tpusim_torch.analysis import analyze_sim
from tpusim_torch.ops import prng
from tpusim_torch.sim import faults as pfaults
from tpusim_torch.sim import queues as pqueues
from tpusim_torch.sim.driver import Simulator as PSimulator

from analysis import analyze_sim as janalyze_sim  # noqa: E402 (experiments/)

FCFGS = [dict(mtbf_events=30, mttr_events=50, evict_every_events=20, seed=7),
         dict(mtbf_events=60, mttr_events=0, evict_every_events=0, seed=3,
              max_retries=1, backoff_base=2, backoff_cap=4),
         dict(mtbf_events=0, evict_every_events=8, seed=11, max_retries=0)]


def test_fold_in_matches_jax():
    """fold_in(key, data) is jax.random.fold_in's key, for several keys
    and data (data past 2**31 included)."""
    for seed in (0, 7, 42, 2**31 + 5):
        for data in (0, 1, 2, 17, 1000, 2**31 + 3, 2**32 - 1):
            want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 data))
            assert prng.fold_in(prng.prng_key(seed), data) == tuple(
                int(w) for w in want)


@pytest.mark.parametrize("cfg", FCFGS, ids=["mixed", "permanent", "evict"])
def test_generate_fault_schedule_matches_jax(cfg):
    """The same events in the same order from the same numpy draws."""
    for nodes, events in ((10, 400), (1213, 10811), (1, 50)):
        want = jfaults.generate_fault_schedule(
            nodes, events, jfaults.FaultConfig(**cfg))
        got = pfaults.generate_fault_schedule(
            nodes, events, pfaults.FaultConfig(**cfg))
        assert [(f.pos, f.kind, f.node, f.pod) for f in got] == \
            [(f.pos, f.kind, f.node, f.pod) for f in want]


def test_validate_and_pick_victim_match_jax():
    """validate_fault_schedule raises the same errors on the same faults;
    pick_eviction_victim draws the same pods."""
    bad = [[(0, 9, 1, -1)], [(0, 3, 12, -1)], [(0, 4, -1, -1)],
           [(0, 5, -1, 40)], [(-1, 3, 0, -1)], [(3, 3, 2, -1), (5, 5, -1, 7)]]
    for faults in bad:
        outs = []
        for mod in (jfaults, pfaults):
            try:
                mod.validate_fault_schedule(
                    [mod.FaultEvent(*f) for f in faults], 10, 40)
                outs.append("ok")
            except ValueError as err:
                outs.append(str(err))
        assert outs[0] == outs[1]
    rng = np.random.default_rng(5)
    for _ in range(50):
        placed = np.where(rng.random(60) < 0.6, rng.integers(0, 9, 60), -1)
        pos, seed = int(rng.integers(0, 10000)), int(rng.integers(0, 99))
        explicit = int(rng.integers(-1, 60))
        assert pfaults.pick_eviction_victim(placed, pos, seed, explicit) == \
            jfaults.pick_eviction_victim(placed, pos, seed, explicit)
    assert pfaults.pick_eviction_victim(np.full(5, -1), 3, 1) is None


def test_retry_queue_sequences_match_jax():
    """Seeded push / next_ready / pop_due sequences: the same ready
    positions, pops, dead list and length at every step."""
    rng = np.random.default_rng(2)
    for base, cap, retries in ((8, 256, 3), (1, 1, 0), (2, 16, 5)):
        qs = (jqueues.RetryQueue(base, cap, retries),
              pqueues.RetryQueue(base, cap, retries))
        for step in range(300):
            op = rng.integers(0, 3)
            if op == 0:
                args = (int(rng.integers(0, 40)), step,
                        int(rng.integers(1, retries + 3)))
                assert qs[0].push(*args) == qs[1].push(*args)
            elif op == 1:
                assert qs[0].next_ready() == qs[1].next_ready()
            else:
                assert qs[0].pop_due(step) == qs[1].pop_due(step)
            assert len(qs[0]) == len(qs[1]) and qs[0].dead == qs[1].dead
            assert qs[0].backoff(step % 9) == qs[1].backoff(step % 9)
    with pytest.raises(ValueError):
        pqueues.RetryQueue(0, 4, 1)


def test_fail_recover_node_match_jax():
    """fail_node and recover_node on a partly used cluster, node after
    node (a second failure of a down node included): every field equal,
    is_down alike, and the state handed in left as it was."""
    jstate, _ = _used_cluster(4, 40)
    pstate = start = port_state(jstate)
    before = jfields(start)
    for node in (0, 7, 39, 7):
        jstate = jfaults.fail_node(jstate, node)
        pstate = pfaults.fail_node(pstate, node)
    for node in (7, 39):
        jstate = jfaults.recover_node(jstate, node)
        pstate = pfaults.recover_node(pstate, node)
    for name, want in jfields(jstate).items():
        np.testing.assert_array_equal(getattr(pstate, name).numpy(), want,
                                      err_msg=name)
    np.testing.assert_array_equal(pfaults.is_down(pstate).numpy(),
                                  np.asarray(jfaults.is_down(jstate)))
    for name, want in before.items():
        np.testing.assert_array_equal(getattr(start, name).numpy(), want)
    assert int(pfaults.is_down(pstate).sum()) == 1


def _fault_sims(row, report, fault_mode, num_nodes=120, num_pods=300):
    """Both packages' Simulators of a method row on the first `num_nodes`
    openb nodes and `num_pods` pods (untuned, shuffled)."""
    jn, jp, pn, pp = openb_rows()
    jcfg, pcfg = method_configs(ROWS[row], 0.0)
    jcfg = dataclasses.replace(jcfg, report_per_event=report,
                               fault_mode=("segments" if fault_mode ==
                                           "segments" else "auto"))
    pcfg = dataclasses.replace(pcfg, report_per_event=report,
                               fault_mode=fault_mode)
    jsim, psim = JSimulator(jn[:num_nodes], jcfg), PSimulator(
        pn[:num_nodes], pcfg, device="cpu")
    jsim.set_workload_pods(jp[:num_pods])
    psim.set_workload_pods(pp[:num_pods])
    return jsim, psim


def _assert_same_fault_run(jsim, psim, tmp_path, row):
    jr, pr = jsim.last_result, psim.last_result
    np.testing.assert_array_equal(pr.placed_node, np.asarray(jr.placed_node))
    np.testing.assert_array_equal(pr.dev_mask, np.asarray(jr.dev_mask))
    np.testing.assert_array_equal(pr.creation_rank, jr.creation_rank)
    assert pr.events == jr.events
    assert [(u.pod.name, u.reason) for u in pr.unscheduled_pods] == \
        [(u.pod.name, u.reason) for u in jr.unscheduled_pods]
    jd, pd = jsim.last_disruption, psim.last_disruption
    assert pd.as_dict() == jd.as_dict()
    assert pd.reschedule_latency_events == jd.reschedule_latency_events
    assert pd.post_recovery_frag_delta == jd.post_recovery_frag_delta
    for name, want in jfields(jr.state).items():
        np.testing.assert_array_equal(getattr(pr.state, name).numpy(), want)
    meta = chip_smoke.row_meta(*ROWS[row][1:4])
    want = _experiment_files(jsim, tmp_path / "jax", meta, janalyze_sim)
    got = _experiment_files(psim, tmp_path / "port", meta, analyze_sim)
    assert got == want
    return pd


@pytest.mark.parametrize("row,report,mode", [
    ("06-FGD", True, "auto"),
    ("06-FGD", False, "auto"),
    ("06-FGD", True, "segments"),
    ("01-Random", True, "auto"),
])
def test_run_with_faults_matches_jax(tmp_path, row, report, mode):
    """run_with_faults on 120 openb nodes and 300 pods under a dense
    schedule (failures, recoveries, evictions, retries): everything the
    run leaves equal to tpusim's under the same fault_mode (under "auto"
    its in-scan lane where it takes it, with reports off), the log and
    CSVs byte for byte."""
    jsim, psim = _fault_sims(row, report, mode)
    cfg = FCFGS[0]
    jsim.run_with_faults(jfaults.FaultConfig(**cfg))
    psim.run_with_faults(pfaults.FaultConfig(**cfg))
    dm = _assert_same_fault_run(jsim, psim, tmp_path, row)
    assert dm.node_failures and dm.evicted_pods and dm.rescheduled_pods
    lines = psim.log.lines
    assert any("[Disruption]" in line for line in lines)
    assert any("segmented replay" in line for line in lines) == (
        mode == "auto" and (report or row == "01-Random"))


def test_explicit_schedule_matches_jax(tmp_path):
    """An explicit FaultEvent list: a failure of a node holding several
    pods, its recovery, an eviction of a named pod, another at a position
    past the trace, a second failure of a down node (a no-op); one retry
    allowed, so pods go terminal."""
    jsim, psim = _fault_sims("06-FGD", True, "auto", 60, 200)
    faults = [(40, 3, 5, -1), (40, 5, -1, 3), (41, 3, 5, -1),
              (90, 4, 5, -1), (120, 3, 17, -1), (150, 5, -1, -1),
              (5000, 5, -1, -1)]
    fcfg = dict(max_retries=1, backoff_base=1, backoff_cap=2, seed=9)
    jsim.run_with_faults(jfaults.FaultConfig(**fcfg),
                         [jfaults.FaultEvent(*f) for f in faults])
    psim.run_with_faults(pfaults.FaultConfig(**fcfg),
                         [pfaults.FaultEvent(*f) for f in faults])
    _assert_same_fault_run(jsim, psim, tmp_path, "06-FGD")


def test_apply_faults_match_jax():
    """apply with the README's fault command on the example bundle (three
    pods: no fault fires), and with a schedule that fires on it (a fault
    every event): the standard output without [Engine], byte for byte;
    tpusim's has the digest chip_smoke.py holds the card's run to."""
    argv = list(chip_smoke.APPLY_FAULT_ARGS)
    argv[1] = os.path.join(REPO, argv[1])
    argv[3] = os.path.join(REPO, argv[3])
    port, jax_out = _apply_both(argv)
    assert port == jax_out and "[Disruption]" in port
    # chip_smoke.py holds the card's run of this command to this digest
    assert hashlib.sha256(jax_out.encode()).hexdigest() == \
        chip_smoke.APPLY_FAULT_SHA256
    dense = argv[:4] + ["--fault-mtbf", "1", "--fault-mttr", "1",
                        "--fault-evict-every", "1", "--fault-seed", "5",
                        "--fault-max-retries", "1"]
    port, jax_out = _apply_both(dense)
    assert port == jax_out and "[Fault] node" in port


def test_fault_lane_options_raise():
    """An unknown fault_mode and a timestamped trace raise ValueError as in
    tpusim; the apply options whose plane the port still lacks raise
    NotImplementedError naming their item: --policy (12) and --listen
    (14). (The lane's own entries run: test_torch_fault_lane.py;
    --checkpoint-every runs since the checkpoint slice:
    test_torch_checkpoint.py; the obs outputs since the records slice:
    test_torch_obs.py.)"""
    from tpusim_torch import apply as papply

    jsim, psim = _fault_sims("06-FGD", False, "scan", 20, 20)
    cr = os.path.join(REPO, chip_smoke.APPLY_DEFAULT_CR)
    for option, value, item in (("policy", "learned", "item 12 "),
                                ("listen", "127.0.0.1:0", "item 14 ")):
        with pytest.raises(NotImplementedError, match=item):
            papply.Applier(papply.ApplyOptions(simon_config=cr,
                                               **{option: value}))
    psim.cfg.fault_mode = "bogus"
    with pytest.raises(ValueError, match="unknown fault_mode"):
        psim.run_with_faults(pfaults.FaultConfig(mtbf_events=5))
    psim.cfg.fault_mode = "auto"
    psim.cfg.use_timestamps = True
    with pytest.raises(ValueError, match="creation-ordered"):
        psim.run_with_faults(pfaults.FaultConfig(mtbf_events=5))


# ---- the card's digests (full openb; slow) ----

def jax_fault_digests(tmp_path, mid):
    """The JAX package's digests of a chip_smoke.FAULT_ROWS row's fault
    run (chip_smoke.FAULT_SHA256's definition)."""
    jn, jp, _, _ = openb_rows()
    jcfg = dataclasses.replace(method_configs(ROWS[mid])[0],
                               report_per_event=True)
    jsim = JSimulator(jn, jcfg)
    jsim.set_workload_pods(jp)
    res = jsim.run_with_faults(jfaults.FaultConfig(**chip_smoke.FAULT_FLAGS))
    d = tmp_path / mid
    d.mkdir()
    return dict(chip_smoke.result_digests(res),
                disruption=chip_smoke.disruption_digest(jsim.last_disruption),
                report=chip_smoke.experiment_report_digest(
                    jsim, str(d), chip_smoke.row_meta(*ROWS[mid][1:4]),
                    janalyze_sim))


@pytest.mark.slow
@pytest.mark.parametrize("mid", chip_smoke.FAULT_ROWS)
def test_fault_digests_pin_chip_smoke(tmp_path, mid):
    """tpusim's full-openb fault runs have the digests chip_smoke.py holds
    the card's runs to."""
    assert jax_fault_digests(tmp_path, mid) == chip_smoke.FAULT_SHA256[mid]
