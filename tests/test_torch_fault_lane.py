"""The in-scan fault lane against the JAX package's, at tolerance 0.

The step functions of tpusim_torch.sim.fault_lane against tpusim's on
seeded carries; compile_fault_plan and the victim draws; the fault forms of
the plain replays against tpusim's table-engine lane (flat and blocked);
then the lane through Simulator.run_with_faults under
fault_mode "scan" and "auto" (placements, masks, every final state field,
creation ranks, the unscheduled pods and their reasons, the disruption
metrics and their lists, the [Fault] and [Disruption] lines), the chaos
sweep (run_sweep(faults=), schedule_pods_sweep_multi(fault_specs=)) and
apply --sweep-faults; and, slow-marked, the digests chip_smoke.py holds
the card's lane runs to."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_apply import _apply_both
from tests.test_torch_driver import ROWS, method_configs
from tests.test_torch_report_ops import _used_cluster
from tests.test_torch_types_trace import (
    REPO,
    jfields,
    openb_rows,
    port_state,
    port_typical,
)
from tpusim.sim import fault_lane as jfl
from tpusim.sim import faults as jfaults
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import schedule_pods_sweep_multi as jsweep_multi
from tpusim_torch.sim import fault_lane as pfl
from tpusim_torch.sim import faults as pfaults
from tpusim_torch.sim.driver import Simulator as PSimulator
from tpusim_torch.sim.driver import schedule_pods_sweep_multi as psweep_multi

DENSE = dict(mtbf_events=30, mttr_events=50, evict_every_events=20, seed=7)


# ---- the step functions on seeded carries ----

def _carry(rng, p, n, r):
    """A seeded FaultCarry as numpy fields: a queue with live and free
    slots, attempts, eviction stamps, dead pods, down nodes, counters."""
    live = rng.random(r) < 0.6
    return dict(
        q_ready=np.where(live, rng.integers(0, 40, r), 2**31 - 1),
        q_seq=np.where(live, rng.permutation(r), 2**31 - 1),
        q_pod=np.where(live, rng.choice(p, r, replace=False), -1),
        q_att=np.where(live, rng.integers(1, 4, r), 0),
        q_era=np.where(live, rng.integers(0, 3, r), 0),
        seq=np.int32(r + 3),
        attempts=rng.integers(0, 3, p),
        evicted_at=np.where(rng.random(p) < 0.5, rng.integers(0, 30, p), -1),
        dead=rng.random(p) < 0.1,
        down_at=np.where(rng.random(n) < 0.3, rng.integers(0, 30, n), -1),
        dctr=rng.integers(0, 9, pfl.NUM_DCTR),
    )


def _jcarry(c):
    return jfl.FaultCarry(**{k: jnp.asarray(v, bool if k == "dead"
                                            else jnp.int32)
                             for k, v in c.items()})


def _pcarry(c):
    return pfl.FaultCarry(**{k: torch.as_tensor(
        np.asarray(v), dtype=torch.bool if k == "dead" else torch.int32)
        for k, v in c.items()})


def _same(got, want, what):
    """Every leaf of a port NamedTuple (or tensor) equals the JAX one."""
    if hasattr(want, "_fields"):
        for name in want._fields:
            _same(getattr(got, name), getattr(want, name), f"{what}.{name}")
        return
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def test_backoff_and_queue_ops_match_jax():
    """backoff_of, pop_retry (normal slots and flush rounds),
    _queue_push_mask, _evict_into_queue and commit_retry on seeded carries
    (a queue of capacity 1 that overflows into dead pods included)."""
    for att in range(0, 40):
        for base, cap in ((8, 256), (1, 1), (3, 1 << 20), (0, 5), (7, 100)):
            assert int(pfl.backoff_of(att, base, cap)) == int(
                jfl.backoff_of(jnp.int32(att), jnp.int32(base),
                               jnp.int32(cap)))
    rng = np.random.default_rng(4)
    for trial in range(60):
        p, n, r = 24, 6, int(rng.choice([1, 4, 8]))
        c = _carry(rng, p, n, r)
        jc, pc = _jcarry(c), _pcarry(c)
        pos, rnd = int(rng.integers(0, 45)), int(rng.integers(0, 3))
        _same(pfl.pop_retry(pc, bool(trial % 5), pos, rnd),
              jfl.pop_retry(jc, jnp.bool_(trial % 5), jnp.int32(pos),
                            jnp.int32(rnd)), "pop_retry")
        params = np.array([int(rng.integers(1, 9)), 64,
                           int(rng.integers(0, 4)), 50], np.int32)
        vm = rng.random(p) < 0.3
        att = np.where(vm, rng.integers(1, 6, p), 0).astype(np.int32)
        _same(pfl._queue_push_mask(pc, torch.as_tensor(vm),
                                   torch.as_tensor(att), pos, rnd,
                                   torch.as_tensor(params)),
              jfl._queue_push_mask(jc, jnp.asarray(vm), jnp.asarray(att),
                                   jnp.int32(pos), jnp.int32(rnd),
                                   jnp.asarray(params)), "push")
        _same(pfl._evict_into_queue(pc, torch.as_tensor(vm), pos, 0,
                                    torch.as_tensor(params)),
              jfl._evict_into_queue(jc, jnp.asarray(vm), jnp.int32(pos),
                                    jnp.int32(0), jnp.asarray(params)),
              "evict_into_queue")
        pod, node = int(rng.integers(0, p)), int(rng.integers(-1, n))
        has = bool(rng.random() < 0.8)
        _same(pfl.commit_retry(pc, has, pod, node, pos, rnd,
                               torch.as_tensor(params)),
              jfl.commit_retry(jc, jnp.bool_(has), jnp.int32(pod),
                               jnp.int32(node), jnp.int32(pos),
                               jnp.int32(rnd), jnp.asarray(params)),
              "commit_retry")


def _specs(rng, p):
    """Both packages' PodSpecs of p seeded pods (share, whole and CPU-only
    pods; none pinned)."""
    from tpusim.types import PodSpec as JPodSpec
    from tpusim_torch.types import PodSpec as PPodSpec

    milli = rng.choice([0, 250, 500, 1000], p)
    f = dict(cpu=rng.integers(100, 4000, p), mem=rng.integers(10, 900, p),
             gpu_milli=milli,
             gpu_num=np.where(milli == 0, 0, rng.integers(1, 3, p)),
             gpu_mask=np.zeros(p), pinned=np.full(p, -1))
    return (JPodSpec(**{k: jnp.asarray(v, jnp.int32) for k, v in f.items()}),
            PPodSpec(**{k: torch.as_tensor(v, dtype=torch.int32)
                        for k, v in f.items()}))


def test_apply_fault_step_matches_jax():
    """apply_fault_step (its decisions and bookkeeping, the recover frag
    capture on) on a partly used 40-node cluster: failures of up and down
    nodes, recoveries, drawn and explicit evictions, an eviction with
    nothing placed, and steps of the other kinds (exact no-ops)."""
    jstate, jtp = _used_cluster(4, 40)
    pstate, ptp = port_state(jstate), port_typical(jtp)
    rng = np.random.default_rng(9)
    p, n = 50, 40
    jspecs, pspecs = _specs(rng, p)
    gcnt = np.array(jstate.gpu_cnt)
    draws = np.stack([jfl._victim_draw_row(3, 17, p)])
    params = np.array([4, 64, 2, 60], np.int32)
    zero = np.zeros(1, np.int32)
    jops = jfl.FaultOps(*(jnp.asarray(a) for a in (zero, zero, zero, draws,
                                                    params, gcnt)))
    pops = pfl.FaultOps(*(torch.as_tensor(a) for a in (zero, zero, zero,
                                                        draws, params, gcnt)))
    step = jax.jit(jfl.apply_fault_step, static_argnums=(13,))
    for trial in range(24):
        c = _carry(rng, p, n, 8)
        placed = np.where(rng.random(p) < (0.0 if trial == 8 else 0.6),
                          rng.integers(0, n, p), -1).astype(np.int32)
        masks = (rng.random((p, 8)) < 0.2) & (placed[:, None] >= 0)
        failed = rng.random(p) < 0.2
        kind = [3, 4, 5, 5, 0, 6][trial % 6]
        arg = (int(rng.integers(0, n)) if kind in (3, 4)
               else int(rng.integers(-1, p)) if kind == 5 else 0)
        aux = 0 if kind == 5 and arg < 0 else -1
        pos = int(rng.integers(0, 60))
        want = step(jstate, jnp.asarray(placed), jnp.asarray(masks),
                    jnp.asarray(failed), _jcarry(c), jspecs, jnp.int32(kind),
                    jnp.int32(arg), jnp.int32(aux), jnp.int32(pos), jops, jtp,
                    jnp.arange(n, dtype=jnp.int32), True)
        got = pfl.apply_fault_step(
            pstate, torch.as_tensor(placed), torch.as_tensor(masks),
            torch.as_tensor(failed), _pcarry(c), pspecs, kind, arg, aux, pos,
            pops, ptp, torch.arange(n, dtype=torch.int32), True)
        for i, name in enumerate(("state", "placed", "masks", "failed",
                                  "carry", "touched")):
            _same(got[i], want[i], f"trial {trial} {name}")
        gy, wy = got[6], want[6]
        _same(gy[:6], tuple(wy)[:6], f"trial {trial} y")
        # the recover frag capture: the port's cluster frag order, within
        # float32 rounding of XLA's fused one (module docstring of
        # test_frag_scalar_and_recover_frags_match_jax)
        if int(gy.rec):
            assert float(gy.fb) == _frag_total(pstate, ptp)
            assert float(gy.fa) == _frag_total(got[0], ptp)
        for g, w in ((gy.fb, wy.fb), (gy.fa, wy.fa)):
            np.testing.assert_allclose(float(g), float(w), rtol=2e-6)


def _frag_total(state, tp) -> float:
    """The cluster frag of a state as the segmented loop's frag_total
    takes it: cluster_frag_report's amounts, then frag_sum_except_q3."""
    from tpusim_torch.ops.frag import cluster_frag_report, frag_sum_except_q3

    amounts = cluster_frag_report(state, tp)[0]
    return float(frag_sum_except_q3(torch.as_tensor(amounts)))


def test_frag_scalar_and_recover_frags_match_jax():
    """_frag_scalar and recover_frags' before and after values on partly
    used clusters of 7 to 1523 nodes: bit-equal to the segmented loop's
    frag_total (cluster_frag_report's amounts, then frag_sum_except_q3),
    and within float32 rounding (relative 2e-6) of tpusim's jitted
    _frag_scalar, where XLA fuses the class sum into the cluster sum in
    an order that changes with the cluster's size. On a lane the two
    values of a recover are of states that differ in mem_left alone,
    which frag does not read, so post_recovery_frag_delta is 0.0 exactly
    in both packages (the driver tests pin it)."""
    for seed, n in ((5, 7), (1, 40), (2, 120), (3, 1523)):
        jstate, jtp = _used_cluster(seed, n)
        pstate, ptp = port_state(jstate), port_typical(jtp)
        want = float(jax.jit(jfl._frag_scalar)(jstate, jtp))
        got = float(pfl._frag_scalar(pstate, ptp))
        assert got == _frag_total(pstate, ptp)
        np.testing.assert_allclose(got, want, rtol=2e-6)
        nodes = torch.tensor([0, n // 2, n - 1])
        fb, fa = pfl.recover_frags(
            (pstate.cpu_left.repeat(3, 1), pstate.gpu_left.repeat(3, 1, 1)),
            nodes, pstate, ptp)
        for s, node in enumerate(nodes.tolist()):
            assert float(fb[s]) == got
            assert float(fa[s]) == _frag_total(
                pfaults.recover_node(pstate, node), ptp)


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_compile_fault_plan_matches_jax(seed):
    """compile_fault_plan on a 400-event stream under seeded schedules
    (dense, with flush rounds and queue capacities 1 and auto), and
    _victim_draw_row, field by field."""
    rng = np.random.default_rng(seed)
    e, p, n = 400, 300, 30
    kinds = np.where(rng.random(e) < 0.8, 0, 2).astype(np.int32)
    pods = rng.integers(0, p, e).astype(np.int32)
    for cfg in (DENSE, dict(mtbf_events=60, mttr_events=0, seed=seed,
                            max_retries=1, backoff_base=2, backoff_cap=4),
                dict(evict_every_events=9, seed=seed, queue_capacity=1)):
        cfg = dict(cfg, seed=seed)
        jc, pc = jfaults.FaultConfig(**cfg), pfaults.FaultConfig(**cfg)
        faults = jfaults.generate_fault_schedule(n, e, jc)
        want = jfl.compile_fault_plan(kinds, pods, faults, jc, n, p)
        got = pfl.compile_fault_plan(
            kinds, pods, pfaults.generate_fault_schedule(n, e, pc), pc, n, p)
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
    for pos in (0, 5, 999):
        np.testing.assert_array_equal(pfl._victim_draw_row(seed, pos, 60),
                                      jfl._victim_draw_row(seed, pos, 60))


# ---- the lane through the driver, against tpusim's table-engine lane ----

def _sims(row, report=False, mode="scan", num_nodes=120, num_pods=300,
          residency="vmem", block=-1, engine="auto", queue=0):
    """Both packages' Simulators of a method row on the first `num_nodes`
    openb nodes and `num_pods` pods (untuned, shuffled); tpusim's on its
    table engine, flat (block -1) or blocked."""
    jn, jp, pn, pp = openb_rows()
    jcfg, pcfg = method_configs(ROWS[row], 0.0)
    jcfg = dataclasses.replace(
        jcfg, report_per_event=report, fault_mode=mode,
        engine="table" if engine == "auto" else engine, block_size=block)
    pcfg = dataclasses.replace(pcfg, report_per_event=report,
                               fault_mode=mode, table_residency=residency,
                               engine=engine)
    jsim, psim = JSimulator(jn[:num_nodes], jcfg), PSimulator(
        pn[:num_nodes], pcfg, device="cpu")
    jsim.set_workload_pods(jp[:num_pods])
    psim.set_workload_pods(pp[:num_pods])
    return jsim, psim


def _capture(sim):
    """Keep what each _dispatch_fault_scan of `sim` returns in sim.got."""
    dispatch = sim._dispatch_fault_scan
    sim.got = []

    def wrapped(*args):
        out = dispatch(*args)
        sim.got.append(out)
        return out

    sim._dispatch_fault_scan = wrapped


def _log(sim, tags=("[Fault]", "[Disruption]")):
    return [line for line in sim.log.lines if any(t in line for t in tags)]


def _assert_same_lane(jsim, psim):
    """Everything a fault run leaves, bit for bit: placements, masks, the
    final state, creation ranks, events, the unscheduled pods and their
    reasons, the DisruptionMetrics and both of its lists, the [Fault] and
    [Disruption] lines."""
    jr, pr = jsim.last_result, psim.last_result
    np.testing.assert_array_equal(pr.placed_node, np.asarray(jr.placed_node))
    np.testing.assert_array_equal(pr.dev_mask, np.asarray(jr.dev_mask))
    np.testing.assert_array_equal(pr.creation_rank, jr.creation_rank)
    assert pr.events == jr.events
    assert [(u.pod.name, u.reason) for u in pr.unscheduled_pods] == \
        [(u.pod.name, u.reason) for u in jr.unscheduled_pods]
    for name, want in jfields(jr.state).items():
        np.testing.assert_array_equal(getattr(pr.state, name).numpy(), want,
                                      err_msg=name)
    jd, pd = jsim.last_disruption, psim.last_disruption
    assert pd.as_dict() == jd.as_dict()
    assert pd.reschedule_latency_events == jd.reschedule_latency_events
    assert pd.post_recovery_frag_delta == jd.post_recovery_frag_delta
    assert _log(psim) == _log(jsim)
    return pd


def _assert_same_outputs(jsim, psim):
    """The fault form's steps' outputs (but the frag values, whose deltas
    _assert_same_lane pins) and final carry against tpusim's scan."""
    (jout,), ((_, fout),) = jsim.got, psim.got
    for name in ("rpod", "lat", "vpod", "vnode", "nvict", "rec"):
        np.testing.assert_array_equal(getattr(fout.ys, name).numpy(),
                                      np.asarray(getattr(jout.fault_ys, name)),
                                      err_msg=name)
    _same(fout.carry, jout.fault_carry, "carry")


@pytest.mark.parametrize("residency,block", [("vmem", -1), ("hbm", 128)],
                         ids=["flat", "blocked"])
def test_lane_matches_jax(residency, block):
    """06-FGD on 120 nodes and 300 pods under a dense schedule (failures,
    recoveries, drawn evictions, retries and flush rounds), fault_mode
    scan: the port's plain replay_faults (replay_blocked_faults) against
    tpusim's flat (blocked) table-engine lane, bit for bit, with every
    step's outputs and the final carry."""
    jsim, psim = _sims("06-FGD", residency=residency, block=block)
    _capture(jsim)
    _capture(psim)
    jsim.run_with_faults(jfaults.FaultConfig(**DENSE))
    psim.run_with_faults(pfaults.FaultConfig(**DENSE))
    dm = _assert_same_lane(jsim, psim)
    _assert_same_outputs(jsim, psim)
    assert dm.node_failures and dm.node_recoveries and dm.evicted_pods
    assert dm.rescheduled_pods and dm.post_recovery_frag_delta
    assert psim.last_engine == ("plain_replay_faults" if residency == "vmem"
                                else "plain_replay_blocked_faults")
    assert psim.last_residency == residency


def test_lane_random_scan_matches_jax():
    """01-Random under fault_mode scan: the lane's one key chain over the
    merged stream (a step of it a merged step), equal to tpusim's."""
    jsim, psim = _sims("01-Random", num_nodes=60, num_pods=200)
    _capture(jsim)
    _capture(psim)
    jsim.run_with_faults(jfaults.FaultConfig(**DENSE))
    psim.run_with_faults(pfaults.FaultConfig(**DENSE))
    _assert_same_lane(jsim, psim)
    _assert_same_outputs(jsim, psim)


def test_lane_explicit_schedule_matches_jax():
    """An explicit schedule: a failure of a node holding several pods, an
    eviction of a named pod, a second failure of the down node (a no-op),
    its recovery, an eviction past the trace; one retry and a queue of
    capacity 1, which overflows into dead pods."""
    jsim, psim = _sims("06-FGD", num_nodes=60, num_pods=200)
    _capture(jsim)
    _capture(psim)
    faults = [(40, 3, 5, -1), (40, 5, -1, 3), (41, 3, 5, -1),
              (90, 4, 5, -1), (120, 3, 17, -1), (150, 5, -1, -1),
              (5000, 5, -1, -1)]
    fcfg = dict(max_retries=1, backoff_base=1, backoff_cap=2, seed=9,
                queue_capacity=1)
    jsim.run_with_faults(jfaults.FaultConfig(**fcfg),
                         [jfaults.FaultEvent(*f) for f in faults])
    psim.run_with_faults(pfaults.FaultConfig(**fcfg),
                         [pfaults.FaultEvent(*f) for f in faults])
    dm = _assert_same_lane(jsim, psim)
    _assert_same_outputs(jsim, psim)
    assert dm.unscheduled_after_retries > 0


@pytest.mark.parametrize("row,report", [("06-FGD", True), ("06-FGD", False),
                                        ("01-Random", False)],
                         ids=["reports-on", "reports-off", "random"])
def test_auto_takes_the_lane_where_jax_does(row, report):
    """fault_mode auto: the lane exactly where tpusim takes it (reports off,
    a deterministic configuration), the segmented loop elsewhere with the
    same [Fault] segmented replay (...) line, and the same results."""
    jsim, psim = _sims(row, report=report, mode="auto", num_nodes=40,
                       num_pods=100)
    jsim.run_with_faults(jfaults.FaultConfig(**DENSE))
    psim.run_with_faults(pfaults.FaultConfig(**DENSE))
    _assert_same_lane(jsim, psim)
    assert _log(psim, ("segmented replay",)) == _log(jsim,
                                                     ("segmented replay",))
    lane = not report and row == "06-FGD"
    assert any("fault-lane replay" in line
               for line in psim.log.lines) == lane
    assert any("fault-lane replay" in line
               for line in jsim.log.lines) == lane


def test_pallas_engine_blocks_the_lane_as_in_jax():
    """engine "pallas" keeps auto on the segmented loop, as tpusim's fused
    pallas engine does, and fault_mode scan refuses it with tpusim's
    message."""
    jsim, psim = _sims("06-FGD", mode="auto", num_nodes=20, num_pods=20,
                       engine="pallas")
    assert psim._fault_scan_blockers() == jsim._fault_scan_blockers()
    assert psim._fault_scan_blockers() == ["the fused pallas engine"]
    psim.cfg.fault_mode = "scan"
    with pytest.raises(ValueError, match="fused pallas engine"):
        psim.run_with_faults(pfaults.FaultConfig(mtbf_events=5))
    psim.cfg.fault_mode = "auto"
    psim.run_with_faults(pfaults.FaultConfig(**DENSE))
    assert any("[Fault] segmented replay (the fused pallas engine)" in line
               for line in psim.log.lines)
    assert psim.last_engine == "plain_replay"


def _same_sweep_lane(got, want):
    """Two SweepLanes (port, tpusim) field by field."""
    for name in ("placed_node", "dev_mask", "ever_failed"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    for name, w in jfields(want.state).items():
        np.testing.assert_array_equal(np.asarray(getattr(got.state, name)),
                                      w, err_msg=name)
    for name in ("events", "placed", "failed", "unscheduled", "seed"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.gpu_alloc_pct == want.gpu_alloc_pct
    assert got.frag_gpu_milli == want.frag_gpu_milli
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.disruption.as_dict() == want.disruption.as_dict()
    assert got.disruption.reschedule_latency_events == \
        want.disruption.reschedule_latency_events
    assert got.disruption.post_recovery_frag_delta == \
        want.disruption.post_recovery_frag_delta


def _chaos_specs(mod):
    """Three chaos lanes: two seeded schedules (one with its own queue
    capacity) and an explicit one."""
    return [mod.FaultConfig(**DENSE),
            mod.FaultConfig(mtbf_events=40, mttr_events=60,
                            evict_every_events=15, seed=3, max_retries=2,
                            queue_capacity=16),
            (mod.FaultConfig(max_retries=1, backoff_base=1, backoff_cap=2,
                             seed=9),
             [mod.FaultEvent(30, 3, 5, -1), mod.FaultEvent(30, 5, -1, 3),
              mod.FaultEvent(70, 4, 5, -1), mod.FaultEvent(90, 5, -1, -1)])]


def test_run_sweep_faults_matches_jax_and_standalone():
    """run_sweep(faults=) with 3 lanes (weights and seeds differ too): each
    lane equals tpusim's chaos-sweep lane and the port's standalone
    fault_mode scan run with its schedule, weights and seed."""
    jsim, psim = _sims("06-FGD", num_nodes=40, num_pods=100)
    weights, seeds = [[1000], [1000], [500]], [42, 7, 42]
    want = jsim.run_sweep(weights, seeds=seeds, faults=_chaos_specs(jfaults))
    got = psim.run_sweep(weights, seeds=seeds, faults=_chaos_specs(pfaults))
    assert psim.last_engine == "plain_replay_lanes_faults"
    for g, w in zip(got, want):
        _same_sweep_lane(g, w)
    capacity = psim._chaos_hw[2]  # the lanes' one queue capacity
    for i, spec in enumerate(_chaos_specs(pfaults)):
        fcfg, events = spec if isinstance(spec, tuple) else (spec, None)
        cfg = dataclasses.replace(psim.cfg, seed=seeds[i],
                                  policies=(("FGDScore", weights[i][0]),))
        solo = PSimulator(psim.nodes, cfg, device="cpu")
        solo.set_workload_pods(psim.workload_pods)
        res = solo.run_with_faults(
            dataclasses.replace(fcfg, queue_capacity=capacity), events)
        np.testing.assert_array_equal(got[i].placed_node, res.placed_node)
        np.testing.assert_array_equal(got[i].dev_mask, res.dev_mask)
        for name in ("cpu_left", "mem_left", "gpu_left", "aff_cnt"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got[i].state, name)),
                getattr(res.state, name).numpy())
        assert got[i].events == res.events
        assert got[i].disruption.as_dict() == \
            solo.last_disruption.as_dict()


def test_sweep_multi_faults_matches_jax():
    """schedule_pods_sweep_multi(fault_specs=) over tuned traces, one lane
    fault-free: each lane equals tpusim's."""
    jsim, psim = _sims("06-FGD", num_nodes=40, num_pods=100)
    for sim in (jsim, psim):
        sim.set_typical_pods()
    tunes = (0.0, 1.2, 1.1)
    jpods = [jsim.prepare_pods(tuning_ratio=t) for t in tunes]
    ppods = [psim.prepare_pods(tuning_ratio=t) for t in tunes]
    specs = _chaos_specs(jfaults)[:2], _chaos_specs(pfaults)[:2]
    weights = [[1000]] * 3
    want = jsweep_multi(jsim, jpods, weights,
                        fault_specs=[specs[0][0], None, specs[0][1]])
    got = psweep_multi(psim, ppods, weights,
                       fault_specs=[specs[1][0], None, specs[1][1]])
    for g, w in zip(got, want):
        _same_sweep_lane(g, w)
    assert got[1].disruption.evicted_pods == 0


def test_apply_sweep_faults_matches_jax(tmp_path):
    """apply --sweep-faults with the README's faults.json on example/, and
    with dense lanes that fire on its three pods: standard output byte for
    byte without the [Engine] lines and the [Chaos] line's engine; the
    README run's has the digest chip_smoke.py holds the card's to."""
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(chip_smoke.CHAOS_FAULTS))
    argv = list(chip_smoke.CHAOS_APPLY_ARGS)
    argv[1] = os.path.join(REPO, argv[1])
    argv[3] = os.path.join(REPO, argv[3])
    argv[5] = str(path)
    port, jax_out = _apply_both(argv)
    assert chip_smoke.chaos_stdout(port) == chip_smoke.chaos_stdout(jax_out)
    assert "[Chaos] 3 fault lanes" in port
    assert chip_smoke.digest_text(chip_smoke.chaos_stdout(jax_out)) == \
        chip_smoke.CHAOS_APPLY_SHA256
    dense = {"faults": [dict(mtbf_events=1, mttr_events=1,
                             evict_every_events=1, seed=s, max_retries=1)
                        for s in (5, 6)], "seeds": [42, 3]}
    path.write_text(json.dumps(dense))
    port, jax_out = _apply_both(argv)
    assert chip_smoke.chaos_stdout(port) == chip_smoke.chaos_stdout(jax_out)


# ---- the card's digests (full openb; slow) ----

def jax_lane_digests(mid, mode):
    """The JAX package's digests of a chip_smoke.FAULT_SCAN_SHA256 run: the
    row's fault run with per-event reports off under `mode`, on its
    lane."""
    jn, jp, _, _ = openb_rows()
    jcfg = dataclasses.replace(method_configs(ROWS[mid])[0],
                               report_per_event=False, fault_mode=mode)
    jsim = JSimulator(jn, jcfg)
    jsim.set_workload_pods(jp)
    res = jsim.run_with_faults(jfaults.FaultConfig(**chip_smoke.FAULT_FLAGS))
    assert any("fault-lane replay" in line for line in jsim.log.lines)
    return dict(chip_smoke.result_digests(res),
                disruption=chip_smoke.disruption_digest(jsim.last_disruption))


@pytest.mark.slow
@pytest.mark.parametrize("mid", list(chip_smoke.FAULT_SCAN_SHA256))
def test_fault_scan_digests_pin_chip_smoke(mid):
    """tpusim's full-openb lane runs have the digests chip_smoke.py holds
    the card's lane runs to (about 40 s each)."""
    mode = chip_smoke.FAULT_SCAN_MODES[mid]
    assert jax_lane_digests(mid, mode) == chip_smoke.FAULT_SCAN_SHA256[mid]
