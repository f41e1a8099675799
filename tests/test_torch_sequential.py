"""The sequential oracle (tpusim_torch.sim.engine.make_replay) against the
JAX package's sequential engine, at tolerance 0: make_replay with per-event
reports off for every method row, Simon and the six-policy profile, and on
for two of them, on a seeded random cluster; the oracle against the
port's plain replay on the same inputs; its fault form through
run_with_faults; Simulator(engine="sequential") through the experiment CLI
(simon.log and the CSVs byte for byte against experiments/run.py), a seed
batch, a weight sweep and a chaos sweep, each lane against tpusim's
sequential lane."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_driver import ROWS
from tests.test_torch_fault_lane import (
    DENSE,
    _assert_same_lane,
    _assert_same_outputs,
    _capture,
    _chaos_specs,
    _same_sweep_lane,
)
from tests.test_torch_fault_lane import _sims as _fault_sims
from tests.test_torch_report import _cut, run_args, run_experiment
from tests.test_torch_sweep import (
    _assert_lanes_equal,
    _batch_sims,
    _configs,
    _no_engine,
)
from tests.test_torch_sweep import _sims as _sweep_sims
from tests.test_torch_types_trace import jfields
from tpusim.policies import make_policy as jmake_policy
from tpusim.sim import driver as jd
from tpusim.sim import faults as jfaults
from tpusim.sim.engine import make_replay as jmake_replay
from tpusim.types import NodeState as JNodeState
from tpusim.types import PodSpec as JPodSpec
from tpusim.types import TypicalPods as JTypicalPods
from tpusim_torch.__main__ import main as port_main
from tpusim_torch.io.trace import load_node_csv, load_pod_csv
from tpusim_torch.policies import make_policy
from tpusim_torch.sim import driver as pd
from tpusim_torch.sim import faults as pfaults
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim.engine import make_replay
from tpusim_torch.types import to_numpy

REPORT_ROWS = ("06-FGD", "default-profile")
KEY = (0, 3)


@functools.lru_cache(maxsize=None)
def _case():
    """A seeded random cluster of 40 nodes, 90 pods (CPU, share and whole
    GPU pods, a few pinned or model-constrained) with creates and deletes,
    24 typical pods and a tie-break rank: the port's tensors on the CPU and
    the JAX package's arrays."""
    port = chip_smoke.random_case(17, 40, 90, "cpu")
    state, pods, _, evk, evp, tp, rank = port
    jax_side = (JNodeState(**{k: jnp.asarray(v)
                              for k, v in to_numpy(state).items()}),
                JPodSpec(**{k: jnp.asarray(v)
                            for k, v in to_numpy(pods).items()}),
                jnp.asarray(evk.numpy()), jnp.asarray(evp.numpy()),
                JTypicalPods(**{k: jnp.asarray(v)
                                for k, v in to_numpy(tp).items()}),
                jnp.asarray(rank.numpy()))
    return port, jax_side


def _replays(row, report):
    _, policies, gpu_sel, dim_ext, norm = ROWS[row][:5]
    return (
        make_replay([(make_policy(n, dim_ext, norm), w)
                     for n, w in policies], gpu_sel, report=report),
        jmake_replay([(jmake_policy(n, dim_ext, norm), w)
                      for n, w in policies], gpu_sel, report=report))


def _assert_replay_equal(got, want):
    for name in ("placed_node", "dev_mask", "ever_failed", "event_node",
                 "event_dev"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name, w in jfields(want.state).items():
        np.testing.assert_array_equal(getattr(got.state, name).numpy(), w,
                                      err_msg=name)


@pytest.mark.parametrize("row,report", [
    (row[0], False) for row in chip_smoke.METHODS] + [
    (row, True) for row in REPORT_ROWS],
    ids=lambda v: str(v))
def test_make_replay_matches_jax(row, report):
    """Every output of the replay, the final state and, with reports on,
    every per-event metric row, bit for bit, under weights given as an
    operand (a row of 7s) where reports are off."""
    (state, pods, _, evk, evp, tp, rank), jcase = _case()
    replay, jreplay = _replays(row, report)
    weights = None if report else [7] * len(ROWS[row][1])
    want = jreplay(*jcase[:5], jax.random.PRNGKey(KEY[1]), jcase[5],
                   weights=weights)
    got = replay(state, pods, evk, evp, tp, KEY, rank, weights=weights)
    _assert_replay_equal(got, want)
    assert (got.metrics is None) == (not report)
    if report:
        for name in want.metrics._fields:
            g, w = getattr(got.metrics, name), getattr(want.metrics, name)
            assert g.numpy().dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    assert int((got.placed_node >= 0).sum()) > 30


@pytest.mark.parametrize("row", ["06-FGD", "05-BestFit", "01-Random",
                                 "default-profile"])
def test_oracle_equals_plain_replay(row):
    """The oracle, which recomputes every score from the state, against
    the port's plain replay, which refreshes tables: the same outputs."""
    (state, pods, types, evk, evp, tp, rank), _ = _case()
    _, policies, gpu_sel, dim_ext, norm = ROWS[row][:5]
    replay, _ = _replays(row, False)
    plain = fe.make_fused_replay(policies, gpu_sel, "cpu", dim_ext, norm)
    want = plain(state, pods, types, evk, evp, tp, KEY, rank)
    got = replay(state, pods, evk, evp, tp, KEY, rank)
    for name in ("placed_node", "dev_mask", "ever_failed", "event_node",
                 "event_dev"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for a, b in zip(got.state, want.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags", [
    ["-FGD", "1000", "-gpusel", "FGDScore"],
    ["-Random", "1000", "-gpusel", "random", "-dimext", "merge"],
], ids=["06-FGD", "01-Random"])
def test_sequential_experiment_matches_run_py(tmp_path, capsys, flags):
    """`python -m tpusim_torch --engine sequential --device cpu -d DIR`
    against experiments/run.py --engine sequential on a 60-node, 200-pod
    cut: simon.log (without [Engine]) and the CSVs byte for byte."""
    nodes, pods = _cut(tmp_path)
    common = ["-f", pods, "--node-trace", nodes, "-tune", "1.3",
              "-tuneseed", "42", "--shuffle-pod", "true", "--engine",
              "sequential", *flags]
    assert port_main(["--device", "cpu", "-d", str(tmp_path / "port"),
                      *common]) == 0
    run_experiment(run_args(["-d", str(tmp_path / "jax"), *common]))
    capsys.readouterr()
    want = chip_smoke.report_digests(tmp_path / "jax")
    assert chip_smoke.report_digests(tmp_path / "port") == want
    log = (tmp_path / "port" / "simon.log").read_text()
    assert "ran on: the sequential host loop (cpu)" in log


@pytest.mark.parametrize("row,mode", [("06-FGD", "scan"),
                                      ("01-Random", "scan")])
def test_sequential_fault_runs_match_jax(row, mode):
    """run_with_faults under engine "sequential", fault_mode scan, on 50
    nodes and 100 pods, a dense schedule: the oracle's fault form (its
    results, the steps' outputs and the final carry; 01-Random's draws
    from one key chain over the merged stream) against tpusim's
    sequential engine, bit for bit."""
    jsim, psim = _fault_sims(row, mode=mode, num_nodes=50, num_pods=100,
                             engine="sequential")
    _capture(jsim)
    _capture(psim)
    jsim.run_with_faults(jfaults.FaultConfig(**DENSE))
    psim.run_with_faults(pfaults.FaultConfig(**DENSE))
    dm = _assert_same_lane(jsim, psim)
    assert dm.node_failures and dm.evicted_pods and dm.rescheduled_pods
    assert psim.last_engine == "sequential"
    _assert_same_outputs(jsim, psim)


def test_sequential_seed_batch_matches_jax(tmp_path):
    """run_batch over two seeds under engine "sequential", reports on, on a
    60-node, 200-pod cut: each lane's results and log (but [Engine])
    against tpusim's sequential batch."""
    nodes_csv, pods_csv = _cut(tmp_path)
    jcfg, pcfg = (dataclasses.replace(c, engine="sequential")
                  for c in _configs((("FGDScore", 1000),), tune=1.3))
    from tpusim.io.trace import load_node_csv as jload_nodes
    from tpusim.io.trace import load_pod_csv as jload_pods

    seeds = (42, 43)
    jsims = _batch_sims(jd, jload_nodes(nodes_csv), jload_pods(pods_csv),
                        seeds, jcfg)
    psims = _batch_sims(pd, load_node_csv(nodes_csv), load_pod_csv(pods_csv),
                        seeds, pcfg)
    want = jd.run_batch(jsims)
    got = pd.run_batch(psims)
    for jsim, psim, g, w in zip(jsims, psims, got, want):
        np.testing.assert_array_equal(g.placed_node, np.asarray(w.placed_node))
        np.testing.assert_array_equal(g.dev_mask, np.asarray(w.dev_mask))
        assert _no_engine(psim.log.lines) == _no_engine(jsim.log.lines)
        assert psim.last_engine == "sequential"


def test_sequential_weight_sweep_matches_jax():
    """run_sweep over a weight grid with per-lane seeds under engine
    "sequential", reports on: every lane equals tpusim's sequential
    sweep lane."""
    jcfg, pcfg = (dataclasses.replace(c, engine="sequential")
                  for c in _configs())
    jsim, psim = _sweep_sims((jcfg, pcfg), 120, num_nodes=80)
    grid, seeds = [[1000, 500], [0, 1000], [300, 20]], [42, 7, 42]
    _assert_lanes_equal(psim.run_sweep(grid, seeds=seeds),
                        jsim.run_sweep(grid, seeds=seeds))
    assert psim.last_engine == "sequential"


def test_sequential_chaos_sweep_matches_jax():
    """run_sweep(faults=) with three lanes under engine "sequential": each
    lane equals tpusim's sequential chaos lane."""
    jsim, psim = _fault_sims("06-FGD", num_nodes=40, num_pods=100,
                             engine="sequential")
    weights, seeds = [[1000], [1000], [500]], [42, 7, 42]
    want = jsim.run_sweep(weights, seeds=seeds, faults=_chaos_specs(jfaults))
    got = psim.run_sweep(weights, seeds=seeds, faults=_chaos_specs(pfaults))
    for g, w in zip(got, want):
        _same_sweep_lane(g, w)
    assert psim.last_engine == "sequential"


# ---- the digests chip_smoke.py's seq phase holds the card to (slow) ----


def _jax_openb(mid, engine="sequential"):
    """tpusim's Simulator of a METHODS row on openb (tune 1.3, seeds 42),
    reports off, its typical pods set, its prepared trace's pod specs and
    events."""
    from tests.test_torch_driver import method_configs
    from tests.test_torch_types_trace import openb_rows
    from tpusim.io.trace import build_events, pods_to_specs

    jn, jp, _, _ = openb_rows()
    jcfg, _ = method_configs(ROWS[mid], 1.3)
    jsim = jd.Simulator(jn, dataclasses.replace(
        jcfg, engine=engine, report_per_event=False))
    jsim.set_workload_pods(jp)
    jsim.set_typical_pods()
    trace = jsim.prepare_pods()
    return (jsim, pods_to_specs(trace, jsim.node_index),
            *(np.asarray(a) for a in build_events(trace)))


@pytest.mark.slow
def test_seq_digests_pin_chip_smoke(tmp_path):
    """tpusim's sequential engine over the whole openb trace under 06-FGD,
    reports on, has SEQ_SHA256's digests, which equal the replay kernel's
    METHODS and REPORT_SHA256 digests."""
    import sys

    from tests.test_torch_driver import method_configs
    from tests.test_torch_types_trace import REPO, openb_rows

    sys.path.insert(0, os.path.join(REPO, "experiments"))
    from analysis import analyze_sim as janalyze_sim

    jn, jp, _, _ = openb_rows()
    row = ROWS["06-FGD"]
    jsim = jd.Simulator(jn, dataclasses.replace(
        method_configs(row, 1.3)[0], engine="sequential"))
    jsim.set_workload_pods(jp)
    res = jsim.run()
    got = {"placed": chip_smoke.digest(np.asarray(res.placed_node), np.int32),
           "dev_mask": chip_smoke.digest(np.asarray(res.dev_mask), np.uint8),
           "report": chip_smoke.experiment_report_digest(
               jsim, str(tmp_path), chip_smoke.row_meta(*row[1:4]),
               janalyze_sim)}
    assert got == chip_smoke.SEQ_SHA256
    assert (got["placed"], got["dev_mask"]) == row[5:7]
    assert got["report"] == chip_smoke.REPORT_SHA256["06-FGD"]


@pytest.mark.slow
@pytest.mark.parametrize("mid", sorted(chip_smoke.SEQ_PREFIX_SHA256))
def test_seq_prefix_digests_pin_chip_smoke(mid):
    """tpusim's sequential engine and its table engine over the first
    SEQ_PREFIX events of the prepared openb trace both have
    SEQ_PREFIX_SHA256's digests, and so does the port's oracle."""
    for engine in ("sequential", "table"):
        jsim, specs, evk, evp = _jax_openb(mid, engine)
        k = chip_smoke.SEQ_PREFIX
        out = jsim.run_events(jsim.init_state, specs, jnp.asarray(evk[:k]),
                              jnp.asarray(evp[:k]),
                              jax.random.PRNGKey(jsim.cfg.seed))
        assert {"placed": chip_smoke.digest(np.asarray(out.placed_node),
                                            np.int32),
                "dev_mask": chip_smoke.digest(np.asarray(out.dev_mask),
                                              np.uint8)} == \
            chip_smoke.SEQ_PREFIX_SHA256[mid], engine


@pytest.mark.slow
def test_seq_fault_digest_pins_chip_smoke():
    """tpusim's sequential fault engine over the first SEQ_FAULT_STEPS
    steps of FAULT_FLAGS' openb merged stream under 06-FGD has
    SEQ_FAULT_SHA256's digest."""
    from tpusim.policies import make_policy as jmp
    from tpusim.sim import fault_lane as jfl

    jsim, specs, evk, evp = _jax_openb("06-FGD")
    n, p = jsim.init_state.num_nodes, int(specs.cpu.shape[0])
    fcfg = jfaults.FaultConfig(**chip_smoke.FAULT_FLAGS)
    plan = jfl.compile_fault_plan(
        evk, evp, jfaults.generate_fault_schedule(n, len(evk), fcfg), fcfg,
        n, p)
    cut = chip_smoke.cut_plan(plan, chip_smoke.SEQ_FAULT_STEPS)
    ops = jfl.FaultOps(
        pos=jnp.asarray(cut.pos), arg=jnp.asarray(cut.arg),
        aux=jnp.asarray(cut.aux), draws=jnp.asarray(cut.draws),
        params=jnp.asarray(cut.params),
        gcnt=jnp.asarray(jsim.init_state.gpu_cnt))
    replay = jmake_replay([(jmp("FGDScore"), 1000)], "FGDScore",
                          report=False, faults=True,
                          fault_frag=cut.has_recover)
    out = replay(jsim.init_state, specs, jnp.asarray(cut.kind),
                 jnp.asarray(cut.idx), jsim.typical, jax.random.PRNGKey(42),
                 jsim.rank, fault_ops=ops,
                 fault_carry0=jfl.init_fault_carry(p, n, cut.capacity))
    ys = {f: np.asarray(getattr(out.fault_ys, f))
          for f in out.fault_ys._fields}
    assert chip_smoke.fault_steps_digest(
        np.asarray(out.placed_node), np.asarray(out.dev_mask),
        np.asarray(out.event_node), ys,
        np.asarray(out.fault_carry.dctr)) == chip_smoke.SEQ_FAULT_SHA256


@pytest.mark.slow
def test_seq_extender_digests_pin_chip_smoke():
    """tpusim's extender loop on EXTENDER_CASE against chip_smoke's stub
    extender has SEQ_EXTENDER_SHA256's digests, and so has the port's."""
    from tests.test_torch_types_trace import openb_rows, paper_configs
    from tpusim.sim.extender import ExtenderConfig as JExtenderConfig

    jn, jp, pn, pp = openb_rows()
    n, p = chip_smoke.EXTENDER_CASE
    with chip_smoke.ExtenderStub() as stub:
        jsim = jd.Simulator(jn[:n], dataclasses.replace(
            paper_configs(tune=0.0)[0], report_per_event=True,
            extenders=(JExtenderConfig(stub.url, "filter", "prioritize",
                                       weight=2),)))
        jsim.set_workload_pods(jp[:p])
        psim = pd.Simulator(pn[:n], chip_smoke.extender_config(stub.url),
                            device="cpu")
        psim.set_workload_pods(pp[:p])
        for sim, res in ((jsim, jsim.run()), (psim, psim.run())):
            assert {"placed": chip_smoke.digest(np.asarray(res.placed_node),
                                                np.int32),
                    "dev_mask": chip_smoke.digest(np.asarray(res.dev_mask),
                                                  np.uint8),
                    "log": chip_smoke.log_digest(sim.log.lines)} == \
                chip_smoke.SEQ_EXTENDER_SHA256
