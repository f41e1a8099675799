"""The port's decision records (tpusim_torch.obs.decisions, the record
forms' plain versions, the sequential oracle's records, the driver's
streams and the explain/diff CLI) against the JAX package, tolerance 0:
decisions on INVARIANT_FIELDS (and `block` against the blocked engine at
block_size 128), samples and counters of the plain replays against
tpusim's table engine (flat and blocked), and of the oracle against its
sequential engine; the decision files byte-equal to tpusim's on an openb
prefix, and `explain`/`diff` printing tpusim's text with its exit codes;
the streams of a chunked, a killed-and-resumed and a fault-segmented run;
each guard raising as tpusim's."""

import contextlib
import functools
import io
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_hbm_engine import _port_args, _random_case
from tests.test_torch_types_trace import NODE_CSV, POD_CSV
from tpusim.cli import main as jcli
from tpusim.io.trace import load_node_csv as jload_nodes
from tpusim.io.trace import load_pod_csv as jload_pods
from tpusim.obs.decisions import write_decisions as jwrite_decisions
from tpusim.obs.series import log_from_stacked as jlog_from_stacked
from tpusim.policies import make_policy as jmake_policy
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim.sim.engine import make_replay as jmake_replay
from tpusim.sim.table_engine import build_pod_types, make_table_replay
from tpusim_torch.cli import main as pcli
from tpusim_torch.io.trace import NodeRow, PodRow, load_node_csv, load_pod_csv
from tpusim_torch.obs.decisions import (
    INVARIANT_FIELDS,
    read_decisions,
    write_decisions,
)
from tpusim_torch.parallel.sharding import pad_nodes
from tpusim_torch.policies import make_policy
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.engine import make_replay
from tpusim_torch.sim.records import RecordSpec, decision_rows, sample_rows

EVERY = 7  # the series stride of the replay cases

# (label, policies, gpu_sel, block_size, case): flat and blocked, FGD,
# min-max (rebuilds), PWR+FGD, and the randomized flat replay, on
# _random_case's seed-61 cluster, which pins four pods, one to the padded
# last block ("random"), and on the record forms' edge case
# (chip_smoke.record_edge_fields: 301 nodes of repeated shapes, tied
# totals, creates with fewer than three feasible nodes or none, pinned
# creates feasible and not, a top-3 inside one block and across blocks)
CASES = [
    ("FGD/flat", (("FGDScore", 1000),), "FGDScore", -1, "random"),
    ("PWR+FGD/blocked", (("PWRScore", 500), ("FGDScore", 500)), "FGDScore",
     128, "random"),
    ("BestFit/blocked", (("BestFitScore", 1000),), "best", 128, "random"),
    ("Random+Packing/flat", (("RandomScore", 3), ("GpuPackingScore", 5)),
     "random", -1, "random"),
    ("edge FGD/flat", (("FGDScore", 1000),), "FGDScore", -1, "edge"),
    ("edge FGD/blocked", (("FGDScore", 1000),), "FGDScore", 128, "edge"),
    ("edge BestFit/flat", (("BestFitScore", 1000),), "best", -1, "edge"),
    ("edge BestFit/blocked", (("BestFitScore", 1000),), "best", 128,
     "edge"),
    ("edge PWR+BestFit+FGD/blocked", (("PWRScore", 500),
                                      ("BestFitScore", 300),
                                      ("FGDScore", 200)), "FGDScore", 128,
     "edge"),
    ("edge Random+random/flat", (("RandomScore", 1000),), "random", -1,
     "edge"),
]


def _edge_case():
    """chip_smoke.record_edge_fields as the JAX package's inputs
    (_random_case's tuple)."""
    from chip_smoke import record_edge_fields
    from tpusim.types import PodSpec as JPodSpec
    from tpusim.types import make_node_state as jmake_node_state
    from tpusim.types import make_typical_pods as jmake_typical_pods

    f = record_edge_fields()
    jpods = JPodSpec(**{k: jax.numpy.asarray(np.asarray(v, np.int32))
                        for k, v in f["pods"].items()})
    return (jmake_node_state(**f["nodes"]), jmake_typical_pods(f["typical"]),
            jpods, jax.numpy.asarray(f["kinds"]),
            jax.numpy.asarray(f["idx"]), jax.numpy.asarray(f["rank"]))


def _case(name):
    return _random_case(61, 300, 100) if name == "random" else _edge_case()


@functools.lru_cache(maxsize=None)
def _jax_records(policies, gpu_sel, block, case="random"):
    """tpusim's recording table engine on a case."""
    jstate, jtp, jpods, ek, ep, rank = _case(case)
    fn = make_table_replay([(jmake_policy(n), w) for n, w in policies],
                           gpu_sel=gpu_sel, block_size=block, decisions=True,
                           series_every=EVERY)
    return fn(jstate, jpods, build_pod_types(jpods), ek, ep, jtp,
              jax.random.PRNGKey(3), rank)


def _port_records(policies, gpu_sel, block, case="random"):
    state, pods, types, evk, evp, tp, _, rank = _port_args(*_case(case))
    cfg = fe.make_config(list(policies), gpu_sel)
    keep = {}
    spec = RecordSpec(True, EVERY, 0)
    if block > 0:
        padded, prank = pad_nodes(state, rank, 128)
        tables = fe.plain_init_tables(padded, types, tp, cfg)
        out, stats = he.plain_replay_blocked(
            padded, pods, types, evk, evp, tp, prank, tables, cfg, keep=keep,
            record=spec, n_real=state.num_nodes)
    else:
        tables = fe.plain_init_tables(state, types, tp, cfg)
        out = fe.plain_replay(state, pods, types, evk, evp, tp, rank, tables,
                              cfg, keep=keep, key=(0, 3), record=spec)
    rec = keep["records"]
    return (out, decision_rows(rec.dec.numpy(), len(policies), cfg.order),
            sample_rows(rec.ser.numpy(), len(policies), cfg.order), rec.ctr)


def _assert_fields(got, want, fields):
    for f in fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape and np.array_equal(a, b), f


@pytest.mark.parametrize("label,policies,gpu_sel,block,case", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_records_match_table_engine(label, policies, gpu_sel, block,
                                          case):
    """The record forms' plain versions equal tpusim's table engine:
    decisions (block too, for the blocked replay), samples, counters
    (rebuilds too: the port's blocked replay rebuilds on the JAX blocked
    engine's condition). On the edge case its edges must occur."""
    want = _jax_records(policies, gpu_sel, block, case)
    out, dec, ser, ctr = _port_records(policies, gpu_sel, block, case)
    assert np.array_equal(out.event_node.numpy(),
                          np.asarray(want.event_node))
    _assert_fields(dec, want.decisions,
                   INVARIANT_FIELDS + (("block",) if block > 0 else ()))
    if block < 0:
        assert (np.asarray(dec.block) == -1).all()
    wser = jlog_from_stacked(want.series)
    _assert_fields(ser, wser, ser._fields)
    assert ctr.tolist() == np.asarray(want.counters).tolist()
    assert len(ser.pos) > 10 and (np.asarray(dec.node) >= 0).sum() > 50
    if case == "edge":
        feas, tk, tt = (np.asarray(x) for x in (dec.feasible, dec.topk_node,
                                                 dec.topk_total))
        blocks = tk // 128
        assert ((feas > 0) & (feas < 3)).any() and (tk[:, 2] == -1).any()
        assert ((tk[:, 2] >= 0) & ((tt[:, 0] == tt[:, 1])
                                   | (tt[:, 1] == tt[:, 2]))).any()  # ties
        assert ((tk[:, 2] >= 0) & (blocks[:, 0] == blocks[:, 2])
                & (blocks[:, 1] == blocks[:, 2])).any()
        assert ((tk[:, 2] >= 0) & (blocks[:, 0] != blocks[:, 1])).any()
        assert ctr.tolist()[2] > 0  # creates that placed nothing
        if block > 0 and label.startswith("edge BestFit"):
            assert ctr.tolist()[5] > 0  # drift rebuilds


def _ticks(module, fn):
    """(fn()'s result, the processed counts `module`'s heartbeat ticks
    while it runs, lines swallowed)."""
    heard = []

    def listen(info):
        heard.append(info["done"])
    module.configure(0, "counting", sink=lambda line: None)
    module.add_listener(listen)
    try:
        return fn(), heard
    finally:
        module.remove_listener(listen)


@pytest.mark.parametrize("block", [-1, 128], ids=["flat", "blocked"])
def test_plain_counting_matches_table_engine(block):
    """The record forms' plain versions counting only (no decision, no
    series: the heartbeat's form) equal tpusim's table engine on the edge
    case under 06-FGD: placements, counters and the heartbeat's ticks."""
    from tpusim.obs import heartbeat as jheartbeat
    from tpusim_torch.obs import heartbeat

    every = 5
    jstate, jtp, jpods, ek, ep, rank = _case("edge")
    fn = make_table_replay([(jmake_policy("FGDScore"), 1000)],
                           gpu_sel="FGDScore", block_size=block,
                           heartbeat_every=every)
    def jrun():
        out = jax.block_until_ready(fn(jstate, jpods, build_pod_types(jpods),
                                       ek, ep, jtp, jax.random.PRNGKey(3),
                                       rank))
        jax.effects_barrier()  # every tick's callback delivered
        return out
    want, wticks = _ticks(jheartbeat, jrun)
    state, pods, types, evk, evp, tp, _, prank = _port_args(
        jstate, jtp, jpods, ek, ep, rank)
    cfg = fe.make_config([("FGDScore", 1000)], "FGDScore")
    spec = RecordSpec(heartbeat_every=every)
    keep = {}
    if block > 0:
        padded, prank = pad_nodes(state, prank, 128)
        tables = fe.plain_init_tables(padded, types, tp, cfg)
        run = functools.partial(
            he.plain_replay_blocked, padded, pods, types, evk, evp, tp,
            prank, tables, cfg, keep=keep, record=spec,
            n_real=state.num_nodes)
    else:
        tables = fe.plain_init_tables(state, types, tp, cfg)
        run = functools.partial(
            fe.plain_replay, state, pods, types, evk, evp, tp, prank,
            tables, cfg, keep=keep, key=(0, 3), record=spec)
    out, ticks = _ticks(heartbeat, run)
    out = out[0] if block > 0 else out
    rec = keep["records"]
    assert rec.dec is None and rec.ser is None
    assert np.array_equal(out.event_node.numpy(),
                          np.asarray(want.event_node))
    assert rec.ctr.tolist() == np.asarray(want.counters).tolist()
    assert ticks == sorted(int(t) for t in wticks)
    assert len(ticks) == len(ek) // every and rec.ctr.tolist()[2] > 0


@pytest.mark.parametrize("policies,gpu_sel", [
    ((("FGDScore", 1000),), "FGDScore"),
    ((("PWRScore", 500), ("BestFitScore", 300), ("RandomScore", 7)), "best"),
], ids=["FGD", "PWR+BestFit+Random"])
def test_oracle_records_match_sequential_engine(policies, gpu_sel):
    """The sequential oracle's decisions, samples and counters equal
    tpusim's sequential engine's (its own score rows: no tables)."""
    case = _random_case(66, 200, 100)
    jstate, jtp, jpods, ek, ep, rank = case
    want = jmake_replay([(jmake_policy(n), w) for n, w in policies],
                        gpu_sel, report=False, decisions=True,
                        series_every=5)(jstate, jpods, ek, ep, jtp,
                                        jax.random.PRNGKey(3), rank)
    state, pods, _, evk, evp, tp, _, prank = _port_args(*case)
    got = make_replay([(make_policy(n), w) for n, w in policies], gpu_sel,
                      report=False, decisions=True, series_every=5)(
        state, pods, evk, evp, tp, (0, 3), prank)
    _assert_fields(got.decisions, want.decisions, INVARIANT_FIELDS)
    wser = jlog_from_stacked(want.series)
    for f in wser._fields[:-1]:
        assert np.array_equal(getattr(got.series, f).numpy(),
                              np.asarray(getattr(wser, f))), f
    assert got.counters.tolist() == np.asarray(want.counters).tolist()


def _openb_cut():
    return (jload_nodes(NODE_CSV)[:200], jload_pods(POD_CSV)[:120],
            load_node_csv(NODE_CSV)[:200], load_pod_csv(POD_CSV)[:120])


@functools.lru_cache(maxsize=None)
def _jax_openb_file(policy, gpu_sel, path):
    jn, jp, _, _ = _openb_cut()
    sim = JSimulator(jn, JConfig(policies=((policy, 1000),),
                                 gpu_sel_method=gpu_sel,
                                 report_per_event=False,
                                 record_decisions=True, seed=42))
    sim.set_workload_pods(jp)
    res = sim.run()
    jwrite_decisions(path, res.decisions, policies=list(sim.cfg.policies),
                     meta=sim._telemetry_meta(),
                     pod_names=[p.name for p in res.pods])
    return path


def _port_openb_file(policy, gpu_sel, path, **knobs):
    _, _, pn, pp = _openb_cut()
    sim = Simulator(pn, SimulatorConfig(policies=((policy, 1000),),
                                        gpu_sel_method=gpu_sel,
                                        report_per_event=False,
                                        record_decisions=True, seed=42,
                                        **knobs), device="cpu")
    sim.set_workload_pods(pp)
    res = sim.run()
    write_decisions(path, res.decisions, policies=list(sim.cfg.policies),
                    meta=sim._telemetry_meta(),
                    pod_names=[p.name for p in res.pods])
    return path


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        code = main(argv)
    return code, out.getvalue()


def test_openb_decision_files_and_cli_match_tpusim(tmp_path):
    """On openb's first 200 nodes and 120 pods: the port's decision files
    (FGD flat, FGD blocked, BestFit) are byte-equal to tpusim's, and
    `explain` and `diff` print tpusim's text with its exit codes (0 on
    identical runs, 1 on divergence, 2 on a torn file)."""
    ja = _jax_openb_file("FGDScore", "FGDScore", str(tmp_path / "ja.jsonl"))
    jb = _jax_openb_file("BestFitScore", "best", str(tmp_path / "jb.jsonl"))
    pa = _port_openb_file("FGDScore", "FGDScore", str(tmp_path / "pa.jsonl"))
    pb = _port_openb_file("BestFitScore", "best", str(tmp_path / "pb.jsonl"))
    pab = _port_openb_file("FGDScore", "FGDScore",
                           str(tmp_path / "pab.jsonl"), block_size=128)
    for port, jaxf in ((pa, ja), (pb, jb)):
        assert open(port).read() == open(jaxf).read()
    _, rows_b = read_decisions(pab)
    _, rows_a = read_decisions(pa)
    for ra, rb in zip(rows_a, rows_b):
        assert {k: v for k, v in ra.items() if k != "block"} == \
            {k: v for k, v in rb.items() if k != "block"}
        assert rb["block"] == (ra["node"] // 128 if ra["node"] >= 0 else -1)
    first = None
    for argv in (["diff", pa, pb], ["diff", pa, ja], ["explain", pa, "-e",
                                                       "0"],
                 ["explain", pa, "-e", "5000"]):
        code, text = _cli(pcli, argv)
        jcode, jtext = _cli(jcli, argv)
        assert (code, text) == (jcode, jtext), argv
        if argv[0] == "diff" and argv[2] == pb:
            assert code == 1 and "first divergence at event" in text
            first = int(text.split("first divergence at event ")[1].split()[0])
        elif argv[0] == "diff":
            assert code == 0
    assert _cli(pcli, ["explain", pa, "-e", str(first)])[0] == 0
    assert _cli(pcli, ["explain", pa, "-e", "5000"])[0] == 2
    with open(pa, "r+") as f:
        f.truncate(os.path.getsize(pa) - 40)
    assert _cli(pcli, ["diff", pa, pb]) == _cli(jcli, ["diff", pa, pb])
    assert _cli(pcli, ["diff", pa, pb])[0] == 2


def _small_rows():
    """(node rows, pod rows) of a 12-node cluster and 30 pods, as tuples."""
    rng = np.random.default_rng(31)
    nodes = [(f"n{i}", 32000, 131072, int(g), "V100M16" if g else "")
             for i, g in enumerate(rng.choice([0, 2, 4, 8], 12))]
    pods = [(f"p{i}", int(rng.choice([1000, 4000])), 1024,
             int(rng.choice([0, 1])), 500) for i in range(30)]
    return nodes, pods


def _small_cluster():
    nodes, pods = _small_rows()
    return [NodeRow(*n) for n in nodes], [PodRow(*p) for p in pods]


def _port_events_run(every, ckdir, **knobs):
    from tpusim_torch.io.trace import pods_to_specs

    nodes, pods = _small_cluster()
    sim = Simulator(nodes, SimulatorConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
        checkpoint_every=every, checkpoint_dir=str(ckdir),
        record_decisions=True, series_every=4, **knobs), device="cpu")
    sim.set_workload_pods(pods)
    sim.set_typical_pods()
    kinds = np.zeros(len(pods), np.int32)
    idx = np.arange(len(pods), dtype=np.int32)
    return sim, sim.run_events(sim.init_state, pods_to_specs(pods, None,
                                                              "cpu"),
                               kinds, idx, key=(0, 2))


def test_chunked_and_resumed_streams_equal_one_launch(tmp_path, monkeypatch):
    """A chunked recording run and one killed after its first checkpoint
    and run again (resumed at event 10) give the uninterrupted run's
    decisions, samples and counters; the checkpoint carries them."""
    import tpusim_torch.io.storage as storage

    _, whole = _port_events_run(0, "")
    _, chunked = _port_events_run(10, tmp_path / "a")
    real = storage.save_checkpoint

    def killing_save(*a, **k):
        real(*a, **k)
        raise KeyboardInterrupt("preempted")

    monkeypatch.setattr(storage, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        _port_events_run(10, tmp_path / "b")
    monkeypatch.setattr(storage, "save_checkpoint", real)
    sim, resumed = _port_events_run(10, tmp_path / "b", block_size=128)
    assert any("resumed replay at event 10/30" in line
               for line in sim.log.lines)
    for run in (chunked, resumed):
        _assert_fields(run.decisions, whole.decisions,
                       INVARIANT_FIELDS)
        _assert_fields(run.series, whole.series, whole.series._fields)
        assert run.counters.tolist() == whole.counters.tolist()
    assert (np.asarray(resumed.decisions.block)[10:] >= 0).any()


def test_fault_segment_streams_match_tpusim():
    """A fault-segmented run's decisions and series (pos rebased onto the
    run's clock, a sample opening each segment, the retry depth filled)
    and its counters equal tpusim's segmented fault path."""
    from tpusim.io.trace import NodeRow as JNodeRow
    from tpusim.io.trace import PodRow as JPodRow
    from tpusim.sim.engine import EV_NODE_FAIL as JFAIL
    from tpusim.sim.faults import FaultEvent as JFaultEvent
    from tpusim_torch.sim.engine import EV_NODE_FAIL
    from tpusim_torch.sim.faults import FaultEvent

    nodes, pods = _small_cluster()
    jnodes, jpod_rows = _small_rows()
    common = dict(policies=(("FGDScore", 700), ("BestFitScore", 300)),
                  gpu_sel_method="FGDScore", report_per_event=False,
                  seed=42, record_decisions=True, series_every=4)
    jsim = JSimulator([JNodeRow(*n) for n in jnodes], JConfig(**common))
    jpods = [JPodRow(*p) for p in jpod_rows]
    jsim.set_workload_pods(jpods)
    want = jsim.schedule_pods_with_faults(
        jpods, faults=[JFaultEvent(pos=10, kind=JFAIL, node=0),
                       JFaultEvent(pos=17, kind=JFAIL, node=3)])
    sim = Simulator(nodes, SimulatorConfig(**common), device="cpu")
    sim.set_workload_pods(pods)
    got = sim.schedule_pods_with_faults(
        pods, faults=[FaultEvent(pos=10, kind=EV_NODE_FAIL, node=0),
                      FaultEvent(pos=17, kind=EV_NODE_FAIL, node=3)])
    _assert_fields(got.decisions.records, want.decisions.records,
                   INVARIANT_FIELDS)
    for f in ("ev_kind", "ev_pod"):
        assert np.array_equal(getattr(got.decisions, f),
                              np.asarray(getattr(want.decisions, f)))
    _assert_fields(got.series, want.series, want.series._fields)
    det = got.telemetry.to_record()["deterministic"]
    jdet = want.telemetry.to_record()["deterministic"]
    assert det["counters"] == jdet["counters"]
    assert det["disruption"] == jdet["disruption"]
    assert (np.diff(got.series.pos) > 0).all()
    # with no fault the segmented loop is one segment: the uninterrupted
    # run's streams
    sim = Simulator(nodes, SimulatorConfig(**common), device="cpu")
    sim.set_workload_pods(pods)
    whole = sim.schedule_pods(pods)
    seg = sim.schedule_pods_with_faults(pods, faults=[])
    _assert_fields(seg.decisions.records, whole.decisions.records,
                   whole.decisions.records._fields)
    _assert_fields(seg.series, whole.series, whole.series._fields)


def test_guards_raise_as_tpusim():
    """engine: pallas, extenders, seed batches and sweeps refuse decisions
    and the series with tpusim's messages; fault_mode="scan" refuses them
    too, and "auto" keeps a recording fault run on the segmented loop."""
    from tpusim_torch.sim.driver import dispatch_pods_batch, schedule_pods_sweep
    from tpusim_torch.sim.extender import ExtenderConfig
    from tpusim_torch.sim.faults import FaultConfig

    nodes, pods = _small_cluster()
    base = dict(policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore")
    for knob in (dict(record_decisions=True), dict(series_every=5)):
        with pytest.raises(ValueError, match="pallas"):
            Simulator(nodes, SimulatorConfig(engine="pallas", **base, **knob),
                      device="cpu")
        with pytest.raises(ValueError, match="extenders"):
            Simulator(nodes, SimulatorConfig(
                extenders=(ExtenderConfig(url_prefix="http://x"),), **base,
                **knob), device="cpu")
        sim = Simulator(nodes, SimulatorConfig(**base, **knob), device="cpu")
        sim.set_workload_pods(pods)
        with pytest.raises(ValueError, match="schedule_pods_batch cannot"):
            dispatch_pods_batch([sim], [pods])
        with pytest.raises(ValueError, match="schedule_pods_sweep cannot"):
            schedule_pods_sweep(sim, pods, [[1000]])
        scan = Simulator(nodes, SimulatorConfig(fault_mode="scan",
                                                report_per_event=False,
                                                **base, **knob), device="cpu")
        scan.set_workload_pods(pods)
        with pytest.raises(ValueError, match="fault_mode='scan' cannot"):
            scan.run_with_faults(FaultConfig(mtbf_events=10, seed=1))
    with pytest.raises(ValueError, match="series_every must be >= 0"):
        Simulator(nodes, SimulatorConfig(series_every=-1, **base),
                  device="cpu")
    with pytest.raises(ValueError, match="fault plane"):
        make_replay([(make_policy("FGDScore"), 1)], decisions=True,
                    faults=True, report=False)


def test_fork_streams_equal_cold_fork_and_tpusim(tmp_path):
    """A warm fork resumed from a recording base run's ladder carries the
    base's streams up to its rung: its decisions, samples and counters
    equal the cold fork's and tpusim's fork's."""
    import tempfile

    from tests.test_torch_fork import TAIL_KIND, TAIL_POD, _rows

    nodes, pod_rows = _rows()
    knobs = dict(policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
                 checkpoint_every=4, checkpoint_keep=-1,
                 record_decisions=True, series_every=3)
    pods = [PodRow(*p) for p in pod_rows]
    fev = len(pods) - 2

    def port(ckdir):
        return Simulator([NodeRow(*r) for r in nodes], SimulatorConfig(
            checkpoint_dir=str(ckdir), **knobs), device="cpu")

    port(tmp_path / "a").schedule_pods(pods)
    warm_sim = port(tmp_path / "a")
    warm = warm_sim.schedule_pods_fork(pods, fev, TAIL_KIND, TAIL_POD)
    assert warm_sim.last_fork["source_cursor"] > 0
    cold = port(tmp_path / "b").schedule_pods_fork(pods, fev, TAIL_KIND,
                                                    TAIL_POD)
    from tpusim.io.trace import NodeRow as JNodeRow
    from tpusim.io.trace import PodRow as JPodRow

    jsim = JSimulator([JNodeRow(*r) for r in nodes], JConfig(
        checkpoint_dir=tempfile.mkdtemp(), **knobs))
    want = jsim.schedule_pods_fork([JPodRow(*p) for p in pod_rows], fev,
                                   TAIL_KIND, TAIL_POD)
    for got in (warm, cold):
        _assert_fields(got.decisions.records, want.decisions.records,
                       INVARIANT_FIELDS)
        _assert_fields(got.series, want.series, want.series._fields)
        det = got.telemetry.to_record()["deterministic"]["counters"]
        assert det == want.telemetry.to_record()["deterministic"][
            "counters"]
