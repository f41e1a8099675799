"""The port's obs plane against the JAX package: the emitters' JSONL,
Prometheus and Chrome outputs (round-tripped, and the same text as
tpusim's for the same record), the heartbeat's exact tick count (the plain
replays, the oracle, and the host ring's drain, lapped or not), the run
telemetry (deterministic across same-seed runs; events, counters,
disruption and meta equal to tpusim's), the counters, and `apply` with its
six obs flags against `python -m tpusim apply`."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_decisions import _small_cluster, _small_rows
from tpusim.apply import Applier as JApplier
from tpusim.apply import ApplyOptions as JApplyOptions
from tpusim.io.trace import NodeRow as JNodeRow
from tpusim.io.trace import PodRow as JPodRow
from tpusim.obs import emitters as jemit
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim_torch.apply import REFUSED_OPTIONS, Applier, ApplyOptions
from tpusim_torch.obs import emitters, heartbeat
from tpusim_torch.obs.counters import (
    counters_from_events,
    counters_from_telemetry,
)
from tpusim_torch.obs.spans import Recorder
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.faults import FaultConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CR = os.path.join(REPO, "example", "test-cluster-config.yaml")
SCHED = os.path.join(REPO, "example", "test-scheduler-config.yaml")


def _run(sim_cls, cfg_cls, nodes, pods, faults=False, **knobs):
    cfg = cfg_cls(policies=(("FGDScore", 700), ("BestFitScore", 300)),
                  gpu_sel_method="FGDScore", report_per_event=True, seed=42,
                  record_decisions=True, series_every=5, **knobs)
    kw = {} if sim_cls is JSimulator else dict(device="cpu")
    sim = sim_cls(nodes, cfg, **kw)
    sim.set_workload_pods(pods)
    if faults:
        return sim, sim.run_with_faults(FaultConfig(
            mtbf_events=8, mttr_events=12, seed=3) if sim_cls is Simulator
            else __import__("tpusim.sim.faults", fromlist=["x"]).FaultConfig(
                mtbf_events=8, mttr_events=12, seed=3))
    return sim, sim.run()


def test_telemetry_deterministic_and_equal_to_tpusim():
    """Two same-seed runs give byte-identical deterministic blocks; against
    tpusim's, events, counters, disruption and meta are equal (a fault run
    too). Left out: `engines` (the port names its kernels, tpusim its
    engines), `pallas_residency` (the port records its replay kernels'
    tier; tpusim's table engine ran no Pallas kernel), `degrades` and
    `counts` (tpusim's fallback paths and cache counters, which the port
    does not have: no fallback)."""
    nodes, pods = _small_cluster()
    jn, jp = _small_rows()
    jnodes, jpods = [JNodeRow(*n) for n in jn], [JPodRow(*p) for p in jp]
    for faults in (False, True):
        _, a = _run(Simulator, SimulatorConfig, nodes, pods, faults)
        _, b = _run(Simulator, SimulatorConfig, nodes, pods, faults)
        _, j = _run(JSimulator, JConfig, jnodes, jpods, faults)
        da, db = (json.dumps(r.telemetry.to_record()["deterministic"],
                             sort_keys=True) for r in (a, b))
        assert da == db
        got = a.telemetry.to_record()["deterministic"]
        want = j.telemetry.to_record()["deterministic"]
        for key in ("events", "counters", "disruption", "meta"):
            assert got[key] == want[key], (faults, key)
        assert got["engines"] and set(got) == set(want)
        names = {s.name for s in a.telemetry.spans}
        # as tpusim's, the fault loop fetches its segments outside a span
        assert {"typical_pods", "scan", "metrics_postpass", "report"} | (
            set() if faults else {"fetch"}) <= names
        assert names == {s.name for s in j.telemetry.spans} - {
            "init_tables"}


def test_emitters_round_trip_and_match_tpusim(tmp_path):
    """The JSONL record reads back equal, the Prometheus textfile parses
    strictly (one TYPE line a metric, escaped labels) and the Chrome trace
    is JSON with X and C events; each is tpusim's text for the same
    record."""
    nodes, pods = _small_cluster()
    sim, res = _run(Simulator, SimulatorConfig, nodes, pods, profile=True)
    from tpusim_torch.obs.series import series_to_record, series_tracks

    record = emitters.build_record(sim.run_telemetry(), series=(
        series_to_record(res.series, 5, ["FGDScore", "BestFitScore"])))
    tracks = sim.event_counter_series()
    tracks.update(series_tracks(res.series))
    spans = sim.run_telemetry().spans
    for mod, tag in ((emitters, "p"), (jemit, "j")):
        mod.emit_record(record, spans, jsonl=str(tmp_path / f"{tag}.jsonl"),
                        metrics=str(tmp_path / f"{tag}.prom"),
                        trace=str(tmp_path / f"{tag}.json"),
                        counter_series=tracks)
    for ext in ("jsonl", "prom", "json"):
        assert (tmp_path / f"p.{ext}").read_text() == \
            (tmp_path / f"j.{ext}").read_text(), ext
    assert emitters.read_jsonl(str(tmp_path / "p.jsonl")) == \
        [json.loads(json.dumps(record))]
    prom = emitters.parse_prometheus_text((tmp_path / "p.prom").read_text())
    assert prom[("tpusim_events_total", ())] == record["deterministic"][
        "events"]
    assert prom[("tpusim_series_samples", ())] == len(res.series.pos)
    trace = json.loads((tmp_path / "p.json").read_text())["traceEvents"]
    assert {e["ph"] for e in trace} == {"X", "C"}
    assert any(e["name"] == "frag_gpu_milli" for e in trace)
    weird = 'a"b\\c\nd'
    assert emitters.unescape_label_value(
        emitters.escape_label_value(weird)) == weird


@pytest.mark.parametrize("engine,block", [("auto", -1), ("auto", 128),
                                          ("sequential", 0)],
                         ids=["flat", "blocked", "oracle"])
def test_heartbeat_ticks_exactly_once_a_stride(engine, block):
    """One tick at each multiple of heartbeat_every, plus the final one:
    the plain replays and the oracle tick from their loops."""
    nodes, pods = _small_cluster()
    lines = []
    real = heartbeat.configure

    def configure(*a, **k):
        real(*a, **dict(k, sink=lines.append))
    heartbeat.configure = configure
    try:
        sim = Simulator(nodes, SimulatorConfig(
            policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
            heartbeat_every=4, engine=engine, block_size=block,
            report_per_event=False), device="cpu")
        sim.set_workload_pods(pods)
        sim.run()
    finally:
        heartbeat.configure = real
    assert heartbeat.tick_count() == len(pods) // 4 + 1
    assert lines[-1].startswith("[obs] replay: 30/30 events done")


class _Ring:
    """A stand-in for kernels.MappedBuffer: host words a 'kernel' writes."""

    def __init__(self, slots):
        self.w = np.zeros(1 + slots, np.int32)

    def words(self):
        return self.w

    def zero(self):
        self.w[:] = 0

    def write(self, j, done):
        self.w[1 + j % (len(self.w) - 1)] = done
        self.w[0] = j + 1


class _Done:
    def query(self):
        return True


def test_ring_ticker_delivers_every_tick_even_lapped():
    """RingTicker hands each tick to heartbeat.tick in order, recovering
    the ticks a lapping writer overwrote from the stride."""
    ticks = []
    real = heartbeat.tick
    heartbeat.tick = ticks.append
    try:
        for writes, slots in ((3, 8), (50, 4)):
            ring = _Ring(slots)
            t = heartbeat.RingTicker(ring, 5, start_count=12)
            t.start()
            ticks.clear()
            for j in range(writes):  # ticks at 15, 20, 25, ...
                ring.write(j, 15 + 5 * j)
            assert t.stop(_Done()) == writes
            assert ticks == [15 + 5 * j for j in range(writes)]
    finally:
        heartbeat.tick = real


def test_counters_and_recorder():
    """counters_from_events (on the device, rebuilds last) agrees with
    counters_from_telemetry; the Recorder folds a tensor's counts with the
    padding correction."""
    kinds = torch.tensor([0, 0, 1, 2, 0, 2], dtype=torch.int32)
    nodes = torch.tensor([3, -1, 3, -1, 5, -1], dtype=torch.int32)
    got = counters_from_events(kinds, nodes, 4)
    assert got.tolist()[:5] == counters_from_telemetry(
        kinds.numpy(), nodes.numpy()).tolist()[:5]
    assert got.tolist() == [3, 2, 1, 1, 2, 4]
    rec = Recorder()
    rec.note_scan("replay", counters=got, pad_skips=1, events=5)
    assert rec.snapshot().counters["skips"] == 1


def _apply(module, argv_opts, out):
    opts = (ApplyOptions if module == "port" else JApplyOptions)(**argv_opts)
    (Applier if module == "port" else JApplier)(opts).run(out=out)


def test_apply_with_the_six_obs_flags_matches_tpusim(tmp_path):
    """`apply` with --profile, --metrics-out, --trace-out,
    --heartbeat-every, --decisions-out and --series-every on the example
    bundle: the same standard output as tpusim's (paths and [Engine]
    lines aside), the same decision file, and `report` of its record
    printing tpusim's text; REFUSED_OPTIONS holds only listen and
    policy."""
    assert set(REFUSED_OPTIONS) == {"listen", "policy"}
    outs = {}
    for tag in ("port", "jax"):
        opts = dict(simon_config=CR, default_scheduler_config=SCHED,
                    profile_out=str(tmp_path / f"{tag}.jsonl"),
                    metrics_out=str(tmp_path / f"{tag}.prom"),
                    trace_out=str(tmp_path / f"{tag}.trace.json"),
                    heartbeat_every=1,
                    decisions_out=str(tmp_path / f"{tag}.dec.jsonl"),
                    series_every=1)
        if tag == "port":
            opts["device"] = "cpu"
        buf = io.StringIO()
        with contextlib.redirect_stderr(io.StringIO()):
            _apply(tag, opts, buf)
        outs[tag] = [line.replace(f"{tag}.", "X.") for line in
                     buf.getvalue().splitlines() if "[Engine]" not in line]
    assert outs["port"] == outs["jax"]
    assert (tmp_path / "port.dec.jsonl").read_text() == \
        (tmp_path / "jax.dec.jsonl").read_text()
    from tpusim.cli import main as jcli
    from tpusim_torch.cli import main as pcli

    texts = []
    for main in (pcli, jcli):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["report", str(tmp_path / "port.jsonl")]) == 0
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "[series]" in texts[0]
    prom = emitters.parse_prometheus_text(
        (tmp_path / "port.prom").read_text())
    assert prom[("tpusim_counter_creates", ())] == 3
