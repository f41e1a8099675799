"""The Bellman series' disk cache of the port's driver
(Simulator._bellman_series): a rerun with identical inputs hits it and
reports the same bits; a later stage after a hit gives the bits of an
uncached run (the memo is rebuilt first); an empty TPUSIM_BELLMAN_CACHE
turns it off; tpusim's entries, keyed otherwise, are never read. The cache
directory comes from tmp_path."""

import dataclasses
import os

import numpy as np

import tests.test_torch_types_trace  # noqa: F401 (one torch thread)
from tests.test_torch_types_trace import openb_rows, paper_configs
from tpusim.sim.driver import Simulator as JSimulator
from tpusim_torch.sim.driver import Simulator

NODES, PODS = 60, 150


def _sim(package="port"):
    jn, jp, pn, pp = openb_rows()
    jcfg, pcfg = (dataclasses.replace(c, report_per_event=True,
                                      inflation_ratio=1.2, inflation_seed=5)
                  for c in paper_configs())
    if package == "jax":
        sim = JSimulator(jn[:NODES], jcfg)
        sim.set_workload_pods(jp[:PODS])
    else:
        sim = Simulator(pn[:NODES], pcfg, device="cpu")
        sim.set_workload_pods(pp[:PODS])
    return sim


def _run(sim):
    """run() and the inflation stage: the first Bellman series and a later
    one that depends on the memo the first warmed. Returns the log."""
    sim.run()
    sim.run_workload_inflation_evaluation("ScheduleInflation")
    return [line for line in sim.log.lines if "[Engine]" not in line]


def _entries(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_cache_hit_gives_the_uncached_bits(tmp_path, monkeypatch):
    """The first run writes one entry (its first series alone); a fresh
    Simulator with the same inputs is served its first series from it
    (no evaluator built for it), and its log, inflation stage included,
    equals the first run's and an uncached run's."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("TPUSIM_BELLMAN_CACHE", str(cache))
    first = _run(_sim())
    assert len(_entries(cache)) == 1
    hit = _sim()
    hit.run()
    assert hit._bellman_eval is None and hit._bellman_pending is not None
    hit.run_workload_inflation_evaluation("ScheduleInflation")
    assert hit._bellman_pending is None
    second = [line for line in hit.log.lines if "[Engine]" not in line]
    monkeypatch.setenv("TPUSIM_BELLMAN_CACHE", "")
    assert first == second == _run(_sim())
    assert any("(bellman)" in line for line in second)
    assert len(_entries(cache)) == 1


def test_empty_value_turns_the_cache_off(tmp_path, monkeypatch):
    """TPUSIM_BELLMAN_CACHE="" writes and reads nothing: every series is
    evaluated."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TPUSIM_BELLMAN_CACHE", "")
    sim = _sim()
    _run(sim)
    assert sim._bellman_eval is not None
    assert sim._bellman_cache_path(()) is None
    assert os.listdir(tmp_path) == []


def test_default_directory_is_the_repository_root(monkeypatch):
    """Without TPUSIM_BELLMAN_CACHE the entries live in .bellman_cache/ at
    the repository's root."""
    monkeypatch.delenv("TPUSIM_BELLMAN_CACHE", raising=False)
    sim = _sim()
    sim.set_typical_pods()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(sim._bellman_cache_path(())) == os.path.join(
        root, ".bellman_cache")


def test_port_never_reads_a_tpusim_entry(tmp_path, monkeypatch):
    """tpusim and the port share the directory but not a key: for the
    same typical pods and the same series inputs their cache files
    differ, so neither reads the other's."""
    monkeypatch.setenv("TPUSIM_BELLMAN_CACHE", str(tmp_path))
    port, jax = _sim(), _sim("jax")
    for sim in (port, jax):
        sim.set_typical_pods()
    assert port._typical_host_rows() == jax._typical_host_rows()
    rng = np.random.default_rng(0)
    inputs = tuple(np.ascontiguousarray(rng.integers(0, 100, 8).astype(t))
                   for t in (np.int32, np.int32, np.int32, np.int32,
                             np.uint8, np.int8, np.int32, np.int32))
    ours, theirs = (sim._bellman_cache_path(inputs) for sim in (port, jax))
    assert os.path.dirname(ours) == os.path.dirname(theirs) == str(tmp_path)
    assert ours != theirs
