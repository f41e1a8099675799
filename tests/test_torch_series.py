"""The port's cluster time-series (tpusim_torch.obs.series and the record
forms' plain samples) against the JAX package, tolerance 0: on the openb
shape (T = 48 typical pods, whose float32 frag rows sum in windows of 32)
through the driver's flat and blocked replays against tpusim's table
engine; the host half (records, rendering) against tpusim's on the same
inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_types_trace import NODE_CSV, POD_CSV
from tpusim.io.trace import build_events as jbuild_events
from tpusim.io.trace import load_node_csv as jload_nodes
from tpusim.io.trace import load_pod_csv as jload_pods
from tpusim.io.trace import pods_to_specs as jpods_to_specs
from tpusim.obs import series as jseries
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim.sim.typical import TypicalPodsConfig as JTypicalCfg
from tpusim_torch.io.trace import (
    build_events,
    load_node_csv,
    load_pod_csv,
    pods_to_specs,
)
from tpusim_torch.obs import series as pseries
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.typical import TypicalPodsConfig

NODES, EVENTS, EVERY = 300, 300, 7


@functools.lru_cache(maxsize=None)
def _jax_series(block):
    """tpusim's table engine on openb's first 300 nodes, the prepared
    trace's first 300 events, typical pods of the whole trace (T = 48)."""
    sim = JSimulator(jload_nodes(NODE_CSV)[:NODES], JConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
        report_per_event=False, series_every=EVERY, block_size=block,
        seed=42, typical_pods=JTypicalCfg(pod_popularity_threshold=95)))
    sim.set_workload_pods(jload_pods(POD_CSV))
    sim.set_typical_pods()
    pods = sim.prepare_pods()[:EVENTS]
    ek, ep = jbuild_events(pods)
    out = sim.run_events(sim.init_state, jpods_to_specs(pods, sim.node_index),
                         jnp.asarray(ek), jnp.asarray(ep),
                         jax.random.PRNGKey(42))
    return sim.typical.size, jseries.log_from_stacked(out.series), \
        np.asarray(out.counters)


@pytest.mark.parametrize("block", [-1, 128], ids=["flat", "blocked"])
def test_openb_series_matches_table_engine(block):
    """The samples of the driver's recording replay (the plain record
    forms) at T = 48 equal tpusim's bit for bit, frag rounding included,
    and the counters agree once tpusim's bucket padding is taken out."""
    t, want, jctr = _jax_series(block)
    assert t == 48
    sim = Simulator(load_node_csv(NODE_CSV)[:NODES], SimulatorConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
        report_per_event=False, series_every=EVERY, block_size=block,
        seed=42, typical_pods=TypicalPodsConfig(pod_popularity_threshold=95)),
        device="cpu")
    sim.set_workload_pods(load_pod_csv(POD_CSV))
    sim.set_typical_pods()
    pods = sim.prepare_pods()[:EVENTS]
    ek, ep = build_events(pods)
    out = sim.run_events(sim.init_state, pods_to_specs(pods, sim.node_index,
                                                       "cpu"), ek, ep)
    got = pseries.log_from_stacked(type(out.series)(
        *(np.asarray(x) for x in out.series)))
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), f
    pad = int(jctr[4])  # tpusim's bucket padding: EV_SKIP events
    assert out.counters.tolist()[:4] == jctr.tolist()[:4]
    assert out.counters.tolist()[4] == 0 and pad == 512 - EVENTS % 512
    assert len(got.pos) == (EVENTS - 1) // EVERY + 1


def test_series_record_and_report_match_tpusim():
    """series_to_record, series_from_record, series_tracks, sparkline and
    format_report give tpusim's output on the same log."""
    rng = np.random.default_rng(5)
    s, pi = 9, 2
    log = dict(
        pos=np.arange(s, dtype=np.int64) * 10,
        util_hist=rng.integers(0, 50, (s, 10)).astype(np.int32),
        nodes_down=rng.integers(0, 3, s).astype(np.int32),
        feasible=rng.integers(0, 300, s).astype(np.int32),
        frag=rng.integers(0, 10**6, (s, 7)).astype(np.int64),
        score_hi=rng.integers(0, 100, (s, pi)).astype(np.int32),
        score_lo=rng.integers(0, 100, (s, pi)).astype(np.int32),
        retry_depth=rng.integers(0, 4, s).astype(np.int64))
    plog, jlog = pseries.SeriesLog(**log), jseries.SeriesLog(**log)
    rec = pseries.series_to_record(plog, 10, ["FGDScore", "BestFitScore"])
    assert rec == jseries.series_to_record(jlog, 10,
                                           ["FGDScore", "BestFitScore"])
    back = pseries.series_from_record(rec)
    for f in back._fields:
        assert np.array_equal(back[f] if isinstance(f, int) else
                              getattr(back, f), log[f]), f
    assert pseries.series_tracks(plog) == jseries.series_tracks(jlog)
    assert pseries.format_report(rec) == jseries.format_report(rec)
    both = pseries.concat_series([plog, plog])
    assert len(both.pos) == 2 * s
    with pytest.raises(ValueError, match="not a tpusim-series-v1"):
        pseries.series_from_record(dict(rec, schema="x"))
