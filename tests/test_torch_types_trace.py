"""The port's host-side trace path and domain model against the JAX package:
CSV loading, state and spec building, events, tie-break ranks, workload
preparation (tune 1.3, seed 42), typical pods and pod types must be equal,
exactly, on the committed openb CSVs; the numpy converters round-trip.

The helpers here are shared by the other tests/test_torch_*.py files."""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import tpusim.io.trace as jtrace
import tpusim.sim.table_engine as jtable
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim.sim.typical import TypicalPodsConfig as JTypicalCfg
from tpusim_torch import types as tt
from tpusim_torch.io import trace as ptrace
from tpusim_torch.sim import table_engine as ptable
from tpusim_torch.sim.driver import Simulator as PSimulator
from tpusim_torch.sim.driver import SimulatorConfig as PConfig
from tpusim_torch.sim.typical import TypicalPodsConfig as PTypicalCfg

# The port's CPU replays run small tensor ops in a Python event loop, where
# torch's intra-op threads gain nothing; in a parallel test run they only
# spin against the other processes' threads. Every tests/test_torch_*.py
# file that runs on the CPU imports this module.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE_CSV = os.path.join(REPO, "data/csv/openb_node_list_gpu_node.csv")
POD_CSV = os.path.join(REPO, "data/csv/openb_pod_list_default.csv")


def jfields(tree) -> dict:
    """A JAX NamedTuple as {field: numpy array}."""
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def port_state(jstate, device="cpu"):
    return tt.node_state_from_numpy(jfields(jstate), device)


def port_specs(jspecs, device="cpu"):
    return tt.pod_spec_from_numpy(jfields(jspecs), device)


def port_typical(jtp, device="cpu"):
    return tt.typical_pods_from_numpy(jfields(jtp), device)


def port_types(jtypes, device="cpu"):
    return ptable.PodTypes(
        port_specs(jtypes.share, device), port_specs(jtypes.whole, device),
        torch.as_tensor(np.array(jtypes.type_id), device=device),
    )


def assert_tree_equal(port_tree, jax_tree):
    got, want = tt.to_numpy(port_tree), jfields(jax_tree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def paper_configs(tune=1.3, shuffle=True):
    """(JAX config, port config) of the openb FGD run bench.py measures,
    without the per-event report block (tests/test_torch_report*.py run
    it)."""
    common = dict(policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
                  shuffle_pod=shuffle, tuning_ratio=tune, tuning_seed=42,
                  seed=42, report_per_event=False)
    return (
        JConfig(typical_pods=JTypicalCfg(pod_popularity_threshold=95),
                **common),
        PConfig(typical_pods=PTypicalCfg(pod_popularity_threshold=95),
                **common),
    )


@functools.lru_cache(maxsize=None)
def openb_rows():
    """(JAX node rows, JAX pod rows, port node rows, port pod rows)."""
    return (jtrace.load_node_csv(NODE_CSV), jtrace.load_pod_csv(POD_CSV),
            ptrace.load_node_csv(NODE_CSV), ptrace.load_pod_csv(POD_CSV))


@functools.lru_cache(maxsize=None)
def openb_prepared(tune=1.3, shuffle=True):
    """Both packages' Simulators with typical pods set, and their prepared
    (sorted, tuned) traces."""
    jn, jp, pn, pp = openb_rows()
    jcfg, pcfg = paper_configs(tune, shuffle)
    jsim = JSimulator(jn, jcfg)
    jsim.set_workload_pods(jp)
    jsim.set_typical_pods()
    psim = PSimulator(pn, pcfg, device="cpu")
    psim.set_workload_pods(pp)
    psim.set_typical_pods()
    return jsim, jsim.prepare_pods(), psim, psim.prepare_pods()


def _row_dicts(rows, fields):
    return [tuple(getattr(r, f) for f in fields) for r in rows]


def test_load_csvs_equal():
    jn, jp, pn, pp = openb_rows()
    nf = [f.name for f in dataclasses.fields(ptrace.NodeRow)]
    pf = [f.name for f in dataclasses.fields(ptrace.PodRow)]
    assert len(pn) == 1213 and len(pp) == 8152
    assert _row_dicts(pn, nf) == _row_dicts(jn, nf)
    assert _row_dicts(pp, pf) == _row_dicts(jp, pf)


def test_nodes_to_state_equal():
    jn, _, pn, _ = openb_rows()
    assert_tree_equal(ptrace.nodes_to_state(pn, "cpu"),
                      jtrace.nodes_to_state(jn))


def test_pods_to_specs_equal_with_pins():
    jn, jp, pn, pp = openb_rows()
    jrows, prows = list(jp[:200]), list(pp[:200])
    for rows in (jrows, prows):  # pin two pods, one to an unknown node
        rows[3] = dataclasses.replace(rows[3], pinned_node=jn[7].name)
        rows[9] = dataclasses.replace(rows[9], pinned_node="no-such-node")
    index = {n.name: i for i, n in enumerate(jn)}
    got = ptrace.pods_to_specs(prows, index, "cpu")
    assert_tree_equal(got, jtrace.pods_to_specs(jrows, index))
    assert got.pinned[3] == 7 and got.pinned[9] == len(index)


@pytest.mark.parametrize("use_timestamps", [False, True])
def test_build_events_equal(use_timestamps):
    _, jp, _, pp = openb_rows()
    jrows = [dataclasses.replace(p, unscheduled=(i % 97 == 5))
             for i, p in enumerate(jp[:500])]
    prows = [dataclasses.replace(p, unscheduled=(i % 97 == 5))
             for i, p in enumerate(pp[:500])]
    jk, ji = jtrace.build_events(jrows, use_timestamps)
    pk, pi = ptrace.build_events(prows, use_timestamps)
    assert np.array_equal(pk, jk) and np.array_equal(pi, ji)
    assert pk.dtype == jk.dtype and pi.dtype == ji.dtype


@pytest.mark.parametrize("seed", [0, 42, 233])
def test_tiebreak_rank_equal(seed):
    assert np.array_equal(ptrace.tiebreak_rank(1213, seed),
                          jtrace.tiebreak_rank(1213, seed))


@pytest.mark.parametrize("tune,shuffle", [(1.3, True), (1.3, False),
                                          (0.0, True)])
def test_prepare_pods_equal(tune, shuffle):
    jsim, jtr, psim, ptr = openb_prepared(tune, shuffle)
    pf = [f.name for f in dataclasses.fields(ptrace.PodRow)]
    assert _row_dicts(ptr, pf) == _row_dicts(jtr, pf)
    if tune:
        assert len(ptr) > 10_000  # the ~10.8k-event acceptance trace


def test_typical_pods_equal():
    jsim, _, psim, _ = openb_prepared()
    assert_tree_equal(psim.typical, jsim.typical)
    assert psim.typical.size % 16 == 0
    assert psim.log.lines[:2] == jsim.log.lines[:2]


def test_build_pod_types_equal_and_pad():
    _, jtr, _, ptr = openb_prepared()
    jspecs = jtrace.pods_to_specs(jtr)
    jtypes = jtable.build_pod_types(jspecs)
    ptypes = ptable.build_pod_types(ptrace.pods_to_specs(ptr, None, "cpu"))
    assert_tree_equal(ptypes.share, jtypes.share)
    assert_tree_equal(ptypes.whole, jtypes.whole)
    assert np.array_equal(ptypes.type_id.numpy(), np.asarray(jtypes.type_id))
    assert ptypes.num_types == 151
    jpad, ppad = jtable.pad_pod_types(jtypes), ptable.pad_pod_types(ptypes)
    assert_tree_equal(ppad.share, jpad.share)
    assert_tree_equal(ppad.whole, jpad.whole)
    assert np.array_equal(ppad.type_id.numpy(), np.asarray(jpad.type_id))


def test_converters_round_trip():
    from tests.fixtures import random_cluster, random_pods

    rng = np.random.default_rng(5)
    jstate, jtp = random_cluster(rng, num_nodes=12)
    jpods = random_pods(rng, num_pods=20)
    for conv, tree in ((port_state, jstate), (port_specs, jpods),
                       (port_typical, jtp)):
        got = conv(tree)
        assert_tree_equal(got, tree)
        again = type(got)(**{k: torch.as_tensor(v) for k, v in
                             tt.to_numpy(got).items()})
        assert_tree_equal(again, tree)
    with pytest.raises(ValueError, match="missing"):
        tt.node_state_from_numpy({"cpu_left": np.zeros(3)}, "cpu")
