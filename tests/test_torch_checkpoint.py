"""Exact checkpoint/resume of the port's chunked replay
(tpusim_torch.sim.table_engine's chunk surface, Simulator._run_chunked)
against tpusim, with zero tolerance.

The contract: for any cut of the event stream, with the carry taken to the
host and back between chunks (what a checkpoint file does), the chunked
replay gives tpusim's whole replay (placements, masks, failed flags,
per-event telemetry, final state) and, after each chunk, the key of
tpusim's event key chain. Through the driver: a chunked run equals the
unchunked one and tpusim's, metrics included; a run killed after a
checkpoint resumes from it and ends with the same bits; checkpoints are
content-addressed; a torn file is skipped with a [Degrade] line; the fault
host loop composes with checkpointing; an openb prefix resumes exactly.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusim_torch.io.storage as storage
from tests.fixtures import random_cluster, random_pods
from tests.test_table_engine import _events_with_deletes
from tests.test_torch_types_trace import (
    NODE_CSV,
    POD_CSV,
    assert_tree_equal,
    port_specs,
    port_state,
    port_typical,
    port_types,
)
from tpusim.io.trace import NodeRow as JNodeRow
from tpusim.io.trace import PodRow as JPodRow
from tpusim.io.trace import load_node_csv as jload_nodes
from tpusim.io.trace import load_pod_csv as jload_pods
from tpusim.io.trace import pods_to_specs as jpods_to_specs
from tpusim.policies import make_policy
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim.sim.table_engine import build_pod_types, make_table_replay
from tpusim_torch.io.trace import NodeRow, PodRow, pods_to_specs
from tpusim_torch.io.trace import load_node_csv, load_pod_csv
from tpusim_torch.sim import table_engine as te
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.engine import ReplayResult
from tpusim_torch.sim.faults import FaultConfig

# (policy, gpu_sel, the port's block_size): FGD and BestFit (min-max
# normalising) through both replay kernels' plain versions, RandomScore
# and gpu_sel random through the flat one (the key chain)
CHUNK_CASES = [
    ("FGDScore", "FGDScore", -1),
    ("FGDScore", "FGDScore", 128),
    ("BestFitScore", "best", -1),
    ("BestFitScore", "best", 128),
    ("RandomScore", "random", 0),
    ("FGDScore", "random", 0),
]


@functools.lru_cache(maxsize=None)
def _jax_table(policy, gpu_sel):
    return make_table_replay([(make_policy(policy), 1000)], gpu_sel=gpu_sel)


def _chunk_case():
    rng = np.random.default_rng(7)
    jstate, jtp = random_cluster(rng, num_nodes=20)
    jpods = random_pods(rng, num_pods=14)
    ev_kind, ev_pod = _events_with_deletes(14, rng)
    rank = jnp.asarray(rng.permutation(20).astype(np.int32))
    return jstate, jtp, jpods, ev_kind, ev_pod, rank


def _jax_chain(key, e):
    """tpusim's event key chain: the key after 0..e events."""
    keys = [key]
    for _ in range(e):
        key, _ = jax.random.split(key)
        keys.append(key)
    return [np.asarray(k).astype(np.uint32) for k in keys]


def _assert_result(got: ReplayResult, want):
    for field in ("placed_node", "dev_mask", "ever_failed", "event_node",
                  "event_dev"):
        assert np.array_equal(getattr(got, field).cpu().numpy(),
                              np.asarray(getattr(want, field))), field
    assert_tree_equal(got.state, want.state)


@pytest.mark.parametrize("policy,gpu_sel,block", CHUNK_CASES,
                         ids=lambda x: str(x))
def test_chunk_api_every_cut(policy, gpu_sel, block):
    """init_carry -> run_chunk -> run_chunk -> finish equals tpusim's whole
    replay at every cut point, the carry through carry_arrays and
    carry_from_arrays between the chunks, and the carry's key at the cut is
    tpusim's chain key."""
    jstate, jtp, jpods, ev_kind, ev_pod, rank = _chunk_case()
    key = jax.random.PRNGKey(3)
    want = _jax_table(policy, gpu_sel)(jstate, jpods, build_pod_types(jpods),
                                       ev_kind, ev_pod, jtp, key, rank)
    fn = te.make_table_replay([(policy, 1000)], gpu_sel, block)
    state, pods = port_state(jstate), port_specs(jpods)
    types, tp = port_types(build_pod_types(jpods)), port_typical(jtp)
    kinds = torch.as_tensor(np.array(ev_kind))
    idx = torch.as_tensor(np.array(ev_pod))
    prank = torch.as_tensor(np.array(rank))
    e = int(kinds.shape[0])
    chain = _jax_chain(key, e)
    for cut in range(1, e):
        carry = fn.init_carry(state, pods, types, tp, (0, 3), prank)
        assert isinstance(carry, te.BlockedTableCarry if block > 0
                          else te.FlatTableCarry)
        nodes, devs = [], []
        for a, b in ((0, cut), (cut, e)):
            carry, (n, d) = fn.run_chunk(carry, pods, types, kinds[a:b],
                                         idx[a:b], tp, prank)
            arrays = te.carry_arrays(carry)
            assert np.array_equal(arrays["key"], chain[b]), (cut, b)
            assert int(arrays["cursor"]) == b
            carry = te.carry_from_arrays(type(carry), arrays, "cpu")
            nodes.append(n)
            devs.append(d)
        got = ReplayResult(*fn.finish(carry), None, torch.cat(nodes),
                           torch.cat(devs))
        _assert_result(got, want)


def _driver_rows():
    rng = np.random.default_rng(31)
    gpus = rng.choice([0, 2, 4, 8], 12)
    rows = [(f"n{i}", 32000, 131072, int(g), "V100M16" if g else "")
            for i, g in enumerate(gpus)]
    pods = [(f"p{i}", int(rng.choice([1000, 4000])), 1024,
             int(rng.choice([0, 1])), 500) for i in range(30)]
    return rows, pods


def _run_port(every, ckdir, seed=42, **knobs):
    rows, pod_rows = _driver_rows()
    sim = Simulator([NodeRow(*r) for r in rows], SimulatorConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
        checkpoint_every=every, checkpoint_dir=str(ckdir), seed=seed,
        **knobs), device="cpu")
    pods = [PodRow(*p) for p in pod_rows]
    sim.set_workload_pods(pods)
    sim.set_typical_pods()
    specs = pods_to_specs(pods, None, "cpu")
    kinds = np.zeros(len(pods), np.int32)
    idx = np.arange(len(pods), dtype=np.int32)
    out = sim.run_events(sim.init_state, specs, kinds, idx, key=(0, 2))
    return sim, sim._attach_metrics(out, sim.init_state, specs, kinds, idx)


@functools.lru_cache(maxsize=None)
def _jax_driver_run():
    rows, pod_rows = _driver_rows()
    sim = JSimulator([JNodeRow(*r) for r in rows], JConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore"))
    pods = [JPodRow(*p) for p in pod_rows]
    sim.set_workload_pods(pods)
    sim.set_typical_pods()
    return sim.run_events(
        sim.init_state, jpods_to_specs(pods), jnp.zeros(len(pods), jnp.int32),
        jnp.arange(len(pods), dtype=jnp.int32), jax.random.PRNGKey(2))


def _assert_runs_equal(got, want):
    for a, b in zip(got[1:], want[1:]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for a, b in zip(got.state, want.state):
        assert torch.equal(a, b)
    for a, b in zip(got.metrics, want.metrics):
        assert torch.equal(a, b)


def test_driver_chunked_matches_plain_and_tpusim(tmp_path):
    """checkpoint_every routes run_events through _run_chunked; its result,
    the metric series included, equals the one-launch run and tpusim's,
    and a completed run leaves no checkpoint behind."""
    _, r0 = _run_port(0, "")
    sim, r1 = _run_port(10, tmp_path)
    assert sim.last_chunks == 3 and sim.last_run_digest
    assert any("3 chunks of 10 events" in line for line in sim.log.lines)
    _assert_runs_equal(r1, r0)
    want = _jax_driver_run()
    for field in ("placed_node", "dev_mask", "ever_failed", "event_node",
                  "event_dev"):
        assert np.array_equal(getattr(r1, field).numpy(),
                              np.asarray(getattr(want, field))), field
    for a, b in zip(r1.metrics, want.metrics):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert os.listdir(tmp_path) == []


def _killed_run(tmp_path, monkeypatch, after=1, **kw):
    """A chunked run stopped by an exception right after its `after`-th
    checkpoint landed (a preemption between chunks)."""
    real = storage.save_checkpoint
    saves = []

    def killing_save(*a, **k):
        saves.append(real(*a, **k))
        if len(saves) == after:
            raise KeyboardInterrupt("simulated preemption")
        return saves[-1]

    monkeypatch.setattr(storage, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        _run_port(10, tmp_path, **kw)
    monkeypatch.setattr(storage, "save_checkpoint", real)
    assert os.listdir(tmp_path)
    return saves


def test_kill_and_resume_bit_identity(tmp_path, monkeypatch):
    """Killed after its first checkpoint, the run started again in a fresh
    Simulator resumes at event 10 and ends with the uninterrupted run's
    placements, telemetry, metrics and state; the blocked replay resumes
    a checkpoint the flat one wrote, for the carry does not depend on the
    kernel."""
    _, r0 = _run_port(0, "")
    _killed_run(tmp_path, monkeypatch)
    sim, r2 = _run_port(10, tmp_path, block_size=128)
    assert any("[Checkpoint] resumed replay at event 10/30" in line
               for line in sim.log.lines)
    assert sim.last_chunks == 2 and sim.last_engine == "plain_replay_blocked"
    _assert_runs_equal(r2, r0)
    assert os.listdir(tmp_path) == []


def test_resume_is_content_addressed(tmp_path, monkeypatch):
    """Another input (the tie-break seed) is another digest: the run
    starts fresh instead of resuming into divergence."""
    _killed_run(tmp_path, monkeypatch, seed=42)
    sim, _ = _run_port(10, tmp_path, seed=43)
    assert not any("[Checkpoint]" in line for line in sim.log.lines)
    assert sim.last_chunks == 3


def test_torn_checkpoint_skipped_with_degrade(tmp_path, monkeypatch):
    """A torn newest checkpoint is skipped with a [Degrade] line and
    deleted; the run resumes from the newest valid one below it."""
    _, r0 = _run_port(0, "")
    saves = _killed_run(tmp_path, monkeypatch, after=2, checkpoint_keep=-1)
    with open(saves[1], "r+b") as f:
        f.truncate(100)
    sim, r2 = _run_port(10, tmp_path, checkpoint_keep=-1)
    lines = sim.log.lines
    assert any("[Degrade] skipping unusable checkpoint" in line
               for line in lines)
    assert any("resumed replay at event 10/30" in line for line in lines)
    _assert_runs_equal(r2, r0)


def test_fault_loop_composes_with_checkpoints(tmp_path):
    """The segmented fault loop calls run_events a segment, each chunked
    under checkpoint_every: placements, masks and the disruption metrics
    equal the unchunked fault run's, and no checkpoint is left."""
    rows, pod_rows = _driver_rows()
    pods = [PodRow(*p) for p in pod_rows]
    fcfg = FaultConfig(mtbf_events=8, mttr_events=6, evict_every_events=9,
                       seed=5, backoff_base=2, backoff_cap=8)
    results = []
    for every in (0, 3):
        sim = Simulator([NodeRow(*r) for r in rows], SimulatorConfig(
            policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
            checkpoint_every=every, checkpoint_dir=str(tmp_path),
            fault_mode="segments"), device="cpu")
        sim.set_workload_pods(pods)
        sim.set_typical_pods()
        res = sim.schedule_pods_with_faults(pods, fault_cfg=fcfg)
        results.append((res, sim.last_disruption.as_dict(), sim))
    (ra, da, _), (rb, db, sim_b) = results
    assert np.array_equal(ra.placed_node, rb.placed_node)
    assert np.array_equal(ra.dev_mask, rb.dev_mask)
    assert da == db and da["node_failures"] > 0
    assert any("chunks of 3 events" in line for line in sim_b.log.lines)
    assert os.listdir(tmp_path) == []


def test_openb_prefix_resume(tmp_path, monkeypatch):
    """On openb rows (the first 200 GPU nodes, the first 120 pods), a run
    killed after its second checkpoint resumes and equals tpusim's
    unchunked run, metrics included."""
    def run(every, d):
        sim = Simulator(load_node_csv(NODE_CSV)[:200], SimulatorConfig(
            policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
            checkpoint_every=every, checkpoint_dir=str(d)), device="cpu")
        pods = load_pod_csv(POD_CSV)[:120]
        sim.set_workload_pods(pods)
        sim.set_typical_pods()
        specs = pods_to_specs(pods, sim.node_index, "cpu")
        kinds = np.zeros(len(pods), np.int32)
        idx = np.arange(len(pods), dtype=np.int32)
        out = sim.run_events(sim.init_state, specs, kinds, idx, key=(0, 2))
        return sim, sim._attach_metrics(out, sim.init_state, specs, kinds,
                                        idx)

    real = storage.save_checkpoint
    count = []

    def killing_save(*a, **k):
        path = real(*a, **k)
        count.append(path)
        if len(count) == 2:
            raise KeyboardInterrupt("simulated preemption")
        return path

    monkeypatch.setattr(storage, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        run(30, tmp_path)
    monkeypatch.setattr(storage, "save_checkpoint", real)
    sim, got = run(30, tmp_path)
    assert any("resumed replay at event 60/120" in line
               for line in sim.log.lines)

    jsim = JSimulator(jload_nodes(NODE_CSV)[:200], JConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore"))
    jpods = jload_pods(POD_CSV)[:120]
    jsim.set_workload_pods(jpods)
    jsim.set_typical_pods()
    want = jsim.run_events(
        jsim.init_state, jpods_to_specs(jpods, jsim.node_index),
        jnp.zeros(120, jnp.int32), jnp.arange(120, dtype=jnp.int32),
        jax.random.PRNGKey(2))
    for field in ("placed_node", "dev_mask", "event_node"):
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(want, field))), field
    for a, b in zip(got.metrics, want.metrics):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert_tree_equal(got.state, want.state)
