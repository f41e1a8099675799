"""The port's learned policy (tpusim_torch.learn.policy; the learned columns
of the replays, sim/fused_engine.py `fold`) against the JAX package's
(tpusim.learn.policy), on the CPU with the plain versions.

Each feature's column and per-pod scorer against tpusim's feature kernel
(DOWN nodes, CPU-only pods, pad devices, typical-pod frequencies whose
float32 sums land on integer percents); the fold of the node-only features
against the per-feature sum; learned replays (the linear and bucketed
families, a family mixed with built-ins, gpu_sel FGDScore without an
enabled selector) through the plain flat and blocked replays, the
sequential oracle and a chunked run resumed from a checkpoint, on the
14-node synthetic cluster of tests/test_policy_learned.py and on an openb
prefix; decision rows and `explain`'s text; the signed artifact across the
two packages, byte for byte; parse_policy_spec; engine pallas refused.
The full openb digests that chip_smoke.py holds the card to are
slow-marked.
"""

import dataclasses
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tpusim.learn.policy as jpolicy
import tpusim_torch.io.storage as pstorage
import tpusim_torch.learn.policy as ppolicy
from tests.test_torch_types_trace import (
    openb_rows,
    paper_configs,
    port_state,
    port_typical,
)
from tpusim.io.trace import NodeRow as JNodeRow
from tpusim.io.trace import PodRow as JPodRow
from tpusim.obs import decisions as jdec
from tpusim.policies.base import ScoreContext as JContext
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim.types import TypicalPods as JTypical
from tpusim.types import make_node_state, make_pod
from tpusim_torch.io.trace import NodeRow, PodRow
from tpusim_torch.obs import decisions as pdec
from tpusim_torch.policies import is_policy_name, make_policy
from tpusim_torch.policies.base import ScoreContext
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.types import PodSpec

THETA = [700, -120, 45, 10, 80, -60, 33, 25, -200, 50]
THETA_B = THETA + [15, -25, 35, -45, 55, -65, 75, -85, 95, -105]


def _synth(seed=5, n=14, m=48):
    """tests/test_policy_learned.py's synthetic cluster and pods, as the
    node and pod row tuples both packages take."""
    rng = np.random.default_rng(seed)
    nodes = [(f"n{i:03d}", 32000, 131072, int(g), "V100M16" if g else "")
             for i, g in enumerate(rng.choice([0, 2, 4, 8], n))]
    pods = []
    for i in range(m):
        gpu = int(rng.choice([0, 1, 2]))
        milli = 1000 if gpu > 1 else int(rng.choice([0, 300, 500, 1000]))
        if gpu == 0:
            milli = 0
        pods.append((f"p{i:04d}", int(rng.choice([1000, 2000, 4000])), 2048,
                     gpu, milli))
    return nodes, pods


FAMILIES = {
    "linear": jpolicy.learned_policies(THETA),
    "bucketed": jpolicy.learned_policies(THETA_B, jpolicy.BUCKETED_FEATURES),
    "mixed": [("FGDScore", 500), ("LearnedScore[free_gpu_pct]", 30),
              ("LearnedScore[fit_dev_pct]", 11), ("PWRScore", 200),
              ("LearnedScore[q3_sat_pct]", -40),
              ("LearnedScore[frag_delta]", 70)],
}


def _both(policies, pods_rows=None, port_kw=None, **kw):
    """(tpusim's result, the port's result, the port's Simulator) of one
    run of `policies` on the synthetic cluster, the port on the CPU."""
    nodes, pods = _synth()
    pods = pods_rows or pods
    kw.setdefault("gpu_sel_method", "best")
    kw.setdefault("seed", 7)
    kw.setdefault("report_per_event", False)
    js = JSimulator([JNodeRow(*r) for r in nodes],
                    JConfig(policies=tuple(policies), **kw))
    js.set_workload_pods([JPodRow(*r) for r in pods])
    ps = Simulator([NodeRow(*r) for r in nodes],
                   SimulatorConfig(policies=tuple(policies), **kw,
                                   **(port_kw or {})), device="cpu")
    ps.set_workload_pods([PodRow(*r) for r in pods])
    return js.run(), ps.run(), ps


def _same_placements(pres, jres):
    assert np.array_equal(np.asarray(pres.placed_node),
                          np.asarray(jres.placed_node))
    assert np.array_equal(np.asarray(pres.dev_mask), np.asarray(jres.dev_mask))


# ---------------------------------------------------------------------------
# the feature columns
# ---------------------------------------------------------------------------


def _feature_case(freq):
    """A state with GPU and CPU-only nodes, a DOWN node (mem_left -1, its
    devices zeroed), partly used devices and pad devices, typical pods of
    frequencies `freq`, and pods of every kind (share, whole, CPU-only)."""
    state = make_node_state(
        cpu_cap=[32000, 64000, 16000, 32000, 96000, 8000],
        mem_cap=[131072, 131072, 65536, 262144, 131072, 32768],
        gpu_cnt=[4, 0, 8, 2, 8, 1],
        gpu_type=[0, -1, 4, 0, 4, 0],
    )
    g = np.asarray(state.gpu_left).copy()
    g[0, :4] = [1000, 400, 0, 750]
    g[3, :2] = [300, 1000]
    g[4, :8] = [1000, 1000, 500, 500, 1000, 200, 0, 1000]
    g[2] = 0
    state = state._replace(
        gpu_left=jnp.asarray(g, jnp.int32),
        mem_left=state.mem_left.at[2].set(-1),
        cpu_left=state.cpu_left.at[0].set(1000).at[4].set(-500))
    tp_rows = [(4000, 500, 1, 0), (8000, 1000, 1, 0), (2000, 250, 1, 0),
               (16000, 1000, 2, 0), (1000, 0, 0, 0), (6000, 750, 1, 0)]
    tp = JTypical(
        cpu=jnp.asarray([r[0] for r in tp_rows], jnp.int32),
        gpu_milli=jnp.asarray([r[1] for r in tp_rows], jnp.int32),
        gpu_num=jnp.asarray([r[2] for r in tp_rows], jnp.int32),
        gpu_mask=jnp.asarray([r[3] for r in tp_rows], jnp.int32),
        freq=jnp.asarray(freq, jnp.float32))
    # share types first, as the columns take them
    pods = [make_pod(cpu=1000, mem=2048, gpu_milli=500, gpu_num=1),
            make_pod(cpu=1000, mem=1024, gpu_milli=1, gpu_num=1),
            make_pod(cpu=2000, mem=4096, gpu_milli=1000, gpu_num=2),
            make_pod(cpu=4000, mem=8192, gpu_milli=0, gpu_num=0)]
    return state, tp, pods


# frequencies whose float32 subset sums land on (and just by) integer
# percents: 0.1 + 0.2, 0.07 + 0.29, 0.25 + 0.5, thirds
FREQS = [
    [0.1, 0.2, 0.7, 0.0, 0.0, 0.0],
    [0.07, 0.29, 0.14, 0.2, 0.1, 0.2],
    [0.25, 0.5, 0.125, 0.125, 0.0, 0.0],
    [1 / 3, 1 / 3, 1 / 3, 0.0, 0.0, 0.0],
]


@pytest.mark.parametrize("feature", jpolicy.FEATURE_NAMES)
def test_feature_column_and_scorer_match_tpusim(feature):
    """Every feature's column (all pod types on every node) and per-pod
    scorer equal tpusim's feature kernel, on each FREQS distribution."""
    policy = make_policy(f"LearnedScore[{feature}]")
    assert policy.normalize == "none" and not policy.self_select
    for freq in FREQS:
        state, tp, pods = _feature_case(freq)
        pstate, ptp = port_state(state), port_typical(tp)
        jfn = jpolicy.feature_policy(feature)
        n = state.cpu_left.shape[0]
        jctx = JContext(tp=tp, feasible=jnp.ones(n, bool), rng=None)
        types = PodSpec(*(torch.tensor([int(getattr(p, f)) for p in pods],
                                       dtype=torch.int32)
                          for f in PodSpec._fields))
        ks = 2
        col, sdev = policy.column(pstate, types, ks, ptp)
        assert (sdev == -1).all()
        for j, pod in enumerate(pods):
            want = np.asarray(jfn(state, pod, jctx).raw_scores)
            assert np.array_equal(col[j].numpy(), want), (feature, freq, j)
            host = PodSpec(*(int(getattr(pod, f)) for f in PodSpec._fields))
            got = policy.scorer(pstate, host, ScoreContext(
                ptp, torch.ones(n, dtype=torch.bool), None))
            assert np.array_equal(got.raw_scores.numpy(), want)
            assert ((want >= 0) & (want <= 100)).all()


def test_fold_equals_the_per_feature_sum():
    """The node column is sum theta_f x feature_f over the node-only
    features, wrapping as int32 (theta near the i32 bounds wraps), and a
    family's total through the folded tables equals the sum of its
    per-feature columns."""
    state, tp, _ = _feature_case(FREQS[1])
    pstate, ptp = port_state(state), port_typical(tp)
    feats = ppolicy.NODE_FEATURES
    rng = np.random.default_rng(3)
    for theta in (rng.integers(-4000, 4001, len(feats)),
                  np.full(len(feats), 2**31 // 90)):
        pol = [(f"LearnedScore[{f}]", int(w)) for f, w in zip(feats, theta)]
        pol.append(("LearnedScore[frag_delta]", 3))
        cfg = fe.make_config(pol, "best")
        assert [p.name for p in cfg.policies] == [
            "LearnedNode", "LearnedScore[frag_delta]"]
        k = 3
        got = fe.learned_node_column(pstate, k, ptp, cfg)
        rows = ppolicy.node_features(pstate, ptp).to(torch.int64)
        want = (torch.tensor(theta, dtype=torch.int64)[:, None] * rows).sum(0)
        want = ((want + 2**31) % 2**32 - 2**31).to(torch.int32)
        assert torch.equal(got, want.expand(k, -1))


def test_make_policy_resolves_every_feature():
    for f in ppolicy.FEATURE_NAMES:
        name = f"LearnedScore[{f}]"
        assert is_policy_name(name) and make_policy(name).name == name
    assert ppolicy.FEATURE_NAMES == jpolicy.FEATURE_NAMES
    assert ppolicy.LINEAR_FEATURES == jpolicy.LINEAR_FEATURES
    assert ppolicy.BUCKETED_FEATURES == jpolicy.BUCKETED_FEATURES
    assert not is_policy_name("LearnedScore[nope]")
    with pytest.raises(KeyError):
        make_policy("LearnedScore[nope]")


# ---------------------------------------------------------------------------
# learned replays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("residency", ["vmem", "hbm"])
@pytest.mark.parametrize("family,gpu_sel", [
    ("linear", "best"), ("bucketed", "best"), ("mixed", "best"),
    ("linear", "FGDScore"), ("mixed", "FGDScore")])
def test_learned_replay_matches_tpusim(family, gpu_sel, residency):
    """The plain flat and blocked replays of a learned family place every
    pod and device as tpusim does; gpu_sel FGDScore against a family that
    enables no FGDScore takes best fit, as tpusim's engines do."""
    jres, pres, ps = _both(FAMILIES[family], gpu_sel_method=gpu_sel,
                           port_kw=dict(table_residency=residency))
    assert ps.last_residency == residency
    _same_placements(pres, jres)


def test_learned_oracle_matches_tpusim():
    """The sequential oracle (the per-pod scorers) under both families."""
    for family in ("linear", "bucketed"):
        jres, pres, ps = _both(FAMILIES[family],
                               port_kw=dict(engine="sequential"))
        assert ps.last_engine.startswith("sequential")
        _same_placements(pres, jres)


def test_learned_chunked_run_resumes_exactly(tmp_path, monkeypatch):
    """A chunked learned run equals tpusim's; killed after its first
    checkpoint, a fresh Simulator resumes it and ends with the same
    placements."""
    real = pstorage.save_checkpoint
    saves = []

    def killing_save(*a, **k):
        saves.append(real(*a, **k))
        raise KeyboardInterrupt("simulated preemption")

    kw = dict(checkpoint_every=12, checkpoint_dir=str(tmp_path),
              engine="table")
    jres, pres, _ = _both(FAMILIES["linear"], port_kw=kw)
    _same_placements(pres, jres)
    monkeypatch.setattr(pstorage, "save_checkpoint", killing_save)
    with pytest.raises(KeyboardInterrupt):
        _both(FAMILIES["linear"], port_kw=kw)
    monkeypatch.setattr(pstorage, "save_checkpoint", real)
    assert saves and os.listdir(tmp_path)
    jres, pres, ps = _both(FAMILIES["linear"], port_kw=kw)
    assert any("[Checkpoint] resumed replay at event 12" in line
               for line in ps.log.lines)
    _same_placements(pres, jres)


def test_learned_openb_prefix_matches_tpusim():
    """256 openb pods, shuffled and tuned by the paper's protocol, under
    the linear family, flat and blocked."""
    jn, jp, pn, pp = openb_rows()
    for residency in ("vmem", "hbm"):
        jcfg, pcfg = paper_configs(tune=0.0)
        pol = tuple(FAMILIES["linear"])
        js = JSimulator(jn, dataclasses.replace(
            jcfg, policies=pol, gpu_sel_method="best"))
        js.set_workload_pods(jp[:256])
        ps = Simulator(pn, dataclasses.replace(
            pcfg, policies=pol, gpu_sel_method="best",
            table_residency=residency), device="cpu")
        ps.set_workload_pods(pp[:256])
        _same_placements(ps.run(), js.run())


@pytest.mark.parametrize("block", [-1, 128], ids=["flat", "blocked"])
def test_learned_fault_lane_matches_tpusim(block):
    """A learned family under a dense fault schedule (failures, recoveries,
    evictions, retries) through the in-scan fault lane, flat and blocked:
    placements, masks and the disruption metrics equal tpusim's lane."""
    from tpusim.sim import faults as jfaults
    from tpusim_torch.sim import faults as pfaults

    nodes, pods = _synth(n=20, m=60)
    kw = dict(policies=tuple(FAMILIES["mixed"]), gpu_sel_method="best",
              seed=7, report_per_event=False, fault_mode="scan",
              block_size=block)
    fcfg = dict(mtbf_events=6, mttr_events=9, evict_every_events=7, seed=3)
    js = JSimulator([JNodeRow(*r) for r in nodes], JConfig(**kw))
    js.set_workload_pods([JPodRow(*r) for r in pods])
    ps = Simulator([NodeRow(*r) for r in nodes], SimulatorConfig(**kw),
                   device="cpu")
    ps.set_workload_pods([PodRow(*r) for r in pods])
    jres = js.run_with_faults(jfaults.FaultConfig(**fcfg))
    pres = ps.run_with_faults(pfaults.FaultConfig(**fcfg))
    assert ps.last_engine.endswith("_faults")
    _same_placements(pres, jres)
    dm = ps.last_disruption
    assert dm.as_dict() == js.last_disruption.as_dict()
    assert dm.node_failures and dm.evicted_pods


def test_engine_pallas_refuses_a_learned_family():
    nodes, _ = _synth()
    cfg = dict(policies=tuple(FAMILIES["linear"]), engine="pallas")
    with pytest.raises(ValueError) as jerr:
        JSimulator([JNodeRow(*r) for r in nodes], JConfig(**cfg))
    with pytest.raises(ValueError) as perr:
        Simulator([NodeRow(*r) for r in nodes], SimulatorConfig(**cfg),
                  device="cpu")
    assert str(perr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# decisions, explain, the artifact
# ---------------------------------------------------------------------------


def test_learned_decisions_and_explain_match_tpusim(tmp_path):
    """A learned run's decision file is tpusim's, byte for byte (per
    feature raw and norm columns), every create's per-feature sum is its
    total, and `explain`'s text is tpusim's."""
    for block in (-1, 128):  # flat; blocked (the winner's block recorded)
        jres, pres, ps = _both(FAMILIES["linear"], record_decisions=True,
                               block_size=block)
        paths = []
        for mod, res, tag in ((jdec, jres, "j"), (pdec, pres, "p")):
            path = str(tmp_path / f"{tag}{block}.jsonl")
            mod.write_decisions(path, res.decisions,
                                policies=FAMILIES["linear"],
                                pod_names=[p.name for p in res.pods])
            paths.append(path)
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
        rec = pres.decisions.records
        creates = (np.asarray(pres.decisions.ev_kind) == 0) & \
            (np.asarray(rec.node) >= 0)
        sums = np.asarray(rec.norm, np.int64)[creates] @ np.asarray(THETA)
        assert np.array_equal(sums, np.asarray(rec.total)[creates])
        header, rows = pdec.read_decisions(paths[1])
        jheader, jrows = jdec.read_decisions(paths[0])
        for ev in (0, 5, 17):
            assert pdec.format_explain(header, rows, ev) == \
                jdec.format_explain(jheader, jrows, ev)


def test_artifact_is_tpusims_byte_for_byte(tmp_path):
    """An artifact either package writes, the other loads, and both write
    the same bytes; torn and unknown-feature files raise."""
    meta = {"trained": "es", "objective": 1.25}
    pp, jp = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    ppolicy.save_policy_artifact(pp, THETA, meta=meta)
    jpolicy.save_policy_artifact(jp, THETA, meta=meta)
    with open(pp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    assert jpolicy.load_policy_artifact(pp) == ppolicy.load_policy_artifact(jp)
    assert ppolicy.policies_from_artifact(jp) == \
        jpolicy.policies_from_artifact(pp)
    with open(pp) as f:
        lines = f.read().splitlines()
    doc = json.loads(lines[1])
    doc["theta"][0] += 1
    with open(pp, "w") as f:
        f.write(lines[0] + "\n" + json.dumps(doc, sort_keys=True,
                                             separators=(",", ":")) + "\n")
    with pytest.raises(ValueError, match="digest mismatch"):
        ppolicy.load_policy_artifact(pp)
    bad = str(tmp_path / "bad.json")
    pstorage.write_signed_json(bad, {"schema": ppolicy.POLICY_SCHEMA},
                               {"features": ["nope"], "theta": [1],
                                "meta": {}})
    with pytest.raises(ValueError, match="unknown learned feature"):
        ppolicy.load_policy_artifact(bad)


def test_parse_policy_spec_forms(tmp_path):
    path = str(tmp_path / "a.json")
    ppolicy.save_policy_artifact(path, THETA)
    for spec in ("learned", "learned-linear", "learned-bucketed",
                 "FGDScore", f"LearnedScore:{path}"):
        assert ppolicy.parse_policy_spec(spec) == \
            jpolicy.parse_policy_spec(spec)
    for spec in ("nope", f"LearnedScore:{tmp_path}/missing.json"):
        with pytest.raises(ValueError):
            ppolicy.parse_policy_spec(spec)
    with pytest.raises(ValueError, match="outside"):
        ppolicy.learned_policies([5000] + [0] * 9)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["linear", "bucketed"])
def test_learned_openb_digests(family):
    """tpusim's full openb run of each family gives chip_smoke.py's
    LEARN_SHA256, and so does the port's plain replay."""
    jn, jp, pn, pp = openb_rows()
    pol = tuple(chip_smoke.learn_families()[family])
    jcfg, pcfg = paper_configs()
    js = JSimulator(jn, dataclasses.replace(jcfg, policies=pol,
                                            gpu_sel_method="best"))
    js.set_workload_pods(jp)
    jres = js.run()
    want = chip_smoke.LEARN_SHA256[family]
    assert (hashlib.sha256(np.asarray(jres.placed_node, np.int32)
                           .tobytes()).hexdigest(),
            hashlib.sha256(np.asarray(jres.dev_mask, np.uint8)
                           .tobytes()).hexdigest()) == want
