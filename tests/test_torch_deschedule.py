"""The descheduler against the JAX package, at tolerance 0: the vector
helpers; eviction_scores (the frag score after each eviction, the cosine
similarity, the node frag) in float32 on random and partly used clusters
under typical-pod distributions of 16 to 64 rows; select_victims under the
three policies, a tie on names and equal priorities included; evict; the
whole deschedule_cluster (its log, placements, masks, creation ranks and
unscheduled pods) on an openb prefix; `python -m tpusim_torch -d` with
-r/-p, -y/-z, the typical-pod knobs, --emit-configs and
--analysis-from-log against experiments/run.py; apply's descheduleConfig
on the example bundle; and, slow-marked, the digests chip_smoke.py holds
the card's deschedule runs to."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.fixtures import (
    random_cluster,
    random_pods,
    typical_pods_gpu,
    typical_pods_with_nongpu,
)
from tests.test_torch_apply import SCHEDULERS, _apply_both
from tests.test_torch_driver import ROWS, method_configs
from tests.test_torch_report import _cut, run_args, run_experiment
from tests.test_torch_report_ops import _used_cluster
from tests.test_torch_types_trace import (
    REPO,
    jfields,
    openb_rows,
    port_specs,
    port_state,
    port_typical,
)
from tpusim.ops import vectormath as jvec
from tpusim.sim import deschedule as jdesched
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.typical import pad_typical_pods as jpad_typical
from tpusim.types import NodeState as JNodeState
from tpusim.types import make_typical_pods as jmake_typical
from tpusim_torch.__main__ import main as port_main
from tpusim_torch.experiment import get_args as port_args
from tpusim_torch.ops import vectormath as pvec
from tpusim_torch.sim import deschedule as pdesched
from tpusim_torch.sim.driver import Simulator as PSimulator

POLICIES = ("cosSim", "fragOnePod", "fragMultiPod")


@pytest.mark.parametrize("width", [2, 4, 40])
def test_vectormath_matches_jax(width):
    """cosine_similarity (zero vectors included), dot_product and
    l2_norm_diff over rows of 2, 4 and 40 (past XLA's tree window),
    normalize_by, and sigmoid with XLA's exp (its flush of subnormal
    results included), on seeded float32 values."""
    rng = np.random.default_rng(width)
    a = (rng.standard_normal((256, width)) * 1e3).astype(np.float32)
    b = (rng.standard_normal((256, width)) * 50).astype(np.float32)
    a[:3] = 0
    b[5] = 0
    norm = rng.integers(-2, 9, (256, width)).astype(np.float32)
    x = np.concatenate([(rng.standard_normal(4096) * 30).astype(np.float32),
                        np.float32([-200, -88, -87.8, 0, 88.8, 100])])
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for jf, pf in ((jvec.cosine_similarity, pvec.cosine_similarity),
                   (jvec.dot_product, pvec.dot_product),
                   (jvec.l2_norm_diff, pvec.l2_norm_diff)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(pf(ta, tb).numpy(), want)
    np.testing.assert_array_equal(
        pvec.normalize_by(ta, torch.as_tensor(norm)).numpy(),
        np.asarray(jvec.normalize_by(jnp.asarray(a), jnp.asarray(norm))))
    got = pvec.sigmoid(torch.as_tensor(x)).numpy()
    want = np.asarray(jvec.sigmoid(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _typical(kind, rng):
    """The fixture distributions, or a seeded one of `kind` rows padded to
    a multiple of 16 as the Simulator pads them."""
    if kind == "gpu":
        return typical_pods_gpu()
    if kind == "nongpu":
        return typical_pods_with_nongpu()
    rows = []
    for _ in range(kind):
        milli = int(rng.choice([0, 100, 250, 500, 1000]))
        num = 0 if milli == 0 else (
            1 if milli < 1000 else int(rng.choice([1, 2, 4, 8])))
        rows.append((int(rng.choice([1000, 4000, 8000, 16000, 32000])), milli,
                     num, int(rng.choice([0, 0, 1, 6])), float(rng.random())))
    total = sum(r[4] for r in rows)
    return jpad_typical(jmake_typical([r[:4] + (r[4] / total,) for r in rows]))


def _case(seed, kind, used=True, num_nodes=80, num_pods=400):
    """A cluster (partly used, or idle), a typical-pod distribution, pods
    and a placement with device masks, from a seed."""
    if used:
        state, _ = _used_cluster(seed, num_nodes)
        rng = np.random.default_rng(seed + 1000)
    else:
        rng = np.random.default_rng(seed)
        state, _ = random_cluster(rng, num_nodes)
    tp = _typical(kind, rng)
    pods = random_pods(rng, num_pods)
    placed = rng.integers(-1, num_nodes, num_pods).astype(np.int32)
    mask = (rng.random((num_pods, 8)) < 0.3) & (placed[:, None] >= 0)
    return state, tp, pods, placed, mask


@pytest.mark.parametrize("kind", ["gpu", "nongpu", 5, 20, 35, 60])
@pytest.mark.parametrize("used", [True, False], ids=["used", "idle"])
def test_eviction_scores_match_jax(kind, used):
    """new_frag, cos_sim and old_frag bit for bit (float32), on random
    and partly used clusters, under the fixture distributions and seeded
    ones of 5, 20, 35 and 60 rows (padded to T = 16, 32, 48, 64: each
    float32 order eviction_scores follows)."""
    for seed in (3, 4):
        state, tp, pods, placed, mask = _case(seed, kind, used)
        want = [np.asarray(x) for x in jdesched.eviction_scores(
            state, pods, jnp.asarray(placed), jnp.asarray(mask), tp)]
        got = [x.numpy() for x in pdesched.eviction_scores(
            port_state(state), port_specs(pods), placed, mask,
            port_typical(tp))]
        on = placed >= 0
        np.testing.assert_array_equal(got[0][on], want[0][on])
        np.testing.assert_array_equal(got[1][on], want[1][on])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("policy", POLICIES)
def test_select_victims_match_jax(policy):
    """The victims, in eviction order, at several ratios on random and
    partly used clusters."""
    for seed, kind, used in ((5, "gpu", True), (6, 20, True),
                             (7, 35, False), (8, "nongpu", True)):
        state, tp, pods, placed, mask = _case(seed, kind, used)
        names = [f"n{(i * 7) % 80:03d}" for i in range(80)]
        for ratio in (0.02, 0.1, 0.5, 1.0):
            want = jdesched.select_victims(state, pods, placed, mask, tp,
                                           policy, ratio, names)
            got = pdesched.select_victims(
                port_state(state), port_specs(pods), placed, mask,
                port_typical(tp), policy, ratio, names)
            assert got == want, (seed, ratio)


@pytest.mark.parametrize("policy", POLICIES)
def test_select_victims_ties_match_jax(policy):
    """A cluster built to tie: every node alike (so equal frags, equal
    heap priorities and equal similarities), two names shared by several
    nodes, the pods of each node identical; the tie-breaks (names, node
    order, first pod, the heap's tuples) pick the same victims."""
    n, per = 24, 3
    f = {"cpu_left": np.full(n, 1500, np.int32),
         "cpu_cap": np.full(n, 64000, np.int32),
         "mem_left": np.full(n, 100000, np.int32),
         "mem_cap": np.full(n, 262144, np.int32),
         "gpu_left": np.tile(np.array([600, 600, 1000, 1000, 0, 0, 0, 0],
                                      np.int32), (n, 1)),
         "gpu_cnt": np.full(n, 4, np.int32),
         "gpu_type": np.full(n, 1, np.int32),
         "cpu_type": np.zeros(n, np.int32),
         "aff_cnt": np.zeros((n, 9), np.int32)}
    state = JNodeState(**{k: jnp.asarray(v) for k, v in f.items()})
    rng = np.random.default_rng(11)
    pods = random_pods(rng, n * per)
    one = {k: np.asarray(getattr(pods, k))[:per] for k in pods._fields}
    pods = type(pods)(**{k: jnp.asarray(np.tile(v, n))
                         for k, v in one.items()})
    placed = np.repeat(np.arange(n, dtype=np.int32), per)
    mask = np.zeros((n * per, 8), bool)
    mask[:, 0] = np.asarray(pods.gpu_num) > 0
    names = ["dup-a" if i % 5 == 0 else "dup-b" if i % 7 == 0 else
             f"node-{n - i:03d}" for i in range(n)]
    tp = typical_pods_gpu()
    for ratio in (0.1, 0.5, 1.0):
        want = jdesched.select_victims(state, pods, placed, mask, tp,
                                       policy, ratio, names)
        got = pdesched.select_victims(
            port_state(state), port_specs(pods), placed, mask,
            port_typical(tp), policy, ratio, names)
        assert got == want, ratio


def test_evict_matches_jax():
    """evict: one scatter-add a field (cpu, mem, devices, affinity
    counts), victims sharing a node included."""
    state, tp, pods, placed, mask = _case(9, "gpu", True)
    victims = [int(i) for i in np.flatnonzero(placed >= 0)[:60]]
    want = jdesched.evict(state, pods, jnp.asarray(placed),
                          jnp.asarray(mask), victims)
    got = pdesched.evict(port_state(state), port_specs(pods), placed, mask,
                         victims)
    for name, w in jfields(want).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), w,
                                      err_msg=name)
    assert pdesched.evict(port_state(state), port_specs(pods), placed, mask,
                          []) is not None


def _strip(lines):
    return [line for line in lines if "[Engine]" not in line]


@pytest.mark.parametrize("policy", POLICIES)
def test_deschedule_cluster_matches_jax(policy):
    """Simulator.run() then deschedule_cluster() and PostDeschedule on the
    first 300 openb pods (06-FGD, per-event reports on): the log without
    its [Engine] lines (the budget line, PostEviction, the victims'
    per-event block, the counts), placements, masks, creation ranks and
    unscheduled pods."""
    jn, jp, pn, pp = openb_rows()
    jcfg, pcfg = (dataclasses.replace(
        c, report_per_event=True, deschedule_ratio=0.3,
        deschedule_policy=policy) for c in method_configs(ROWS["06-FGD"], 0))
    sims = []
    for sim in (JSimulator(jn, jcfg), PSimulator(pn, pcfg, device="cpu")):
        sim.set_workload_pods((jp if isinstance(sim, JSimulator) else pp)[:300])
        sim.run()
        sim.deschedule_cluster()
        sim.cluster_analysis("PostDeschedule")
        sim.finish()
        sims.append(sim)
    jsim, psim = sims
    assert _strip(psim.log.lines) == _strip(jsim.log.lines)
    jr, pr = jsim.last_result, psim.last_result
    np.testing.assert_array_equal(pr.placed_node, np.asarray(jr.placed_node))
    np.testing.assert_array_equal(pr.dev_mask, np.asarray(jr.dev_mask))
    np.testing.assert_array_equal(pr.creation_rank, jr.creation_rank)
    assert [(u.pod.name, u.reason) for u in pr.unscheduled_pods] == \
        [(u.pod.name, u.reason) for u in jr.unscheduled_pods]
    assert any("Num of Descheduled Pods" in line for line in psim.log.lines)


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                data = f.read()
            if name == "simon.log":
                data = b"".join(line for line in data.splitlines(True)
                                if b"[Engine]" not in line)
            out[os.path.relpath(path, d)] = data
    return out


@pytest.mark.parametrize("extra", [
    ["-r", "0.3", "-p", "fragMultiPod", "--workload-inflation-ratio", "1.1",
     "-y", "SNAP/pods", "-z", "SNAP/nodes"],
    ["-r", "0.3", "-p", "cosSim", "--analysis-from-log", "--emit-configs",
     "--is-involved-cpu-pods", "false", "--pod-popularity-threshold", "80",
     "--pod-increase-step", "2", "--gpu-res-weight", "0.5"],
    ["-r", "0.5", "-p", "fragOnePod", "--no-per-event-report",
     "--analysis-from-log"],
], ids=["multi-inflation-snapshots", "cossim-knobs-fromlog", "onepod-noreport"])
def test_cli_deschedule_flags_match_run_py(tmp_path, capsys, extra):
    """`python -m tpusim_torch --device cpu -d DIR` against
    experiments/run.py with the same flags on a 60-node, 200-pod cut:
    every file of the experiment directory (simon.log without [Engine],
    the CSVs, the md5-named configs) and the snapshots, byte for byte."""
    nodes, pods = _cut(tmp_path)
    outs = {}
    for who in ("port", "jax"):
        snap = str(tmp_path / f"snap-{who}")
        flags = [a.replace("SNAP", snap) for a in extra]
        common = ["-d", str(tmp_path / who), "-f", pods, "--node-trace",
                  nodes, "-FGD", "1000", "-gpusel", "FGDScore", "-tune",
                  "1.3", "-tuneseed", "42", "--shuffle-pod", "true", *flags]
        if who == "port":
            assert port_main(["--device", "cpu", *common]) == 0
        else:
            run_experiment(run_args(common))
        outs[who] = (_files(tmp_path / who), _files(snap))
    capsys.readouterr()
    assert outs["port"] == outs["jax"]
    assert "analysis.csv" in outs["port"][0]
    meta = outs["port"][0]["analysis.csv"].decode().splitlines()
    assert extra[3] in meta[1] and extra[1] in meta[1]


@pytest.mark.parametrize("flag,value", [("--engine", "table"),
                                        ("--engine", "sequential"),
                                        ("--mesh", "2")],
                         ids=["table", "sequential-runs", "mesh"])
def test_engine_and_mesh_flags_raise(tmp_path, capsys, flag, value):
    """--mesh above 1 raises NotImplementedError naming its ROADMAP item;
    auto, pallas and mesh 0 are accepted. --engine sequential and --engine
    table, which the port runs since its sequential and checkpoint slices,
    run the descheduling experiment on a 60-node, 200-pod cut and equal
    experiments/run.py's directory, byte for byte."""
    if value in ("sequential", "table"):
        nodes, pods = _cut(tmp_path)
        outs = {}
        for who in ("port", "jax"):
            common = ["-d", str(tmp_path / who), "-f", pods, "--node-trace",
                      nodes, "-FGD", "1000", "-gpusel", "FGDScore", "-tune",
                      "1.3", "-tuneseed", "42", "--shuffle-pod", "true",
                      "-r", "0.3", "-p", "fragOnePod", flag, value]
            if who == "port":
                assert port_main(["--device", "cpu", *common]) == 0
            else:
                run_experiment(run_args(common))
            outs[who] = _files(tmp_path / who)
        capsys.readouterr()
        assert outs["port"] == outs["jax"]
        assert "analysis.csv" in outs["port"]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        port_main(["--device", "cpu", "-d", str(tmp_path), flag, value])
    for ok in (["--engine", "pallas"], ["--mesh", "0"]):
        args = port_args(ok)
        assert (args.engine, args.mesh) in (("pallas", 0), ("auto", 0))


@pytest.mark.parametrize("policy", POLICIES)
def test_apply_deschedule_matches_jax(tmp_path, policy):
    """apply with a descheduleConfig (ratio 0.5, inflation 1.1, snapshot
    exports) on the example cluster: the standard output without [Engine]
    and every exported file, post_deschedule's included."""
    out = {}
    for who in ("port", "jax"):
        cr = tmp_path / f"cr-{who}.yaml"
        cr.write_text(
            "apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: d}\n"
            f"spec:\n  cluster: {{customConfig: {REPO}/example/test-cluster}}"
            "\n  customConfig:\n    shufflePod: true\n"
            "    workloadTuningConfig: {ratio: 1.3, seed: 42}\n"
            "    workloadInflationConfig: {ratio: 1.1, seed: 233}\n"
            f"    descheduleConfig: {{ratio: 0.5, policy: {policy}}}\n"
            "    exportConfig: {podSnapshotYamlFilePrefix: "
            f"{tmp_path}/snap-{who}/pod, nodeSnapshotCSVFilePrefix: "
            f"{tmp_path}/snap-{who}/node}}\n")
        out[who] = str(cr)
    port, jax = _apply_both(["-f", out["port"], "-s", SCHEDULERS["fgd"]],
                            ["-f", out["jax"], "-s", SCHEDULERS["fgd"]])
    assert port == jax
    assert "PostDeschedule" in port
    snaps = [_files(tmp_path / f"snap-{who}") for who in ("port", "jax")]
    assert snaps[0] == snaps[1]
    assert "pod_post_deschedule.yaml" in snaps[0]


# ---- the card's digests (full openb; slow) ----

def jax_desched_digests(tmp_path, policy, inflation):
    """The JAX package's digests of a chip_smoke.DESCHED_CASES case:
    experiments/run.py's run_experiment stages, keeping the Simulator."""
    from run import _build_sim, _post_run

    d = str(tmp_path / chip_smoke.desched_label(policy, inflation)
            .replace("+", "_"))
    args = run_args(chip_smoke.desched_argv(d, policy, inflation))
    sim, outdir, pod_csv, policies = _build_sim(args)
    sim.run()
    _post_run(sim, args, outdir, pod_csv, policies, 0.0)
    return dict(chip_smoke.result_digests(sim.last_result),
                report=chip_smoke.report_digest(d))


@pytest.mark.slow
@pytest.mark.parametrize("case", chip_smoke.DESCHED_CASES,
                         ids=lambda c: chip_smoke.desched_label(*c))
def test_desched_digests_pin_chip_smoke(tmp_path, capsys, case):
    """experiments/run.py's full-openb deschedule experiments have the
    digests chip_smoke.py holds the card's runs to."""
    got = jax_desched_digests(tmp_path, *case)
    capsys.readouterr()
    assert got == chip_smoke.DESCHED_SHA256[chip_smoke.desched_label(*case)]
