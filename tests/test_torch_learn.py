"""The port's tuning and imitation lane (tpusim_torch.learn: es, cma,
rollout, objective, loop, dataset; the `tune` and `imitate` CLIs) against
the JAX package's (tpusim.learn), on the CPU with the plain versions.

The optimizers' draws and updates, the projection, dedup and scalarized
objective are tpusim's; a tuning log of a learned family is byte-identical
to tpusim's, through a kill and resume too, and either package resumes a
log the other began; TeacherReplay's pairs, mined pairs and agreement equal
tpusim's (its plain version, the oracle's step functions, stands for the
`replay_forced` kernel here), and a wrong trace raises; the imitated theta
is tpusim's; the `tune`, `imitate` and `apply --policy` CLIs print what
tpusim's print and write the same files; `tune --url` raises naming
ROADMAP item 14.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

import tpusim.learn as jl
import tpusim_torch.learn as pl
from tests.test_torch_apply import _apply_both
from tests.test_torch_learned import THETA, _synth
from tests.test_torch_types_trace import NODE_CSV, POD_CSV, REPO
from tpusim.cli import main as jcli
from tpusim.io.trace import NodeRow as JNodeRow
from tpusim.io.trace import PodRow as JPodRow
from tpusim.io.trace import load_node_csv as jload_nodes
from tpusim.io.trace import load_pod_csv as jload_pods
from tpusim.obs import decisions as jdec
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim_torch.cli import main as pcli
from tpusim_torch.io.trace import NodeRow, PodRow
from tpusim_torch.io.trace import load_node_csv, load_pod_csv


def test_optimizers_match_tpusim():
    """centered_ranks, ES and CMA: the same candidates, updates and state
    under the same seeds."""
    rng = np.random.default_rng(0)
    scores = rng.normal(size=9)
    scores[3] = scores[5]
    assert np.array_equal(pl.centered_ranks(scores), jl.centered_ranks(scores))
    x0 = np.asarray(THETA, np.float64)
    for make in (lambda m: m.OpenAIES(x0, sigma=250.0, lr=300.0, popsize=8,
                                      seed=4),
                 lambda m: m.DiagonalCMA(x0, sigma=250.0, popsize=8, seed=4)):
        po, jo = make(pl), make(jl)
        for gen in range(3):
            a, b = po.ask(gen), jo.ask(gen)
            assert np.array_equal(a, b)
            s = -np.abs(a - 100).sum(1)
            po.tell(gen, s)
            jo.tell(gen, s)
            assert po.state_dict() == jo.state_dict()
        po.load_state(jo.state_dict())


def test_projection_dedup_and_objective_match_tpusim():
    xs = np.asarray([[10.5, -3.2, 4001.0], [11.5, -3.4, 12.0],
                     [10.5, -3.2, 4001.0]])
    assert np.array_equal(pl.project_weights(xs), jl.project_weights(xs))
    assert np.array_equal(pl.project_weights(xs, -4000, 4000),
                          jl.project_weights(xs, -4000, 4000))
    rows = pl.project_weights(xs, -4000, 4000)
    assert pl.dedup_rows(rows) == jl.dedup_rows(rows)
    terms = {"weights": [1], "seed": 42, "events": 10, "pods": 10,
             "placed": 9, "failed": 1, "unscheduled": 1, "disrupted": 2,
             "evicted": 0, "gpu_total_milli": 8000, "gpu_alloc_pct": 61.25,
             "frag_gpu_milli": 1234.5, "placements_sha256": "x"}
    for cfg in ((1.0, 1.0, 1.0, 0.0), (2.0, 0.5, 3.0, 1.5)):
        assert pl.scalarize(terms, pl.ObjectiveConfig(*cfg)) == \
            jl.scalarize(terms, jl.ObjectiveConfig(*cfg))
        assert pl.ObjectiveConfig(*cfg).canonical() == \
            jl.ObjectiveConfig(*cfg).canonical()
    assert pl.terms_from_result(terms) == jl.terms_from_result(terms)
    assert pl.project_theta([0.5, -0.25], 4000) == [4000, -2000]


@pytest.fixture(scope="module")
def openb_prefix():
    """160 openb pods: both packages' rows, the learned family."""
    return (jload_nodes(NODE_CSV), jload_pods(POD_CSV)[:160],
            load_node_csv(NODE_CSV), load_pod_csv(POD_CSV)[:160],
            jl.learned_policies(THETA))


TUNE = dict(algo="es", generations=2, popsize=4, sigma=300.0, lr=400.0,
            seed=1, w_lo=-4000, w_hi=4000)


def test_tune_log_matches_tpusim_and_resumes(openb_prefix, tmp_path):
    """A learned family's tuning log is tpusim's byte for byte; a run
    stopped after one generation and resumed ends with the same bytes; the
    port resumes a log tpusim began; one kernel library (or the plain
    versions) for the whole run."""
    jn, jp, pn, pp, pol = openb_prefix
    jlog, plog = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jl.run_tune(jl.LocalRollout(jl.make_family_sim(jn, jp, pol), width=4),
                pol, jl.TuneConfig(**TUNE), jlog)
    backend = pl.LocalRollout(pl.make_family_sim(pn, pp, pol, device="cpu"),
                              width=4)
    pl.run_tune(backend, pol, pl.TuneConfig(**{**TUNE, "generations": 1}),
                plog)
    res = pl.run_tune(backend, pol, pl.TuneConfig(**TUNE), plog, resume=True)
    assert backend.executables() == 1 and len(res.records) == 2
    with open(jlog, "rb") as a, open(plog, "rb") as b:
        assert a.read() == b.read()
    # a log tpusim began, the port continues
    jlog1 = str(tmp_path / "j1.jsonl")
    jl.run_tune(jl.LocalRollout(jl.make_family_sim(jn, jp, pol), width=4),
                pol, jl.TuneConfig(**{**TUNE, "generations": 1}), jlog1)
    pl.run_tune(backend, pol, pl.TuneConfig(**TUNE), jlog1, resume=True)
    with open(jlog, "rb") as a, open(jlog1, "rb") as b:
        assert a.read() == b.read()
    header, records = pl.read_log(plog)
    assert header["schema"] == pl.LOG_SCHEMA and len(records) == 2


# the teachers' gpuSelMethods, each with the policy it records: the
# selectors whose device pick a teacher-forced replay takes at the
# recorded node (replay_forced's pick warp: FGDScore's a lane per distinct
# device value, PWRScore's a lane per device, DotProductScore's a lane per
# slot), and best fit
TEACHERS = {"FGDScore": "FGDScore", "PWRScore": "PWRScore",
            "DotProductScore": "DotProductScore", "best": "BestFitScore"}
# two pods past the synthetic ones: one that no node fits (a create with
# no feasible node, recorded node -1), one that fits only the two 8-GPU
# nodes (a recorded top-3 entry of -1)
EDGE_PODS = [("px0001", 64000, 2048, 0, 0), ("px0002", 1000, 2048, 8, 1000)]


@pytest.fixture(scope="module", params=list(TEACHERS))
def teacher(request, tmp_path_factory):
    """tpusim's recorded teacher (gpuSelMethod the param) on the synthetic
    cluster and EDGE_PODS, its prepared pods, and TeacherReplay of each
    package over it."""
    gpu_sel, policy = request.param, TEACHERS[request.param]
    nodes, pods = _synth()
    jn = [JNodeRow(*r) for r in nodes]
    sim = JSimulator(jn, JConfig(
        policies=((policy, 1000),), gpu_sel_method=gpu_sel, seed=42,
        report_per_event=False, record_decisions=True))
    sim.set_workload_pods([JPodRow(*r) for r in pods + EDGE_PODS])
    res = sim.run()
    path = str(tmp_path_factory.mktemp("teach") / "teacher.jsonl")
    jdec.write_decisions(path, res.decisions, policies=[(policy, 1000)],
                         meta=sim._telemetry_meta(),
                         pod_names=[p.name for p in res.pods])
    prep = sim.prepare_pods()
    jh, jrows = jl.load_teacher_log(path)
    ph, prows = pl.load_teacher_log(path)
    pprep = [PodRow(**{f: getattr(p, f) for f in p.__dataclass_fields__})
             for p in prep]
    pn = [NodeRow(*r) for r in nodes]
    return (jl.TeacherReplay(jn, prep, jh, jrows),
            pl.TeacherReplay(pn, pprep, ph, prows, device="cpu"),
            pn, pprep, ph, prows)


def test_teacher_replay_matches_tpusim(teacher):
    jr, pr = teacher[:2]
    assert pr.gpu_sel == jr.gpu_sel
    # the log holds a create with no feasible node and a top-3 entry of -1
    assert (jr.rec_node < 0).any() and (np.asarray(jr.rec_feas) == 0).any()
    assert (np.asarray(jr.topk)[jr.rec_node >= 0] < 0).any()
    a, b = jr.pairs(), pr.pairs()
    for f in ("pos", "neg", "event", "tie"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.features == b.features
    for theta in (THETA, [1000] + [0] * 9, [0, 5, -3, 0, 40, 2, 0, 9, -1, 4]):
        assert jr.agreement(theta) == pr.agreement(theta)
        assert jr.agreement(theta, start_event=20) == \
            pr.agreement(theta, start_event=20)
        ma, mb = jr.mined_pairs(theta), pr.mined_pairs(theta)
        assert np.array_equal(ma.pos, mb.pos)
        assert np.array_equal(ma.neg, mb.neg)


def test_teacher_replay_rejects_wrong_trace(teacher):
    _, _, pn, prep, header, rows = teacher
    with pytest.raises(ValueError, match="wrong trace or prep"):
        pl.TeacherReplay(pn, prep[:-3], header, rows, device="cpu")
    _, other = _synth(seed=99)
    rep = pl.TeacherReplay(pn, [PodRow(*r) for r in other + EDGE_PODS],
                           header, rows, device="cpu")
    with pytest.raises(ValueError, match="feasible count"):
        rep.pairs()


def test_imitation_matches_tpusim(teacher):
    jr, pr = teacher[:2]
    cut = len(jr.ev_kind) - len(jr.ev_kind) // 5
    cfg = dict(steps=600, lr=0.3, l2=1e-6)
    jt = jl.imitate_with_mining(jr, jl.ImitateConfig(**cfg), end_event=cut,
                                rounds=4)
    pt = pl.imitate_with_mining(pr, pl.ImitateConfig(**cfg), end_event=cut,
                                rounds=4)
    assert pt[1] == jt[1] and pt[2] == jt[2]
    assert np.array_equal(pt[0], jt[0])


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_tune_cli_matches_tpusim(tmp_path):
    """`tune --policy learned` on 100 openb pods: the same standard output
    (the log path aside), the same log and artifact bytes."""
    outs = []
    for tag, main, extra in (("j", jcli, []),
                             ("p", pcli, ["--device", "cpu"])):
        log, best = str(tmp_path / f"{tag}.jsonl"), str(tmp_path / f"{tag}.a")
        rc, out, _ = _cli(main, [
            "tune", "--nodes", NODE_CSV, "--pods", POD_CSV, "--max-pods",
            "100", "--policy", "learned", "--generations", "2", "--popsize",
            "4", "--seed", "5", "--log", log, "--best-out", best, *extra])
        assert rc == 0
        with open(log, "rb") as f, open(best, "rb") as g:
            outs.append((out.replace(log, "LOG"), f.read(), g.read()))
    assert outs[0] == outs[1]
    with pytest.raises(NotImplementedError, match="item 14"):
        pcli(["tune", "--nodes", NODE_CSV, "--pods", POD_CSV, "--url",
              "http://127.0.0.1:9", "--device", "cpu"])


def _write_synth_csvs(root):
    """The synthetic cluster and pods as node and pod CSVs."""
    nodes, pods = _synth()
    node_csv, pod_csv = os.path.join(root, "n.csv"), os.path.join(root, "p.csv")
    with open(node_csv, "w") as f:
        f.write("sn,cpu_milli,memory_mib,gpu,model\n")
        for r in nodes:
            f.write(",".join(str(x) for x in r) + "\n")
    with open(pod_csv, "w") as f:
        f.write("name,cpu_milli,memory_mib,num_gpu,gpu_milli,gpu_spec,qos,"
                "pod_phase,creation_time,deletion_time,scheduled_time\n")
        for i, r in enumerate(pods):
            f.write(",".join(str(x) for x in r)
                    + f",,LS,Running,{i},0,{i}\n")
    return node_csv, pod_csv


def test_imitate_and_apply_policy_clis_match_tpusim(tmp_path):
    """`imitate` over a teacher log `apply --decisions-out` recorded (the
    synthetic trace as CSVs): the same standard output and artifact; then
    `apply --policy LearnedScore:FILE.json` with a gpuSelMethod the
    override removes: the same standard output (the [Engine] lines aside)
    and the [policy] reset on standard error."""
    node_csv, pod_csv = _write_synth_csvs(str(tmp_path))
    nodes = jload_nodes(node_csv)
    pods = jload_pods(pod_csv)
    sim = JSimulator(nodes, JConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore", seed=42,
        report_per_event=False, record_decisions=True))
    sim.set_workload_pods(pods)
    res = sim.run()
    log = str(tmp_path / "teacher.jsonl")
    jdec.write_decisions(log, res.decisions, policies=[("FGDScore", 1000)],
                         meta=sim._telemetry_meta(),
                         pod_names=[p.name for p in res.pods])
    outs = []
    for tag, main, extra in (("j", jcli, []),
                             ("p", pcli, ["--device", "cpu"])):
        art = str(tmp_path / f"{tag}.json")
        rc, out, _ = _cli(main, ["imitate", "--nodes", node_csv, "--pods",
                                 pod_csv, "--decisions", log, "--steps",
                                 "300", "--out", art, *extra])
        assert rc == 0
        with open(art, "rb") as f:
            outs.append((out, f.read()))
    assert outs[0] == outs[1]
    cr = os.path.join(REPO, "example", "test-cluster-config.yaml")
    sched = os.path.join(REPO, "example", "test-scheduler-config.yaml")
    with open(sched) as f:  # its gpuSelMethod delegates to FGDScore
        assert re.search(r"gpuSelMethod: FGDScore", f.read())
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        port, jax = _apply_both([
            "-f", cr, "-s", sched, "--base-dir", REPO, "--policy",
            f"LearnedScore:{tmp_path / 'p.json'}"])
    assert port == jax and "Cluster Analysis" in port
    resets = [line for line in err.getvalue().splitlines()
              if line.startswith("[policy]")]
    assert len(resets) == 2 and resets[0] == resets[1]
