"""Seed batches and config sweeps of the port against the JAX package, at
tolerance 0: schedule_pods_sweep / run_sweep (a zero-weight row, a
duplicated row, per-lane seeds, RandomScore first), the randomized
families, schedule_pods_sweep_multi with per-lane tunes, run_batch with
reports on (each lane's log and CSVs against tpusim's batch and the port's
own standalone run), format_sweep_table, `apply --sweep-weights`' standard
output, the *_experiment_batch entries, the plain lanes replays against
the per-lane plain replays, and the refusals. On the CPU every lanes
replay is its plain version (the lanes kernels' card tests are in
tests/test_torch_cuda.py). Slow-marked: `python -m tpusim_torch.sweep`
against experiments/sweep.py on openb, and the seed digests chip_smoke.py
holds the card's seed batch to."""

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_apply import _apply_both
from tests.test_torch_driver import ROWS, method_configs
from tests.test_torch_report import _cut
from tests.test_torch_types_trace import REPO, openb_rows, paper_configs
from tpusim.sim import driver as jd
from tpusim_torch import experiment as pexp
from tpusim_torch import sweep as psweep
from tpusim_torch.io.trace import load_node_csv, load_pod_csv
from tpusim_torch.sim import driver as pd
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he
from tpusim_torch.parallel.sharding import pad_nodes

sys.path.insert(0, os.path.join(REPO, "experiments"))
import run as jrun  # noqa: E402
from analysis import analyze_sim as janalyze_sim  # noqa: E402

FGD_BESTFIT = (("FGDScore", 1000), ("BestFitScore", 500))
# a zero-weight row, a duplicated row and per-lane seeds
GRID = [[1000, 500], [100, 2000], [0, 1000], [1000, 500]]
GRID_SEEDS = [42, 43, 44, 42]


def _no_engine(lines):
    return [line for line in lines if "[Engine]" not in line]


def _configs(policies=FGD_BESTFIT, gpu_sel="FGDScore", dim_ext="share",
             tune=0.0, report=True):
    jcfg, pcfg = paper_configs(tune=tune)
    method = dict(policies=tuple(policies), gpu_sel_method=gpu_sel,
                  dim_ext_method=dim_ext, report_per_event=report)
    return (dataclasses.replace(jcfg, **method),
            dataclasses.replace(pcfg, **method))


def _sims(configs, num_pods, num_nodes=None):
    jn, jp, pn, pp = openb_rows()
    jn, pn = jn[:num_nodes], pn[:num_nodes]
    jsim = jd.Simulator(jn, configs[0])
    jsim.set_workload_pods(jp[:num_pods])
    psim = pd.Simulator(pn, configs[1], device="cpu")
    psim.set_workload_pods(pp[:num_pods])
    return jsim, psim


def _assert_lanes_equal(got, want):
    """The port's SweepLanes against tpusim's, field by field."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for name in ("placed_node", "dev_mask", "ever_failed", "weights"):
            x, y = getattr(a, name), np.asarray(getattr(b, name))
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        for x, y in zip(a.state, b.state):
            assert np.array_equal(x.numpy(), np.asarray(y))
        for name in ("seed", "events", "placed", "failed", "unscheduled",
                     "gpu_alloc_pct", "frag_gpu_milli"):
            assert getattr(a, name) == getattr(b, name), name
        assert a.counters is None and a.disruption is None
        assert (a.metrics is None) == (b.metrics is None)
        if b.metrics is not None:
            for name in b.metrics._fields:
                assert np.array_equal(getattr(a.metrics, name).numpy(),
                                      np.asarray(getattr(b.metrics, name)))


@pytest.mark.parametrize("policies,grid,seeds", [
    (FGD_BESTFIT, GRID, GRID_SEEDS),
    # RandomScore first: make_config moves it last, each row with it
    ((("RandomScore", 500), ("FGDScore", 500)),
     [[1000, 0], [0, 1000], [300, 700]], [5, 6, 7]),
], ids=["fgd-bestfit", "random-first"])
def test_run_sweep_matches_jax(policies, grid, seeds):
    """run_sweep on the first 256 openb pods, reports on: every lane and
    the sweep table equal tpusim's; the duplicated row's lane equals the
    first's."""
    jsim, psim = _sims(_configs(policies), 256)
    want = jsim.run_sweep(grid, seeds=seeds)
    got = psim.run_sweep(grid, seeds=seeds)
    _assert_lanes_equal(got, want)
    assert pd.format_sweep_table(got, policies) == \
        jd.format_sweep_table(want, policies)
    assert _no_engine(psim.log.lines) == _no_engine(jsim.log.lines)
    assert psim.last_engine == "plain_replay_lanes"
    if grid[3:]:
        assert np.array_equal(got[0].placed_node, got[3].placed_node)


@pytest.mark.parametrize("policies,gpu_sel,dim_ext", [
    ((("RandomScore", 1000),), "random", "merge"),
    ((("FGDScore", 1000),), "random", "share"),
], ids=["01-Random", "fgd-gpusel-random"])
def test_randomized_sweep_matches_jax(policies, gpu_sel, dim_ext):
    """The randomized families (each lane draws from its seed's key
    chain) through schedule_pods_sweep, report off, against tpusim."""
    jsim, psim = _sims(_configs(policies, gpu_sel, dim_ext, report=False),
                       200)
    grid, seeds = [[1000], [1000], [250]], [42, 43, 44]
    jsim.set_typical_pods()
    psim.set_typical_pods()
    want = jd.schedule_pods_sweep(jsim, jsim.prepare_pods(), grid, seeds)
    got = pd.schedule_pods_sweep(psim, psim.prepare_pods(), grid, seeds)
    _assert_lanes_equal(got, want)


def test_sweep_multi_with_tunes_matches_jax():
    """run_sweep(tunes=...) through schedule_pods_sweep_multi on a 40-node
    cut: each lane's own tuned trace, the union of the lanes' pod types."""
    jsim, psim = _sims(_configs(tune=1.3, report=False), 200, num_nodes=40)
    grid = [[1000, 500], [100, 2000], [700, 700]]
    kw = dict(seeds=[42, 43, 44], tunes=[1.1, 1.3, 1.5])
    want = jsim.run_sweep(grid, **kw)
    got = psim.run_sweep(grid, **kw)
    _assert_lanes_equal(got, want)
    assert len({lane.events for lane in got}) == 3


def _batch_sims(package, nodes, pods, seeds, cfg):
    sims = []
    for seed in seeds:
        sim = package.Simulator(nodes, dataclasses.replace(
            cfg, tuning_seed=seed, seed=seed), **(
            {"device": "cpu"} if package is pd else {}))
        sim.set_workload_pods(pods)
        sims.append(sim)
    return sims


def _meta(seed):
    return {"workload": "cut", "policy": "FGD1000", "tune": 1.3,
            "tune_seed": seed, "de": "share", "gs": "FGDScore", "dr": 0.0,
            "dp": ""}


def test_run_batch_matches_jax_and_standalone(tmp_path):
    """run_batch over three seeds with reports on, on a 60-node, 200-pod
    cut at tune 1.3: each lane's simon.log (but its [Engine] line) and CSVs
    byte-identical to tpusim's run_batch and to the port's standalone
    run()."""
    nodes_csv, pods_csv = _cut(tmp_path)
    jcfg, pcfg = _configs((("FGDScore", 1000),), tune=1.3)
    from tpusim.io.trace import load_node_csv as jload_nodes
    from tpusim.io.trace import load_pod_csv as jload_pods

    seeds = (42, 43, 44)
    jsims = _batch_sims(jd, jload_nodes(nodes_csv), jload_pods(pods_csv),
                        seeds, jcfg)
    psims = _batch_sims(pd, load_node_csv(nodes_csv), load_pod_csv(pods_csv),
                        seeds, pcfg)
    jd.run_batch(jsims)
    results = pd.run_batch(psims)
    from tpusim_torch.analysis import analyze_sim

    for seed, jsim, psim, res in zip(seeds, jsims, psims, results):
        alone = pd.Simulator(psim.nodes, psim.cfg, device="cpu")
        alone.set_workload_pods(psim.workload_pods)
        want = alone.run()
        assert np.array_equal(res.placed_node, want.placed_node)
        assert np.array_equal(res.dev_mask, want.dev_mask)
        for sim in (jsim, psim, alone):
            sim.finish()
        assert _no_engine(psim.log.lines) == _no_engine(jsim.log.lines)
        assert _no_engine(psim.log.lines) == _no_engine(alone.log.lines)
        dirs = {}
        for label, sim, analyze in (("jax", jsim, janalyze_sim),
                                    ("port", psim, analyze_sim),
                                    ("alone", alone, analyze_sim)):
            d = tmp_path / f"{label}{seed}"
            d.mkdir()
            analyze(sim, str(d), _meta(seed))
            dirs[label] = chip_smoke.report_digests(str(d))
        dirs = {k: {f: v for f, v in d.items() if f != "simon.log"}
                for k, d in dirs.items()}
        assert dirs["port"] == dirs["jax"] == dirs["alone"]


def test_format_sweep_table_matches_jax():
    """The table of hand-made lanes, fields at their printing edges."""
    def lanes(package):
        return [package.SweepLane(
            weights=np.asarray(w, np.int32), seed=s, placed_node=None,
            dev_mask=None, ever_failed=None, counters=None, metrics=None,
            state=None, events=10, placed=p, failed=f, gpu_alloc_pct=a,
            frag_gpu_milli=g)
            for w, s, p, f, a, g in (([1000, 0], 42, 9, 1, 99.995, 1234.5),
                                     ([-5, 2**31 - 1], 7, 0, 0, 0.0, 0.0))]
    names = (("FGDScore", 1), ("BestFitScore", 1))
    assert pd.format_sweep_table(lanes(pd), names) == \
        jd.format_sweep_table(lanes(jd), names)


@pytest.mark.parametrize("sched", ["fgd", "default"])
def test_apply_sweep_weights_matches_jax(tmp_path, sched):
    """`apply --sweep-weights` on the example cluster: the standard output
    but its [Engine] and [Sweep] lines equals `python -m tpusim apply`'s;
    without -s the built-in six-policy profile, RandomScore third, with
    per-row seeds."""
    argv = ["-f", os.path.join(REPO, "example/test-cluster-config.yaml")]
    if sched == "fgd":
        argv += ["-s", os.path.join(REPO, "example/test-scheduler-config.yaml")]
        payload = [[1000], [10], [0]]
    else:
        payload = {"weights": [[1, 1, 1, 1, 1, 1], [0, 5, 1, 0, 2, 1],
                               [3, 0, 0, 1, 1, 0]], "seeds": [42, 1, 2]}
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps(payload))
    port, jax = _apply_both([*argv, "--sweep-weights", str(grid)])
    assert "cfg weights(" in port

    def strip(text):
        return [line for line in text.splitlines()
                if not line.startswith("[Sweep]")]

    assert strip(port) == strip(jax)


def test_experiment_batch_matches_run_py(tmp_path, capsys):
    """tpusim_torch.experiment's batch entries against experiments/run.py's
    on a 256-pod trace: each experiment's simon.log (but its [Engine]
    line) and CSVs byte for byte, and run_experiment_batch equal to the
    port's run_experiment."""
    pods = tmp_path / "trace256.csv"
    with open(os.path.join(REPO, "data/csv/openb_pod_list_default.csv")) as f:
        pods.write_text("".join(next(f) for _ in range(257)))

    def argv(root, seed):
        return ["-d", str(tmp_path / root / str(seed)), "-f", str(pods),
                "-FGD", "1000", "-gpusel", "FGDScore", "-tuneseed",
                str(seed), "--shuffle-pod", "true"]

    seeds = (42, 43)
    jrun.run_experiment_batch([jrun.get_args(argv("jax", s)) for s in seeds])
    st = pexp.dispatch_experiment_batch(
        [pexp.get_args(argv("port", s) + ["--device", "cpu"]) for s in seeds])
    pexp.finish_experiment_batch(st)
    pexp.run_experiment(pexp.get_args(argv("alone", 42) + ["--device",
                                                            "cpu"]))
    for seed in seeds:
        got = chip_smoke.report_digests(str(tmp_path / "port" / str(seed)))
        assert got == chip_smoke.report_digests(
            str(tmp_path / "jax" / str(seed)))
    assert chip_smoke.report_digests(str(tmp_path / "alone" / "42")) == \
        chip_smoke.report_digests(str(tmp_path / "port" / "42"))


@pytest.mark.parametrize("blocked", [False, True], ids=["flat", "blocked"])
def test_plain_lanes_equal_per_lane_plain_replays(blocked):
    """plain_replay_lanes and plain_replay_blocked_lanes against the plain
    single replays of each lane: its own rank, weights and key, the shared
    tables left unchanged."""
    cfg = fe.make_config(list(FGD_BESTFIT), "FGDScore")
    state, pods, types, evk, evp, tp, rank = chip_smoke.random_case(
        11, 200, 120, "cpu")
    if blocked:
        state, rank = pad_nodes(state, rank, 128)
    tables = fe.plain_init_tables(state, types, tp, cfg)
    saved = tuple(t.clone() for t in tables)
    gen = torch.Generator().manual_seed(3)
    lanes = [fe.Lane(pods, types.type_id, evk, evp,
                     rank[torch.randperm(state.num_nodes, generator=gen)],
                     fe.lane_weights(cfg, row)) for row in GRID[:3]]
    lanes_fn = he.replay_blocked_lanes if blocked else fe.replay_lanes
    single = he.plain_replay_blocked if blocked else fe.plain_replay
    got = lanes_fn(state, types, tp, tables, cfg, lanes)
    for lane, out in zip(lanes, got):
        want = single(state, pods, types, evk, evp, tp, lane.rank, tables,
                      cfg._replace(weights=lane.weights))
        assert chip_smoke.max_abs_err(out, want) == 0
    assert all(torch.equal(a, b) for a, b in zip(tables, saved))


def test_lane_weights_follow_the_config_order():
    """A row in the given policy order lands in make_config's order."""
    cfg = fe.make_config([("RandomScore", 1), ("FGDScore", 2),
                          ("BestFitScore", 3)], "best")
    assert [p.name for p in cfg.policies] == ["FGDScore", "BestFitScore",
                                              "RandomScore"]
    assert fe.lane_weights(cfg, [10, 20, 30]) == (20, 30, 10)
    with pytest.raises(ValueError, match="weight row"):
        fe.lane_weights(cfg, [1, 2])


def test_refusals():
    """A batch of mixed configurations, a chaos sweep with a bad fault
    spec or spec count, and a bad grid raise before anything runs."""
    _, psim = _sims(_configs(), 50)
    other = pd.Simulator(psim.nodes, dataclasses.replace(
        psim.cfg, policies=(("FGDScore", 1000),)), device="cpu")
    other.set_workload_pods(psim.workload_pods)
    with pytest.raises(ValueError, match="same-config"):
        pd.run_batch([psim, other])
    with pytest.raises(ValueError, match="each fault lane must be"):
        psim.run_sweep([[1, 1]], faults=[None])
    with pytest.raises(ValueError, match="fault_specs has 2 entries"):
        pd.schedule_pods_sweep_multi(psim, [[]], [[1, 1]],
                                     fault_specs=[None, None])
    with pytest.raises(ValueError, match=r"\[B, 2\] matrix"):
        pd.schedule_pods_sweep(psim, [], [[1, 2, 3]])
    with pytest.raises(ValueError, match="seeds has 1 entries"):
        pd.schedule_pods_sweep(psim, [], [[1, 2], [3, 4]], seeds=[1])


def _digest(a, dtype):
    return hashlib.sha256(np.ascontiguousarray(a, dtype).tobytes()).hexdigest()


@pytest.mark.slow
@pytest.mark.parametrize("seed", sorted(chip_smoke.SEED_SHA256))
def test_seed_digests_pin_chip_smoke(seed):
    """The JAX package's full-openb 06-FGD run under tuning seed and seed
    43-45 has the digests chip_smoke.py holds the card's seed batch to."""
    jn, jp, _, _ = openb_rows()
    cfg = dataclasses.replace(method_configs(ROWS["06-FGD"])[0],
                              tuning_seed=seed, seed=seed)
    jsim = jd.Simulator(jn, cfg)
    jsim.set_workload_pods(jp)
    res = jsim.run()
    assert (_digest(np.asarray(res.placed_node), np.int32),
            _digest(np.asarray(res.dev_mask), np.uint8)) == \
        chip_smoke.SEED_SHA256[seed]


@pytest.mark.slow
def test_sweep_cli_matches_experiments_sweep(tmp_path, capsys):
    """`python -m tpusim_torch.sweep --methods 06-FGD --seeds 2` against
    experiments/sweep.py on openb: byte-identical directories (simon.log
    but its [Engine] line, the CSVs, the resume markers)."""
    import sweep as jsweep

    flags = ["--traces", "openb_pod_list_default", "--methods", "06-FGD",
             "--seeds", "2"]
    jsweep.main(["--out-root", str(tmp_path / "jax"), *flags])
    psweep.main(["--out-root", str(tmp_path / "port"), *flags,
                 "--device", "cpu"])
    for seed in (42, 43):
        rel = f"openb_pod_list_default/06-FGD/1.3/{seed}"
        got, want = (chip_smoke.report_digests(str(tmp_path / k / rel))
                     for k in ("port", "jax"))
        assert got == want
        # the markers hold the experiments' flags, their -d under each root
        assert (tmp_path / "port" / rel / ".sweep_done").read_text() \
            .replace(str(tmp_path / "port"), str(tmp_path / "jax")) == \
            (tmp_path / "jax" / rel / ".sweep_done").read_text()


@pytest.mark.slow
def test_sweep_cli_digest_pins_chip_smoke(tmp_path, capsys, monkeypatch):
    """experiments/run.py's 06-FGD experiment as experiments/sweep.py runs
    it (seed 42) has the digest chip_smoke.py holds the card's
    `python -m tpusim_torch.sweep` directory to."""
    monkeypatch.setenv("TPUSIM_BELLMAN_CACHE", "")
    method = dict((m[0], m) for m in psweep.METHODS)["06-FGD"]
    argv = psweep.experiment_argv(str(tmp_path), "openb_pod_list_default",
                                  method, 1.3, 42, False, "cpu")[1]
    jrun.run_experiment(jrun.get_args(argv))
    assert chip_smoke.report_digest(str(tmp_path / "openb_pod_list_default"
                                        / "06-FGD" / "1.3" / "42")) == \
        chip_smoke.SWEEP_CLI_SHA256
