"""The report half of the main path against the JAX package, at tolerance
0: the metrics post-pass field by field, the whole simon.log (but its
[Engine] line) and every analysis CSV of Simulator.run() and analyze_sim
on a 256-event openb prefix under three method rows with per-event reports
on, `python -m tpusim_torch -d` against experiments/run.py on a 60-node,
200-pod cut, and, slow-marked, the full openb experiment and the digests
chip_smoke.py holds the card to."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_driver import ROWS, method_configs
from tests.test_torch_types_trace import (
    REPO,
    openb_rows,
    port_specs,
    port_state,
    port_typical,
)
from tpusim.io.trace import build_events as jbuild_events
from tpusim.io.trace import pods_to_specs as jpods_to_specs
from tpusim.sim import metrics as jmetrics
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.types import TypicalPods as JTypicalPods
from tpusim_torch.__main__ import main as cli_main
from tpusim_torch.analysis import analyze_sim
from tpusim_torch.sim.driver import Simulator as PSimulator
from tpusim_torch.sim.metrics import compute_event_metrics

sys.path.insert(0, os.path.join(REPO, "experiments"))
from analysis import analyze_sim as janalyze_sim  # noqa: E402
from run import get_args as run_args  # noqa: E402
from run import run_experiment  # noqa: E402

PREFIX_ROWS = ["06-FGD", "05-BestFit", "08-PWR_500_FGD_500"]


def _configs(row, tune):
    jcfg, pcfg = method_configs(ROWS[row], tune)
    return (dataclasses.replace(jcfg, report_per_event=True),
            dataclasses.replace(pcfg, report_per_event=True))


def _jax_replay(row, num_pods, tune=0.0):
    """The JAX Simulator of a row on an openb prefix, with its prepared
    specs, events and the replay's telemetry."""
    jn, jp, _, _ = openb_rows()
    jsim = JSimulator(jn, _configs(row, tune)[0])
    jsim.set_workload_pods(jp[:num_pods])
    jsim.set_typical_pods()
    pods = jsim.prepare_pods()
    specs = jpods_to_specs(pods, jsim.node_index)
    ek, ep = jbuild_events(pods)
    out = jsim.run_events(jsim.init_state, specs, jnp.asarray(ek),
                          jnp.asarray(ep), jax.random.PRNGKey(42))
    return jsim, specs, ek, ep, out


def _assert_metrics_equal(got, want):
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("row", PREFIX_ROWS)
def test_postpass_matches_jax_on_openb_prefix(row):
    """compute_event_metrics on the telemetry of the first 256 openb pods'
    replay (T=32 typical pods), bit-equal field by field."""
    jsim, specs, ek, ep, out = _jax_replay(row, 256)
    want = jmetrics.compute_event_metrics(
        jsim.init_state, specs, jnp.asarray(ek), jnp.asarray(ep),
        out.event_node, out.event_dev, jsim.typical)
    got = compute_event_metrics(
        port_state(jsim.init_state), port_specs(specs), torch.as_tensor(ek),
        torch.as_tensor(ep), torch.as_tensor(np.asarray(out.event_node)),
        torch.as_tensor(np.asarray(out.event_dev)),
        port_typical(jsim.typical))
    _assert_metrics_equal(got, want)


@pytest.mark.parametrize("t", [16, 48, 80])
def test_postpass_matches_jax_across_typical_sizes(t):
    """The same telemetry (600 openb pods under 06-FGD) reported against
    seeded typical-pod distributions of 16, 48 and 80 rows: one window of
    the sum over typical pods, two, and three."""
    jsim, specs, ek, ep, out = _jax_replay("06-FGD", 600)
    rng = np.random.default_rng(t)
    milli = rng.choice([0, 100, 250, 500, 1000], t)
    num = np.where(milli == 1000, rng.integers(1, 9, t), (milli > 0) * 1)
    freq = rng.random(t).astype(np.float32)
    freq[t - 5:] = 0
    freq /= freq.sum()
    cols = (rng.integers(0, 64000, t), milli, num,
            rng.choice([0, 0, 1 << 4, (1 << 7) | (1 << 8)], t))
    jtp = JTypicalPods(*(jnp.asarray(c, jnp.int32) for c in cols),
                       jnp.asarray(freq))
    want = jmetrics.compute_event_metrics(
        jsim.init_state, specs, jnp.asarray(ek), jnp.asarray(ep),
        out.event_node, out.event_dev, jtp)
    got = compute_event_metrics(
        port_state(jsim.init_state), port_specs(specs), torch.as_tensor(ek),
        torch.as_tensor(ep), torch.as_tensor(np.asarray(out.event_node)),
        torch.as_tensor(np.asarray(out.event_dev)), port_typical(jtp))
    _assert_metrics_equal(got, want)


def _experiment_files(sim, d, meta, analyze):
    os.makedirs(d, exist_ok=True)
    sim.finish()
    with open(os.path.join(d, "simon.log"), "w") as f:
        f.write(sim.log.dump())
    analyze(sim, str(d), meta)
    out = {}
    for name in chip_smoke.REPORT_FILES:
        path = os.path.join(d, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    out["simon.log"] = b"".join(
        line for line in out["simon.log"].splitlines(keepends=True)
        if b"[Engine]" not in line)
    return out


@pytest.mark.parametrize("row", PREFIX_ROWS)
def test_run_report_files_match_jax_on_openb_prefix(tmp_path, row):
    """Simulator.run(), finish() and analyze_sim on the first 256 openb
    pods, shuffled and tuned to 1.3 (a few hundred events, some of them
    failed creates), per-event reports on: simon.log without its [Engine]
    line and all six analysis CSVs, byte for byte."""
    jn, jp, pn, pp = openb_rows()
    jcfg, pcfg = _configs(row, 1.3)
    mid, policies, gpu_sel, dim_ext = ROWS[row][:4]
    meta = chip_smoke.row_meta(policies, gpu_sel, dim_ext)
    jsim = JSimulator(jn, jcfg)
    jsim.set_workload_pods(jp[:256])
    jsim.run()
    psim = PSimulator(pn, pcfg, device="cpu")
    psim.set_workload_pods(pp[:256])
    pres = psim.run()
    assert pres.events > 256 and pres.unscheduled_pods
    want = _experiment_files(jsim, tmp_path / "jax", meta, janalyze_sim)
    got = _experiment_files(psim, tmp_path / "port", meta, analyze_sim)
    assert set(got) == set(chip_smoke.REPORT_FILES)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    assert got["simon.log"].count(b"(bellman)") == pres.events


def test_reports_off_emit_no_event_lines():
    """report_per_event=False: no post-pass, no per-event lines, and the
    per-event CSVs stay empty."""
    _, _, pn, pp = openb_rows()
    cfg = dataclasses.replace(_configs("06-FGD", 0.0)[1],
                              report_per_event=False)
    psim = PSimulator(pn, cfg, device="cpu")
    psim.set_workload_pods(pp[:64])
    psim.run()
    assert not any("[Report]" in line or "attempt to" in line
                   for line in psim.log.lines)
    assert psim.event_reports == []


def test_rerun_resets_the_report_stashes():
    """A second run() of one Simulator reports that run alone."""
    _, _, pn, pp = openb_rows()
    psim = PSimulator(pn, _configs("06-FGD", 0.0)[1], device="cpu")
    psim.set_workload_pods(pp[:40])
    psim.run()
    first = list(psim.log.lines)
    psim.run()
    assert psim.log.lines == first
    assert len(psim.event_reports) == 1 and len(psim.failed_pod_lists) == 1


def _cut(tmp_path):
    paths = []
    for name, rows in (("nodes", 61), ("pods", 201)):
        src = os.path.join(REPO, "data/csv", {
            "nodes": "openb_node_list_gpu_node.csv",
            "pods": "openb_pod_list_default.csv"}[name])
        with open(src) as f:
            lines = [next(f) for _ in range(rows)]
        (tmp_path / f"{name}.csv").write_text("".join(lines))
        paths.append(str(tmp_path / f"{name}.csv"))
    return paths


@pytest.mark.parametrize("flags", [
    ["-FGD", "1000", "-gpusel", "FGDScore"],
    ["-PWR", "500", "-FGD", "500", "-gpusel", "FGDScore"],
])
def test_cli_experiment_dir_matches_run_py(tmp_path, capsys, flags):
    """`python -m tpusim_torch --device cpu -d DIR` against
    experiments/run.py with the same flags on a 60-node, 200-pod cut:
    simon.log (without [Engine]) and the CSVs byte for byte."""
    nodes, pods = _cut(tmp_path)
    common = ["-f", pods, "--node-trace", nodes, "-tune", "1.3",
              "-tuneseed", "42", "--shuffle-pod", "true", *flags]
    assert cli_main(["--device", "cpu", "-d", str(tmp_path / "port"),
                     *common]) == 0
    run_experiment(run_args(["-d", str(tmp_path / "jax"), *common]))
    capsys.readouterr()
    want = chip_smoke.report_digests(tmp_path / "jax")
    assert want["analysis_frag.csv"] != "absent"
    assert chip_smoke.report_digests(tmp_path / "port") == want


@pytest.mark.slow
def test_full_openb_experiment_matches_run_py(tmp_path, capsys):
    """The paper's experiment end to end on the CPU: `python -m
    tpusim_torch -d` and experiments/run.py on the full openb default trace
    under FGD (tune 1.3, seed 42): every file byte for byte."""
    common = ["-f", "openb_pod_list_default", "-FGD", "1000", "-gpusel",
              "FGDScore", "-tune", "1.3", "-tuneseed", "42",
              "--shuffle-pod", "true"]
    assert cli_main(["--device", "cpu", "-d", str(tmp_path / "port"),
                     *common]) == 0
    run_experiment(run_args(["-d", str(tmp_path / "jax"), *common]))
    capsys.readouterr()
    assert chip_smoke.report_digests(tmp_path / "port") == \
        chip_smoke.report_digests(tmp_path / "jax")


@pytest.mark.slow
@pytest.mark.parametrize("row", [row[0] for row in chip_smoke.METHODS])
def test_report_digests_pin_chip_smoke(tmp_path, row):
    """The JAX package's full-openb experiment of each method row with
    per-event reports on has the report digest chip_smoke.py checks the
    card's runs against."""
    jn, jp, _, _ = openb_rows()
    jsim = JSimulator(jn, _configs(row, 1.3)[0])
    jsim.set_workload_pods(jp)
    jsim.run()
    mid, policies, gpu_sel, dim_ext = ROWS[row][:4]
    _experiment_files(jsim, tmp_path, chip_smoke.row_meta(
        policies, gpu_sel, dim_ext), janalyze_sim)
    assert chip_smoke.report_digest(str(tmp_path)) == \
        chip_smoke.REPORT_SHA256[mid]
