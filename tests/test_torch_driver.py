"""The port's Simulator.run() against the JAX package's: the same log lines
(typical pods, workload, failed pods, the Cluster Analysis block) on an
openb prefix, under FGD and under other rows of the paper's method list,
through the Python API and through `python -m tpusim_torch`; the CUDA
default; and, slow-marked, the full openb FGD trace, and the JAX package's
full-openb digests of every method row, which pin the constants
chip_smoke.py holds the card to."""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_types_trace import REPO, openb_rows, paper_configs
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.typical import TypicalPodsConfig as JTypicalCfg
from tpusim_torch.__main__ import main as cli_main
from tpusim_torch.sim.driver import Simulator as PSimulator


def _log_without_engine(lines):
    """The engine line names the engine that ran, which differs by design."""
    return [line for line in lines if "[Engine]" not in line]


def method_configs(row, tune=1.3):
    """(JAX config, port config) of a chip_smoke.METHODS row."""
    _, policies, gpu_sel, dim_ext, norm = row[:5]
    jcfg, pcfg = paper_configs(tune=tune)
    method = dict(policies=tuple(policies), gpu_sel_method=gpu_sel,
                  dim_ext_method=dim_ext, norm_method=norm)
    return (dataclasses.replace(jcfg, **method),
            dataclasses.replace(pcfg, **method))


ROWS = {row[0]: row for row in chip_smoke.METHODS}


def _run_both(jnodes, jpods, pnodes, ppods, tune, configs=None):
    jcfg, pcfg = configs or paper_configs(tune=tune)
    jsim = JSimulator(jnodes, jcfg)
    jsim.set_workload_pods(jpods)
    jres = jsim.run()
    psim = PSimulator(pnodes, pcfg, device="cpu")
    psim.set_workload_pods(ppods)
    pres = psim.run()
    return jsim, jres, psim, pres


def test_run_matches_jax_on_openb_prefix():
    """256 events: the first 256 openb pods, shuffled, untuned."""
    jn, jp, pn, pp = openb_rows()
    jsim, jres, psim, pres = _run_both(jn, jp[:256], pn, pp[:256], tune=0.0)
    assert pres.events == 256
    assert _log_without_engine(psim.log.lines) == \
        _log_without_engine(jsim.log.lines)
    assert any("Cluster Analysis Results" in line for line in psim.log.lines)
    assert np.array_equal(pres.placed_node, np.asarray(jres.placed_node))
    assert np.array_equal(pres.dev_mask, np.asarray(jres.dev_mask))


@pytest.mark.parametrize("row", ["05-BestFit", "08-PWR_500_FGD_500"])
def test_method_row_matches_jax_on_openb_prefix(row):
    """256 events of two more method rows: min-max normalised BestFit with
    gpu_sel best, and the PWR+FGD weighted mix with FGD's device picks."""
    jn, jp, pn, pp = openb_rows()
    jsim, jres, psim, pres = _run_both(
        jn, jp[:256], pn, pp[:256], 0.0, method_configs(ROWS[row], 0.0))
    assert _log_without_engine(psim.log.lines) == \
        _log_without_engine(jsim.log.lines)
    assert np.array_equal(pres.placed_node, np.asarray(jres.placed_node))
    assert np.array_equal(pres.dev_mask, np.asarray(jres.dev_mask))


@pytest.mark.parametrize("flags,row", [
    ([], "06-FGD"),
    (["-PWR", "500", "-FGD", "500", "-gpusel", "FGDScore"],
     "08-PWR_500_FGD_500"),
    (["-DotProd", "1000", "-dimext", "merge"], "02-DotProd"),
    (["-Random", "1000", "-gpusel", "random", "-dimext", "merge"],
     "01-Random"),
    (["-Simon", "1000"], "Simon"),
])
def test_cli_matches_jax(tmp_path, capsys, flags, row):
    """`python -m tpusim_torch --device cpu` on a 60-node, 200-pod cut,
    with the method flags of experiments/run.py and its typical-pod
    settings, per-event reports on."""
    for name, rows in (("nodes", 61), ("pods", 201)):
        src = os.path.join(REPO, "data/csv", {
            "nodes": "openb_node_list_gpu_node.csv",
            "pods": "openb_pod_list_default.csv"}[name])
        with open(src) as f:
            lines = [next(f) for _ in range(rows)]
        (tmp_path / f"{name}.csv").write_text("".join(lines))
    assert cli_main(["--device", "cpu",
                     "--nodes", str(tmp_path / "nodes.csv"),
                     "--pods", str(tmp_path / "pods.csv"), *flags]) == 0
    out = capsys.readouterr().out.splitlines()
    jn, jp, _, _ = openb_rows()
    jcfg, _ = method_configs(ROWS[row])
    jcfg = dataclasses.replace(jcfg, report_per_event=True, typical_pods=(
        JTypicalCfg(pod_popularity_threshold=95, pod_increase_step=1)))
    jsim = JSimulator(jn[:60], jcfg)
    jsim.set_workload_pods(jp[:200])
    jsim.run()
    assert _log_without_engine(out) == _log_without_engine(jsim.log.lines)


def test_cuda_is_the_default(monkeypatch):
    """Without a GPU the default device raises instead of running on the
    CPU; the CLI likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, pn, _ = openb_rows()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PSimulator(pn[:10])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main([])


def test_run_events_rejects_malformed_streams():
    _, _, pn, pp = openb_rows()
    psim = PSimulator(pn[:20], device="cpu")
    psim.set_workload_pods(pp[:10])
    psim.set_typical_pods()
    from tpusim_torch.io.trace import pods_to_specs

    specs = pods_to_specs(pp[:10], None, "cpu")
    with pytest.raises(ValueError, match="unknown kind"):
        psim.run_events(psim.init_state, specs, [0, 5], [0, 1])
    with pytest.raises(ValueError, match="out of range"):
        psim.run_events(psim.init_state, specs, [0, 0], [0, 10])


@pytest.mark.slow
def test_full_openb_run_matches_jax_and_pins_digests():
    """The paper's acceptance case end to end on the CPU: 10.8k events,
    identical log, and the digests chip_smoke.py checks on the card."""
    jn, jp, pn, pp = openb_rows()
    jsim, jres, psim, pres = _run_both(jn, jp, pn, pp, tune=1.3)
    assert _log_without_engine(psim.log.lines) == \
        _log_without_engine(jsim.log.lines)

    def digest(a, dtype):
        return hashlib.sha256(np.ascontiguousarray(a, dtype).tobytes()).hexdigest()

    assert digest(np.asarray(jres.placed_node), np.int32) == \
        chip_smoke.OPENB_PLACED_SHA256
    assert digest(np.asarray(jres.dev_mask), np.uint8) == \
        chip_smoke.OPENB_DEV_MASK_SHA256
    assert digest(pres.placed_node, np.int32) == chip_smoke.OPENB_PLACED_SHA256
    assert digest(pres.dev_mask, np.uint8) == chip_smoke.OPENB_DEV_MASK_SHA256
    assert pres.events == chip_smoke.OPENB_EVENTS


@pytest.mark.slow
@pytest.mark.parametrize("row", [row[0] for row in chip_smoke.METHODS])
def test_method_digests_pin_chip_smoke(row):
    """The JAX package's full-openb run of each method row (tune 1.3,
    tuning seed 42, seed 42, shuffled) has the placement and device-mask
    digests chip_smoke.py checks the card's runs against."""
    *_, placed_sha, mask_sha = ROWS[row]
    jn, jp, _, _ = openb_rows()
    jsim = JSimulator(jn, method_configs(ROWS[row])[0])
    jsim.set_workload_pods(jp)
    jres = jsim.run()

    def digest(a, dtype):
        return hashlib.sha256(np.ascontiguousarray(a, dtype).tobytes()).hexdigest()

    assert len(jres.pods) == chip_smoke.OPENB_EVENTS
    assert digest(np.asarray(jres.placed_node), np.int32) == placed_sha
    assert digest(np.asarray(jres.dev_mask), np.uint8) == mask_sha
