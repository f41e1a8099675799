"""The port's scale entry (tpusim_torch.bench_scale) against the JAX
package's bench_scale.py, with zero tolerance: the same synthetic nodes and
pods from the same seeds, and the same chunk-by-chunk placements, masks,
failures and final state through the blocked replay as through tpusim's
table engine, at a small size; the command line. Slow-marked: the JAX
package's digests of the 100k-node scale configuration's first chunk, which
pin chip_smoke.py's constants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench_scale as jbench
import chip_smoke
from tests.test_torch_types_trace import assert_tree_equal
from tpusim.io.trace import build_events as jbuild_events
from tpusim.io.trace import pods_to_specs as jpods_to_specs
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim.sim.table_engine import build_pod_types
from tpusim.sim.typical import TypicalPodsConfig as JTypicalCfg
from tpusim_torch import bench_scale as pbench


def test_synth_rows_match_bench_scale():
    """The same synthetic nodes and pods as bench_scale.py's, seed for
    seed."""
    def rows(items, fields):
        return [tuple(getattr(r, f) for f in fields) for r in items]

    node_fields = ("name", "cpu_milli", "memory_mib", "gpu", "model",
                   "cpu_model")
    pod_fields = ("name", "cpu_milli", "memory_mib", "num_gpu", "gpu_milli",
                  "gpu_spec", "pinned_node", "unscheduled")
    assert rows(pbench.synth_cluster(500, 42), node_fields) == \
        rows(jbench.synth_cluster(500, 42), node_fields)
    assert rows(pbench.synth_pods(2000, 43), pod_fields) == \
        rows(jbench.synth_pods(2000, 43), pod_fields)


def _jax_scale_chunks(nodes, pods, chunk, events):
    """bench_scale.py's chunked replay with tpusim's table engine: the
    final state, and each chunk's placements, masks and failed creates."""
    sim = JSimulator(nodes, JConfig(
        policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore", seed=42,
        report_per_event=False, engine="table",
        typical_pods=JTypicalCfg(pod_popularity_threshold=95)))
    sim.set_workload_pods(pods)
    sim.set_typical_pods()
    specs = jpods_to_specs(pods)
    ev_kind, ev_pod = jbuild_events(pods)
    types = build_pod_types(specs)
    state, out = sim.init_state, []
    for lo in range(0, events, chunk):
        hi = min(lo + chunk, events)
        res = sim.run_events(state, specs, jnp.asarray(ev_kind[lo:hi]),
                             jnp.asarray(ev_pod[lo:hi]),
                             jax.random.PRNGKey(42), bucket=chunk,
                             types=types)
        state = res.state
        out.append((np.asarray(res.placed_node), np.asarray(res.dev_mask),
                    int(np.asarray(res.ever_failed).sum())))
    return state, out


def test_scale_path_matches_bench_scale_chunks():
    """The scale entry's path (synthetic rows, typical pods over the whole
    stream, chunked replay carrying the state) through the blocked replay
    against bench_scale.py's through tpusim's table engine, chunk by chunk,
    at 200 nodes and 400 pods."""
    state, want = _jax_scale_chunks(jbench.synth_cluster(200, 42),
                                    jbench.synth_pods(400, 43), 200, 400)
    run = pbench.ScaleRun(pbench.synth_cluster(200, 42),
                          pbench.synth_pods(400, 43),
                          pbench.scale_config(42, "hbm"), "cpu")
    final, results, failed, rebuilds = run.replay(200)
    assert len(results) == len(want) == 2 and rebuilds == 0
    for res, (placed, mask, _) in zip(results, want):
        assert np.array_equal(res.placed_node.numpy(), placed)
        assert np.array_equal(res.dev_mask.numpy(), mask)
    assert_tree_equal(final, state)
    assert failed == sum(f for *_, f in want)


def test_bench_scale_cli(capsys):
    assert pbench.main(["--nodes", "200", "--pods", "300", "--chunk", "120",
                        "--device", "cpu", "--residency", "hbm"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[scale] nodes=200 pods=300 "
                           "kernel=plain_replay_blocked residency=hbm")
    assert "rebuilds=0" in line and "device=cpu" in line


@pytest.mark.slow
def test_scale_anchor_pins_chip_smoke():
    """The JAX package's replay of the scale configuration's first
    200,000-event chunk (100k nodes, the 1M-pod stream's typical pods;
    Simulator(engine="table") on the CPU, ~2 minutes) has the digests
    chip_smoke.py holds the card's replay_blocked to."""
    nodes = jbench.synth_cluster(chip_smoke.SCALE_NODES, chip_smoke.SCALE_SEED)
    pods = jbench.synth_pods(chip_smoke.SCALE_PODS, chip_smoke.SCALE_SEED + 1)
    _, ((placed, mask, _),) = _jax_scale_chunks(
        nodes, pods, chip_smoke.SCALE_CHUNK, chip_smoke.SCALE_CHUNK)
    assert chip_smoke.digest(placed, np.int32) == \
        chip_smoke.SCALE_PLACED_SHA256
    assert chip_smoke.digest(mask, np.uint8) == \
        chip_smoke.SCALE_DEV_MASK_SHA256
