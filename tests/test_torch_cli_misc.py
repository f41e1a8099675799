"""The port's CLI subcommands beside apply (version, gen-doc, debug) and the
knobs its checkpoint slice brought (engine "table", block_size, the apply
checkpoint and compile-cache flags, bench_scale's layout and cache flags),
against tpusim: the same version line, the same gen-doc file byte for byte
over one parser, debug a no-op; accepted knobs give tpusim's results, the
refused ones name their ROADMAP item."""

import argparse
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import tpusim.cli as jcli
import tpusim_torch.cli as pcli
from tests.test_torch_apply import _apply_both
from tests.test_torch_types_trace import REPO
from tpusim_torch import kernels
from tpusim_torch.io.trace import NodeRow, PodRow, pods_to_specs
from tpusim_torch.sim.driver import (
    Simulator,
    SimulatorConfig,
    enable_compile_cache,
)
from tpusim_torch.sim.table_engine import resolve_block_size

SC = os.path.join(REPO, "example/test-scheduler-config.yaml")


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_version_matches_tpusim(monkeypatch):
    assert _stdout(pcli.main, ["version"]) == _stdout(jcli.main, ["version"])
    assert _stdout(pcli.main, ["version"])[1] == \
        "tpusim version 0.1.0 (commit dev)\n"


def test_gen_doc_byte_for_byte(tmp_path):
    """Both cmd_gen_doc over one small parser write the same file; the
    port's gen-doc subcommand writes its own parser's help."""
    parser = argparse.ArgumentParser(prog="p")
    parser.add_argument("--x", default=1, help="an option")
    for mod, sub in ((jcli, "jax"), (pcli, "port")):
        args = argparse.Namespace(dir=str(tmp_path / sub))
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod.cmd_gen_doc(parser, args) == 0
    assert (tmp_path / "port" / "tpusim.md").read_bytes() == \
        (tmp_path / "jax" / "tpusim.md").read_bytes()
    rc, out = _stdout(pcli.main, ["gen-doc", "-d", str(tmp_path / "cli")])
    text = (tmp_path / "cli" / "tpusim.md").read_text()
    assert rc == 0 and out.startswith("wrote ")
    assert text.startswith("# tpusim\n\n```\n") and "apply" in text


def test_debug_exits_zero():
    assert _stdout(pcli.main, ["debug"]) == (0, "")
    assert _stdout(jcli.main, ["debug"]) == (0, "")


def _rows():
    rng = np.random.default_rng(5)
    nodes = [NodeRow(f"n{i}", 32000, 131072, int(g), "V100M16" if g else "")
             for i, g in enumerate(rng.choice([0, 2, 4, 8], 140))]
    pods = [PodRow(f"p{i}", int(rng.choice([1000, 4000])), 1024,
                   int(rng.choice([0, 1, 2])), 500) for i in range(60)]
    return nodes, pods


def _run(**knobs):
    nodes, pods = _rows()
    sim = Simulator(nodes, SimulatorConfig(
        policies=(("BestFitScore", 1000),), report_per_event=False, **knobs),
        device="cpu")
    sim.set_workload_pods(pods)
    sim.set_typical_pods()
    out = sim.run_events(sim.init_state, pods_to_specs(pods, None, "cpu"),
                         np.zeros(len(pods), np.int32),
                         np.arange(len(pods), dtype=np.int32))
    return sim, out


@pytest.mark.parametrize("engine,block,kernel", [
    ("auto", 0, "plain_replay"), ("table", 0, "plain_replay"),
    ("table", -1, "plain_replay"), ("table", 128, "plain_replay_blocked"),
    ("auto", 128, "plain_replay_blocked")])
def test_engine_table_and_block_sizes_run(engine, block, kernel):
    """engine "table" and block_size -1, 0 and 128 run, through the kernel
    block_size names, to the same bits (the counters on their
    engine-invariant prefix: `rebuilds` counts the blocked select's own
    summary-row rebuilds)."""
    sim, out = _run(engine=engine, block_size=block)
    _, ref = _run()
    assert sim.last_engine == kernel
    for name, a, b in zip(out._fields, out, ref):
        if name == "counters":
            a, b = a[:5], b[:5]
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_refused_widths_and_layouts_raise():
    """A block width other than 128, unswitched_select and bench_scale's
    --unswitched and --pallas-ceiling name ROADMAP item 6."""
    from tpusim_torch import bench_scale

    for knob in (dict(block_size=64), dict(block_size=256),
                 dict(unswitched_select=True)):
        with pytest.raises(NotImplementedError, match="item 6"):
            Simulator(*_rows()[:1], SimulatorConfig(**knob), device="cpu")
    for flag in ("--unswitched", "--pallas-ceiling"):
        with pytest.raises(NotImplementedError, match="item 6"):
            bench_scale.main(["--nodes", "10", "--pods", "10", "--device",
                              "cpu", flag])
    # tpusim's own rule, copied: flat below 8192 nodes, ~sqrt above
    assert resolve_block_size(0, 4000, 150) == 0
    assert resolve_block_size(-1, 100_000, 151) == 0
    assert resolve_block_size(0, 100_000, 151) == 64
    assert resolve_block_size(128, 100, 10) == 100


@pytest.mark.parametrize("sched", ["fgd", "default"])
def test_apply_checkpoint_flags_match_tpusim(tmp_path, sched):
    """`apply --checkpoint-every 7 --checkpoint-dir D` cuts the main replay
    of a 60-pod YAML cluster (engine table) into chunks (under FGD, and
    under the built-in profile, whose draws follow the key chain across
    the chunks) and prints
    what tpusim's unchunked apply prints (but for [Engine] lines); the
    completed run leaves no checkpoint."""
    import yaml

    from tests.test_torch_apply import _small_cluster

    cluster = _small_cluster(tmp_path / "cluster", num_pods=60)
    cr = tmp_path / "cr.yaml"
    cr.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config",
        "spec": {"cluster": {"customConfig": cluster},
                 # fewer events than twice the pod types: tpusim's auto
                 # would take its sequential engine, which never chunks
                 "customConfig": {"engine": "table"}}}))
    common = ["-f", str(cr)] + (["-s", SC] if sched == "fgd" else [])
    ckdir = tmp_path / "ck"
    port, jax = _apply_both(
        [*common, "--checkpoint-every", "7", "--checkpoint-dir", str(ckdir),
         "--checkpoint-keep", "0"], common)
    assert port == jax and "Cluster Analysis" in port
    # the directory exists only where a checkpoint was written
    assert os.listdir(ckdir) == []


def test_compile_cache_dir(tmp_path, monkeypatch):
    """compile_cache_dir (then $TPUSIM_COMPILE_CACHE_DIR) names where the
    kernels' library is built; unset, .tpusim_torch_build/."""
    monkeypatch.setattr(kernels, "_build_dir", None)
    monkeypatch.delenv("TPUSIM_COMPILE_CACHE_DIR", raising=False)
    assert enable_compile_cache("") is None
    assert kernels.build_dir() == kernels.BUILD_DIR
    monkeypatch.setenv("TPUSIM_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert kernels.build_dir() == str(tmp_path / "env")
    Simulator(*_rows()[:1], SimulatorConfig(
        compile_cache_dir=str(tmp_path / "cfg")), device="cpu")
    assert kernels.build_dir() == str(tmp_path / "cfg")
    assert kernels._target("")[0].startswith(str(tmp_path / "cfg"))


def test_bench_scale_table_flags(tmp_path, capsys):
    """bench_scale --engine table --block-size 128 --table-cache DIR runs
    the blocked replay through the chunk surface; the tables of each chunk
    are saved, and served on the warm pass."""
    from tpusim_torch import bench_scale

    assert bench_scale.main([
        "--nodes", "150", "--pods", "240", "--chunk", "120", "--device",
        "cpu", "--engine", "table", "--block-size", "128", "--table-cache",
        str(tmp_path)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "kernel=plain_replay_blocked" in line
    assert "table_cache=hit" in line
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".tables.npz")]) == 2
