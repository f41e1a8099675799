"""The port's CUDA kernels on the card against their plain PyTorch versions,
with zero tolerance. Every test here needs a CUDA device and skips without
one. The file imports nothing of JAX, so it also runs where only PyTorch is
installed; tests/conftest.py imports JAX, so there run it without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (
    DIM_EXT, INIT_NODES, INIT_ROWS, METHODS, NORM, SHAPE_CASES, SHAPE_ROWS,
    WIDE_BLOCKED, against_plain, init_case, init_config, over_staged_limit,
    random_case, shape_errors,
)
from tpusim_torch.io.trace import load_node_csv, load_pod_csv
from tpusim_torch.parallel.sharding import pad_nodes
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he
from tpusim_torch.sim.driver import Simulator, SimulatorConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            _assert_equal(a, b)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("seed,self_select", [(31, True), (32, False)])
def test_kernels_match_plain_on_card(cuda_device, seed, self_select):
    """init_tables and replay against plain_init_tables and plain_replay on
    the same seeded cluster, pods and events, under the paper's FGD
    configuration: outputs and the final tables."""
    cfg = fe.make_config([("FGDScore", 1000)],
                         "FGDScore" if self_select else "best")
    state, pods, types, evk, evp, tp, rank = random_case(
        seed, 64, 200, cuda_device)
    tables = fe.init_tables(state, types, tp, cfg)
    _assert_equal(tables, fe.plain_init_tables(state, types, tp, cfg))
    assert against_plain("replay", (state, pods, types, evk, evp, tp, rank,
                                    tables), cfg) == 0


# every method row's configuration, FGD with gpu_sel worst, and the
# DotProduct (dim_ext, norm) pairs
# FGD as the second policy: its refresh items and device picks follow
# another policy's segment
FGD_SECOND = ([("PWRScore", 500), ("FGDScore", 500)], "FGDScore", "share",
              "max")
CONFIGS = (
    [tuple(row[1:5]) for row in METHODS]
    + [([("FGDScore", 1000)], "worst", "share", "max")]
    + [([("DotProductScore", 1000)], "DotProductScore", d, n)
       for d in DIM_EXT for n in NORM]
    + [FGD_SECOND]
)


@pytest.mark.cuda
@pytest.mark.parametrize("policies,gpu_sel,dim_ext,norm", CONFIGS,
                         ids=lambda v: str(v))
def test_config_kernels_match_plain_on_card(cuda_device, policies, gpu_sel,
                                            dim_ext, norm):
    """init_tables and replay against their plain versions under every
    configuration the kernels cover, on a seeded random cluster: outputs
    and the final tables."""
    cfg = fe.make_config(policies, gpu_sel, dim_ext, norm)
    state, pods, types, evk, evp, tp, rank = random_case(
        33, 64, 200, cuda_device)
    tables = fe.init_tables(state, types, tp, cfg)
    _assert_equal(tables, fe.plain_init_tables(state, types, tp, cfg))
    assert against_plain("replay", (state, pods, types, evk, evp, tp, rank,
                                    tables), cfg) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("nodes", INIT_NODES)
@pytest.mark.parametrize("row", INIT_ROWS)
def test_init_tables_match_plain_on_used_clusters(cuda_device, row, nodes):
    """init_tables against plain_init_tables on partly used clusters: nodes
    with 1, 2, 3 and 8 distinct free device values, CPU-only nodes, share
    types that fit no device, Sub picks over unequal values, typical pods of
    frequency 0, and node counts about the kernel's 32-node tile."""
    state, types, tp = init_case(400 + INIT_NODES.index(nodes), nodes,
                                 cuda_device)
    cfg = init_config(row)
    _assert_equal(fe.init_tables(state, types, tp, cfg),
                  fe.plain_init_tables(state, types, tp, cfg))


@pytest.mark.cuda
def test_simulator_on_card_matches_cpu(cuda_device):
    """Simulator.run() on its default device against device="cpu" on a
    60-node, 200-pod cut of openb: the same log, placements and masks."""
    nodes = load_node_csv(os.path.join(
        REPO, "data/csv/openb_node_list_gpu_node.csv"))[:60]
    pods = load_pod_csv(os.path.join(
        REPO, "data/csv/openb_pod_list_default.csv"))[:200]
    fe.reset_launch_counts()
    runs = []
    for device in ("cuda", "cpu"):
        sim = Simulator(nodes, device=device)
        sim.set_workload_pods(pods)
        runs.append((sim.run(), [line for line in sim.log.lines
                                 if "[Engine]" not in line]))
    assert fe.replay.launches == 1
    (gpu, gpu_log), (cpu, cpu_log) = runs
    assert gpu_log == cpu_log
    assert np.array_equal(gpu.placed_node, cpu.placed_node)
    assert np.array_equal(gpu.dev_mask, cpu.dev_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("policies,gpu_sel,dim_ext,norm",
                         CONFIGS[:10] + [FGD_SECOND],
                         ids=lambda v: str(v))
def test_blocked_kernel_matches_plain_on_card(cuda_device, policies, gpu_sel,
                                              dim_ext, norm):
    """replay_blocked against plain_replay_blocked (on CPU copies of the
    same inputs), outputs, stats, final tables and summaries, on a seeded
    random cluster of 300 nodes padded to three 128-node blocks, under
    every method row's configuration, FGD with gpu_sel worst and FGD as
    the second policy."""
    cfg = fe.make_config(policies, gpu_sel, dim_ext, norm)
    state, pods, types, evk, evp, tp, rank = random_case(
        34, 300, 200, cuda_device)
    state, rank = pad_nodes(state, rank, 128)
    tables = fe.init_tables(state, types, tp, cfg)
    assert against_plain("replay_blocked", (state, pods, types, evk, evp, tp,
                                            rank, tables), cfg,
                         plain_on_cpu=True) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("nodes", WIDE_BLOCKED)
@pytest.mark.parametrize("row", ["05-BestFit", "08-PWR_500_FGD_500"])
def test_blocked_kernel_matches_plain_on_wide_clusters(cuda_device, row,
                                                       nodes):
    """replay_blocked against plain_replay_blocked (on CPU copies),
    outputs, stats, final tables and summaries, under the normalised
    BestFit and PWR+FGD rows on seeded random clusters of 17 blocks (a
    warp rebuilds several blocks of a summary row) and 513 blocks (the
    select and drift loops stride past the block's threads)."""
    _, policies, gpu_sel, dim_ext, norm = [r for r in METHODS
                                           if r[0] == row][0][:5]
    cfg = fe.make_config(policies, gpu_sel, dim_ext, norm)
    state, pods, types, evk, evp, tp, rank = random_case(
        35, nodes, 300, cuda_device)
    state, rank = pad_nodes(state, rank, 128)
    tables = fe.init_tables(state, types, tp, cfg)
    assert against_plain("replay_blocked", (state, pods, types, evk, evp, tp,
                                            rank, tables), cfg,
                         plain_on_cpu=True) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["06-FGD", "05-BestFit"])
def test_simulator_hbm_residency_on_card(cuda_device, row):
    """Simulator.run() with table_residency "hbm" (replay_blocked) against
    "vmem" (replay) on a 300-node, 400-pod cut of openb: the same log,
    placements and masks, and each run launches its own kernel."""
    _, policies, gpu_sel, dim_ext, norm = [r for r in METHODS
                                           if r[0] == row][0][:5]
    nodes = load_node_csv(os.path.join(
        REPO, "data/csv/openb_node_list_gpu_node.csv"))[:300]
    pods = load_pod_csv(os.path.join(
        REPO, "data/csv/openb_pod_list_default.csv"))[:400]
    runs = []
    for tier in ("vmem", "hbm"):
        fe.reset_launch_counts()
        sim = Simulator(nodes, SimulatorConfig(
            policies=tuple(policies), gpu_sel_method=gpu_sel,
            dim_ext_method=dim_ext, norm_method=norm, table_residency=tier))
        sim.set_workload_pods(pods)
        runs.append((sim.run(), [line for line in sim.log.lines
                                 if "[Engine]" not in line]))
        assert sim.last_residency == tier
        assert he.replay_blocked.launches == (tier == "hbm")
        assert fe.replay.launches == (tier == "vmem")
    (flat, flat_log), (blocked, blocked_log) = runs
    assert blocked_log == flat_log
    assert np.array_equal(blocked.placed_node, flat.placed_node)
    assert np.array_equal(blocked.dev_mask, flat.dev_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("row", SHAPE_ROWS)
@pytest.mark.parametrize("label", [case[0] for case in SHAPE_CASES])
def test_type_shapes_match_plain_on_card(cuda_device, label, row):
    """init_tables and both replay kernels against their plain versions
    (the tables; outputs, stats, final tables and summaries) where the
    share items outrun one round of the block's threads (ks=200), without
    share types, with only share types, with one typical pod, and at the
    most pod types and typical pods the kernels stage."""
    assert shape_errors(label, row, cuda_device) == dict(
        init_tables=0, replay=0, replay_blocked=0)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["types", "typical"])
def test_wrappers_refuse_past_staged_limits(cuda_device, which):
    """One pod type or typical pod past what the kernels stage: every
    wrapper raises before launching."""
    args, cfg = over_staged_limit(which, cuda_device)
    state, pods, types, evk, evp, tp, rank, tables = args
    fe.reset_launch_counts()
    with pytest.raises(ValueError, match="stage at most"):
        fe.init_tables(state, types, tp, cfg)
    with pytest.raises(ValueError, match="stage at most"):
        fe.replay(*args, cfg)
    padded, rank = pad_nodes(state, rank, 128)
    with pytest.raises(ValueError, match="stage at most"):
        he.replay_blocked(padded, pods, types, evk, evp, tp, rank,
                          tuple(t.new_zeros((t.shape[0], padded.num_nodes))
                                for t in tables), cfg)
    assert fe.init_tables.launches == 0 and fe.replay.launches == 0
    assert he.replay_blocked.launches == 0
