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
    DIM_EXT, INIT_NODES, INIT_ROWS, METHODS, MIXES, NORM, PAST_LIMIT,
    PAST_LIMIT_ROWS, RANDOMIZED_ROWS, SHAPE_CASES, SHAPE_ROWS, WIDE_BLOCKED,
    against_plain, init_case, init_config, past_limit_errors, random_case,
    shape_errors,
)
from tpusim_torch.io.trace import (
    build_events, load_node_csv, load_pod_csv, pods_to_specs,
)
from tpusim_torch.parallel.sharding import pad_nodes
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.fetch import device_fetch
from tpusim_torch.sim.metrics import compute_event_metrics

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


# every method row's configuration (01-Random, Simon and the six-policy
# profile among them), FGD with gpu_sel worst, the DotProduct (dim_ext,
# norm) pairs and the mixes of RandomScore, gpu_sel random and Simon
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
    + [(policies, gpu_sel, "share", "max") for _, policies, gpu_sel in MIXES]
)
# the configurations replay_blocked runs: every method row that does not
# draw per event, FGD with gpu_sel worst, FGD second, and Simon+FGD
BLOCKED_CONFIGS = (
    [tuple(row[1:5]) for row in METHODS if row[0] not in RANDOMIZED_ROWS]
    + [([("FGDScore", 1000)], "worst", "share", "max"), FGD_SECOND]
    + [(policies, gpu_sel, "share", "max")
       for label, policies, gpu_sel in MIXES if label == "Simon+FGD"]
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
@pytest.mark.parametrize("policies,gpu_sel,dim_ext,norm", BLOCKED_CONFIGS,
                         ids=lambda v: str(v))
def test_blocked_kernel_matches_plain_on_card(cuda_device, policies, gpu_sel,
                                              dim_ext, norm):
    """replay_blocked against plain_replay_blocked (on CPU copies of the
    same inputs), outputs, stats, final tables and summaries, on a seeded
    random cluster of 300 nodes padded to three 128-node blocks, under
    every method row's configuration that draws nothing per event (Simon's
    min-max path among them), FGD with gpu_sel worst, FGD as the second
    policy and Simon+FGD."""
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
@pytest.mark.parametrize("row", PAST_LIMIT_ROWS)
@pytest.mark.parametrize("which", [case[0] for case in PAST_LIMIT])
def test_wrappers_refuse_past_staged_limits(cuda_device, which, row):
    """One pod type (K = 2049) or one typical pod (T = 1025) past what the
    kernels' staged forms hold: the wrappers no longer refuse, the host
    launches the global forms, and init_tables and both replay kernels
    equal their plain versions (under FGD, and the six-policy profile
    through the randomized replay)."""
    assert past_limit_errors(which, row, cuda_device) == dict(
        init_tables=0, replay=0, replay_blocked=0)


@pytest.mark.cuda
@pytest.mark.parametrize("row", RANDOMIZED_ROWS)
def test_randomized_rows_run_flat_under_hbm(cuda_device, row):
    """A configuration that draws per event runs the flat replay, from the
    main replay's root key, whatever table_residency says: the same log,
    placements and masks as the plain replay on the CPU, on a 300-node,
    400-pod cut of openb."""
    _, policies, gpu_sel, dim_ext, norm = [r for r in METHODS
                                           if r[0] == row][0][:5]
    nodes = load_node_csv(os.path.join(
        REPO, "data/csv/openb_node_list_gpu_node.csv"))[:300]
    pods = load_pod_csv(os.path.join(
        REPO, "data/csv/openb_pod_list_default.csv"))[:400]
    runs = []
    for device in ("cuda", "cpu"):
        fe.reset_launch_counts()
        sim = Simulator(nodes, SimulatorConfig(
            policies=tuple(policies), gpu_sel_method=gpu_sel,
            dim_ext_method=dim_ext, norm_method=norm, table_residency="hbm"),
            device=device)
        sim.set_workload_pods(pods)
        runs.append((sim.run(), [line for line in sim.log.lines
                                 if "[Engine]" not in line]))
        assert sim.last_residency == "vmem"
        assert he.replay_blocked.launches == 0
        assert fe.replay.launches == (device == "cuda")
    (gpu, gpu_log), (cpu, cpu_log) = runs
    assert gpu_log == cpu_log
    assert np.array_equal(gpu.placed_node, cpu.placed_node)
    assert np.array_equal(gpu.dev_mask, cpu.dev_mask)


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return type(tree)(*(_cpu(x) for x in tree))


def _postpass_both(state, specs, evk, evp, out, tp):
    """The post-pass of a replay's telemetry on the card and on CPU copies
    of the same inputs."""
    card = compute_event_metrics(state, specs, evk, evp, out.event_node,
                                 out.event_dev, tp)
    cpu = compute_event_metrics(_cpu(state), _cpu(specs), evk.cpu(),
                                evp.cpu(), out.event_node.cpu(),
                                out.event_dev.cpu(), _cpu(tp))
    return card, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 9, 16, 17, 24, 32])
@pytest.mark.parametrize("nodes", [1, 2, 5, 20, 32])
def test_small_cluster_postpass_on_card_matches_cpu(cuda_device, nodes, t):
    """On clusters of at most 32 nodes with at most 32 typical pods the
    initial frag total, the initial rows and the per-event rows take the
    vectorised orders of the reference's CPU build (ops.frag `node_stages`,
    `pod_stages`, `row_stages`): compute_event_metrics on the card equals
    the CPU's bit for bit, on a seeded random cluster's creates and
    deletes replayed on the card."""
    from tpusim_torch.types import make_typical_pods

    state, pods, types, evk, evp, _, rank = random_case(
        7 * nodes + t, nodes, 80, cuda_device)
    rng = np.random.default_rng(t)
    freq = rng.random(t).astype(np.float32)
    tp = make_typical_pods(zip(
        rng.choice([1000, 4000, 8000, 16000], t),
        rng.choice([0, 100, 250, 500, 1000], t), rng.choice([1, 2], t),
        rng.choice([0, 1, 6], t), freq / freq.sum()), cuda_device)
    out = fe.make_fused_replay([("FGDScore", 1000)], "FGDScore",
                               cuda_device)(state, pods, types, evk, evp, tp,
                                            None, rank)
    card, cpu = _postpass_both(state, pods, evk, evp, out, tp)
    for name, a, b in zip(cpu._fields, card, cpu):
        assert a.device.type == "cuda", name
        assert torch.equal(a.cpu(), b), name


@pytest.mark.cuda
def test_postpass_on_card_matches_cpu(cuda_device):
    """compute_event_metrics on the card against the CPU, bit for bit, on a
    seeded random cluster's creates and deletes (T=24) and on a 256-pod
    openb prefix under 06-FGD (T=32); the one fetch brings every field
    back unchanged."""
    state, pods, types, evk, evp, tp, rank = random_case(
        41, 96, 300, cuda_device)
    out = fe.make_fused_replay([("FGDScore", 1000)], "FGDScore",
                               cuda_device)(state, pods, types, evk, evp, tp,
                                            None, rank)
    cases = [_postpass_both(state, pods, evk, evp, out, tp)]
    nodes = load_node_csv(os.path.join(
        REPO, "data/csv/openb_node_list_gpu_node.csv"))
    sim = Simulator(nodes, device="cuda")
    sim.set_workload_pods(load_pod_csv(os.path.join(
        REPO, "data/csv/openb_pod_list_default.csv"))[:256])
    sim.set_typical_pods()
    trace = sim.prepare_pods()
    specs = pods_to_specs(trace, sim.node_index, cuda_device)
    kinds, idx = build_events(trace)
    out = sim.run_events(sim.init_state, specs, kinds, idx)
    evk, evp = (torch.as_tensor(a, device=cuda_device) for a in (kinds, idx))
    cases.append(_postpass_both(sim.init_state, specs, evk, evp, out,
                                sim.typical))
    for card, cpu in cases:
        assert card.frag_amounts.device.type == "cuda"
        fetched = device_fetch(card)
        for name, a, b, c in zip(cpu._fields, card, cpu, fetched):
            assert torch.equal(a.cpu(), b), name
            assert c.device.type == "cpu" and c.dtype == b.dtype, name
            assert torch.equal(c, b), name
