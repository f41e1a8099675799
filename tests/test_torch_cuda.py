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
    DIM_EXT, DOWN_CASE, DOWN_ROWS, INIT_NODES, INIT_ROWS, LANE_CASE_FLAGS,
    LANE_ROWS, LEARN_PLAN_COUNTS, METHODS, MIXES, NORM, PAST_LIMIT,
    PAST_LIMIT_ROWS, PAST_LIMIT, RANDOMIZED_ROWS, SHAPE_CASES, SHAPE_ROWS,
    WIDE_BLOCKED, against_plain, down_checks, fault_against_plain,
    fault_lanes_against_plain, init_case, init_config, lane_tables,
    past_limit_errors, plan_case, random_case, record_against_plain,
    record_edge_case, shape_errors, to_cpu, typed_case,
)
from tpusim_torch.io.trace import (
    build_events, load_node_csv, load_pod_csv, pods_to_specs,
)
from tpusim_torch.parallel.sharding import pad_nodes
from tpusim_torch.sim import fault_lane as fl
from tpusim_torch.sim import fused_engine as fe
from tpusim_torch.sim import hbm_engine as he
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.faults import FaultConfig, fail_node
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


# the lanes launches: (label, policies, gpu_sel, dim_ext, blocked)
LANE_CASES = (
    ("06-FGD", [("FGDScore", 1000)], "FGDScore", "share", False),
    ("FGD+BestFit", [("FGDScore", 1000), ("BestFitScore", 500)], "FGDScore",
     "share", False),
    ("01-Random", [("RandomScore", 1000)], "random", "merge", False),
    ("Random+FGD", [("RandomScore", 500), ("FGDScore", 500)], "FGDScore",
     "share", False),
    ("06-FGD", [("FGDScore", 1000)], "FGDScore", "share", True),
    ("FGD+BestFit", [("FGDScore", 1000), ("BestFitScore", 500)], "FGDScore",
     "share", True),
    ("Simon+FGD", [("Simon", 500), ("FGDScore", 500)], "FGDScore", "share",
     True),
)


@pytest.mark.cuda
@pytest.mark.parametrize("label,policies,gpu_sel,dim_ext,blocked", LANE_CASES,
                         ids=[f"{c[0]}-{'blocked' if c[4] else 'flat'}"
                              for c in LANE_CASES])
def test_lanes_match_single_launches(cuda_device, label, policies, gpu_sel,
                                     dim_ext, blocked):
    """Each lane of a lanes launch (its own rank, weights and key) against
    the single launch of that lane: outputs, stats, final tables."""
    cfg = fe.make_config(policies, gpu_sel, dim_ext)
    state, pods, types, evk, evp, tp, rank = random_case(
        41, 256, 300, cuda_device)
    if blocked:
        state, rank = pad_nodes(state, rank, 128)
    tables = fe.init_tables(state, types, tp, cfg)
    gen = torch.Generator().manual_seed(5)
    rows = ([1000] * len(policies), [10 * (i + 1) for i in range(len(policies))],
            [0] + [700] * (len(policies) - 1))
    lanes = [fe.Lane(pods, types.type_id, evk, evp,
                     rank[torch.randperm(state.num_nodes, generator=gen)
                          .to(cuda_device)],
                     fe.lane_weights(cfg, row),
                     (0, 40 + i) if cfg.randomized else None)
             for i, row in enumerate(rows)]
    prep = (he.prepare_replay_blocked_lanes if blocked
            else fe.prepare_replay_lanes)
    ready = prep(state, types, tp, tables, cfg, lanes)
    fe.launch(ready)
    got = ready.finish()
    for i, lane in enumerate(lanes):
        lane_cfg = cfg._replace(weights=lane.weights)
        if blocked:
            single = he.prepare_replay_blocked(state, pods, types, evk, evp,
                                               tp, lane.rank, tables, lane_cfg)
        else:
            single = fe.prepare_replay(state, pods, types, evk, evp, tp,
                                       lane.rank, tables, lane_cfg,
                                       key=lane.key)
        fe.launch(single)
        _assert_equal(got[i], single.finish())
        for name in ("score", "sdev", "feas"):
            assert torch.equal(ready.tensors[name][i], single.tensors[name])


@pytest.mark.cuda
def test_lanes_refuse_mixed_instantiations(cuda_device):
    """A lane array whose lanes need different instantiations (another
    policy, another gpu_sel, staged against global: a lane with one
    typical pod past the staged limit) is refused by the launcher;
    replay_blocked_lanes refuses a randomized configuration."""
    from tpusim_torch import kernels

    case = random_case(42, 256, 100, cuda_device)
    state, _, types, _, _, tp, rank = case
    padded, rank_p = pad_nodes(state, rank, 128)
    stream = torch.cuda.current_stream().cuda_stream

    def lane_args(policies, gpu_sel, case=case, prep=None):
        st, pods, types, evk, evp, tp, rk = case
        cfg = fe.make_config(policies, gpu_sel)
        tables = fe.init_tables(st, types, tp, cfg)
        prep = prep or fe.prepare_replay_lanes
        return prep(st, types, tp, tables, cfg, [fe.Lane(
            pods, types.type_id, evk, evp, rk, cfg.weights,
            (0, 1) if cfg.randomized else None)])

    _, ks, kw, t = dict((c[0], c) for c in PAST_LIMIT)["T=1025"]
    wide = typed_case(301, 130, ks, kw, t, 90, cuda_device, 60)
    assert kernels.staged(types.num_types, tp.size)
    assert not kernels.staged(wide[2].num_types, wide[5].size)
    fgd = lane_args([("FGDScore", 1000)], "FGDScore")
    for other in (lane_args([("BestFitScore", 1000)], "best"),
                  lane_args([("FGDScore", 1000)], "worst"),
                  lane_args([("FGDScore", 1000)], "FGDScore", wide)):
        buf = torch.empty(2 * len(bytes(fgd.args[0])), dtype=torch.uint8,
                          device=cuda_device)
        with pytest.raises(RuntimeError, match="replay_lanes launch failed"):
            kernels.launch_lanes("replay_lanes", fgd.args + other.args,
                                 buf.data_ptr(), stream)
    rnd = lane_args([("RandomScore", 1000)], "random",
                    (padded,) + case[1:6] + (rank_p,))
    with pytest.raises(RuntimeError, match="replay_blocked_lanes launch"):
        kernels.launch_lanes("replay_blocked_lanes", rnd.args,
                             rnd.tensors["lanes_dev"].data_ptr(), stream)
    with pytest.raises(ValueError, match="randomized"):
        lane_args([("RandomScore", 1000)], "random",
                  (padded,) + case[1:6] + (rank_p,),
                  he.prepare_replay_blocked_lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("row", DOWN_ROWS)
def test_kernels_match_plain_on_failed_nodes(cuda_device, row):
    """init_tables, replay and (for the rows that do not draw per event)
    replay_blocked against their plain versions on a random cluster with a
    quarter of its nodes down (mem_left -1, rows reset to idle capacity):
    outputs, stats, final states, tables and summaries, tolerance 0."""
    n, p = DOWN_CASE
    state, pods, types, evk, evp, tp, rank = random_case(78, n, p,
                                                         cuda_device)
    for node in np.random.default_rng(78).choice(n, n // 4,
                                                 replace=False).tolist():
        state = fail_node(state, node)
    cfg = fe.make_config(*dict((r[0], r) for r in METHODS)[row][1:5])
    errs = down_checks(row, (state, pods, types, evk, evp, tp, rank), cfg,
                       row not in RANDOMIZED_ROWS)
    assert not any(errs.values())


def _openb_cut(num_pods=400):
    nodes = load_node_csv(os.path.join(
        REPO, "data/csv/openb_node_list_gpu_node.csv"))
    pods = load_pod_csv(os.path.join(
        REPO, "data/csv/openb_pod_list_default.csv"))[:num_pods]
    return nodes, pods


def _same_result(a, b):
    assert np.array_equal(a.placed_node, b.placed_node)
    assert np.array_equal(a.dev_mask, b.dev_mask)
    assert np.array_equal(a.creation_rank, b.creation_rank)
    assert [(u.pod.name, u.reason) for u in a.unscheduled_pods] == \
        [(u.pod.name, u.reason) for u in b.unscheduled_pods]
    for x, y in zip(a.state, b.state):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["cosSim", "fragOnePod", "fragMultiPod"])
def test_deschedule_on_card_matches_cpu(cuda_device, policy):
    """run() then deschedule_cluster() on a 400-pod openb prefix on the
    card against device="cpu": the log without [Engine], placements,
    masks, ranks, unscheduled pods and state; the victims' replay is one
    more launch of init_tables and replay."""
    nodes, pods = _openb_cut()
    cfg = SimulatorConfig(deschedule_ratio=0.3, deschedule_policy=policy)
    runs = []
    for device in ("cuda", "cpu"):
        sim = Simulator(nodes, cfg, device=device)
        sim.set_workload_pods(pods)
        fe.reset_launch_counts()
        sim.run()
        sim.deschedule_cluster()
        sim.cluster_analysis("PostDeschedule")
        if device == "cuda":
            assert fe.replay.launches == fe.init_tables.launches == len(
                sim.replay_times)
        runs.append((sim.last_result, [line for line in sim.log.lines
                                       if "[Engine]" not in line]))
    (gpu, gpu_log), (cpu, cpu_log) = runs
    assert gpu_log == cpu_log
    _same_result(gpu, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("residency", ["auto", "hbm"])
def test_run_with_faults_on_card_matches_cpu(cuda_device, residency):
    """run_with_faults on a 400-pod openb prefix under a dense schedule
    on the card against device="cpu": the log without [Engine], the
    result, the disruption metrics; one init_tables and one replay (or
    replay_blocked) launch a segment."""
    nodes, pods = _openb_cut()
    fcfg = FaultConfig(mtbf_events=30, mttr_events=50, evict_every_events=20,
                       seed=7)
    runs = []
    for device in ("cuda", "cpu"):
        sim = Simulator(nodes, SimulatorConfig(table_residency=residency),
                        device=device)
        sim.set_workload_pods(pods)
        fe.reset_launch_counts()
        sim.run_with_faults(fcfg)
        if device == "cuda":
            kernel = he.replay_blocked if residency == "hbm" else fe.replay
            assert kernel.launches == fe.init_tables.launches == len(
                sim.replay_times) > 1
        runs.append((sim, [line for line in sim.log.lines
                           if "[Engine]" not in line]))
    (gpu, gpu_log), (cpu, cpu_log) = runs
    assert gpu_log == cpu_log
    _same_result(gpu.last_result, cpu.last_result)
    assert gpu.last_disruption == cpu.last_disruption
    assert gpu.last_disruption.node_failures > 0


def _fault_plans(case, count: int):
    """`count` plans of LANE_CASE_FLAGS schedules (fault seeds 21, 22, ...)
    over a random case's events."""
    from tpusim_torch.sim.faults import generate_fault_schedule

    state, pods, _, evk, evp, _, _ = case
    n, p = state.num_nodes, int(pods.cpu.shape[0])
    plans = []
    for b in range(count):
        fcfg = FaultConfig(**LANE_CASE_FLAGS, seed=21 + b)
        plans.append(fl.compile_fault_plan(
            evk.cpu().numpy(), evp.cpu().numpy(),
            generate_fault_schedule(n, evk.shape[0], fcfg), fcfg, n, p))
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("row", LANE_ROWS)
def test_fault_forms_match_plain_on_card(cuda_device, row):
    """Each fault form against its plain version on a 64-node random
    cluster under a dense schedule (failures, recoveries, evictions,
    retries, a queue of 16 that overflows, flush rounds): one launch and
    2 lanes of their own schedules, ranks and keys, tolerance 0 with the
    steps' outputs, the final carry, tables and summaries (the blocked
    forms for the rows that draw nothing per event)."""
    cfg = fe.make_config(*dict((r[0], r) for r in METHODS)[row][1:5])
    case = random_case(41, 64, 200, cuda_device)
    state, pods, types, evk, evp, tp, rank = case
    plans = _fault_plans(case, 2)
    forms = [("replay_faults", "replay_lanes_faults")]
    if row not in RANDOMIZED_ROWS:
        forms.append(("replay_blocked_faults", "replay_blocked_lanes_faults"))
    for name, lanes_name in forms:
        st, rk = (pad_nodes(state, rank, 128) if "blocked" in name
                  else (state, rank))
        tables = lane_tables(st, types, tp, cfg)
        err = fault_against_plain(name, (st, pods, types, tp, rk, tables),
                                  cfg, plans[0], repeats=1)[0]
        assert err == 0, name
        other = torch.flip(rk[:64], (0,))
        lanes = [fe.Lane(pods, types.type_id,
                         torch.as_tensor(pl.kind, device=cuda_device),
                         torch.as_tensor(pl.idx, device=cuda_device),
                         rk if b == 0 else torch.cat([other, rk[64:]]),
                         cfg.weights, (0, 7 + b) if cfg.randomized else None,
                         fl.lane_of(pl, st, 200))
                 for b, pl in enumerate(plans)]
        assert fault_lanes_against_plain(
            lanes_name, (st, types, tp, tables), cfg, lanes)[0] == 0, \
            lanes_name


# schedules that work the retry queue's summary in the fault forms: dense
# evictions and failures under a short backoff, so the queue fills (a
# capacity of 1 refuses pushes) and drains, with runs of inert slots
# between and the max_retries flush rounds at the end
QUEUE_FLAGS = dict(mtbf_events=50, mttr_events=120, evict_every_events=12,
                   max_retries=3, backoff_base=2, backoff_cap=16)


@pytest.mark.cuda
def test_fault_queue_summary_matches_plain_on_card(cuda_device):
    """Each fault form against its plain version, tolerance 0, on streams
    whose retry slots work the queue summary: long runs of inert slots,
    flush rounds, a queue of capacity 1 that is full (pushes refused, pods
    dead), and 2 lanes whose queues differ (capacities 1 and 4, their own
    schedules)."""
    from tpusim_torch.sim.engine import EV_RETRY
    from tpusim_torch.sim.faults import generate_fault_schedule

    cfg = fe.make_config([("FGDScore", 1000)], "FGDScore")
    case = random_case(47, 64, 200, cuda_device)
    state, pods, types, evk, evp, tp, rank = case
    n, p = state.num_nodes, int(pods.cpu.shape[0])
    plans = []
    for seed, cap in ((5, 1), (6, 4)):
        fcfg = FaultConfig(**QUEUE_FLAGS, queue_capacity=cap, seed=seed)
        plans.append(fl.compile_fault_plan(
            evk.cpu().numpy(), evp.cpu().numpy(),
            generate_fault_schedule(n, evk.shape[0], fcfg), fcfg, n, p))
    for plan in plans:  # flush rounds
        assert (plan.arg[plan.kind == EV_RETRY] > 0).any()
    for name, lanes_name in (("replay_faults", "replay_lanes_faults"),
                             ("replay_blocked_faults",
                              "replay_blocked_lanes_faults")):
        st, rk = (pad_nodes(state, rank, 128) if "blocked" in name
                  else (state, rank))
        tables = lane_tables(st, types, tp, cfg)
        firsts, longest = [], 0
        for plan in plans:
            err, _, _, got, first = fault_against_plain(
                name, (st, pods, types, tp, rk, tables), cfg, plan,
                repeats=1)
            assert err == 0, name
            firsts.append(first)
            slot = plan.kind == EV_RETRY
            inert = slot & (got[-1].ys.rpod.cpu().numpy() < 0)
            assert (slot & ~inert).any()  # slots that pop
            run = 0
            for x in inert:
                run = run + 1 if x else 0
                longest = max(longest, run)
        assert longest >= 8
        # the capacity-1 queue was full: pushes refused, pods dead
        assert int(firsts[0][0][-1].carry.dctr[6]) > 0
        lanes = [fe.Lane(pods, types.type_id,
                         torch.as_tensor(pl.kind, device=cuda_device),
                         torch.as_tensor(pl.idx, device=cuda_device), rk,
                         cfg.weights, None, fl.lane_of(pl, st, p))
                 for pl in plans]
        assert fault_lanes_against_plain(
            lanes_name, (st, types, tp, tables), cfg, lanes,
            first=firsts[0])[0] == 0, lanes_name


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True], ids=["flat", "blocked"])
def test_retry_only_stream_leaves_tables_unchanged(cuda_device, blocked):
    """A stream of EV_RETRY slots alone over an empty queue: every slot is
    inert, so the fault form leaves the state, tables, placements, carry
    and outputs as they were."""
    cfg = fe.make_config([("FGDScore", 1000)], "FGDScore")
    state, pods, types, _, _, tp, rank = random_case(43, 64, 50, cuda_device)
    if blocked:
        state, rank = pad_nodes(state, rank, 128)
    tables = lane_tables(state, types, tp, cfg)
    e = 300
    plan = fl.FaultPlan(
        kind=np.full(e, 6, np.int32), idx=np.zeros(e, np.int32),
        pos=np.arange(e, dtype=np.int32) // 3,
        arg=np.where(np.arange(e) >= 240, 1, 0).astype(np.int32),
        aux=np.full(e, -1, np.int32), draws=np.full((1, 51), -1, np.int32),
        params=np.array([8, 256, 3, 100], np.int32), capacity=16,
        num_events=100, has_recover=False)
    lane = fl.lane_of(plan, state, 50)
    args = (state, pods, types, torch.as_tensor(plan.kind, device=cuda_device),
            torch.as_tensor(plan.idx, device=cuda_device), tp, rank, tables,
            cfg, lane)
    if blocked:
        out, _, fout = he.replay_blocked_faults(*args)
    else:
        out, fout = fe.replay_faults(*args)
    for a, b in zip(out.state, state):
        assert torch.equal(a, b)
    ready = (he.prepare_replay_blocked_faults if blocked
             else fe.prepare_replay_faults)(*args)
    fe.launch(ready)
    for name, t in zip(("score", "sdev", "feas"), tables):
        assert torch.equal(ready.tensors[name], t), name
    assert bool((out.placed_node == -1).all())
    assert bool((out.event_node == -1).all())
    assert bool((fout.ys.rpod == -1).all()) and bool((fout.ys.nvict == 0).all())
    for name in fl.FaultCarry._fields:
        assert torch.equal(getattr(fout.carry, name).cpu(),
                           getattr(lane.carry, name).cpu()), name


@pytest.mark.cuda
def test_device_fetch_of_one_element_columns(cuda_device):
    """device_fetch of column views holding one element (a one-event
    replay's metrics rows: stride 2, which .contiguous() keeps) and of
    empty ones moves the values, as for any other length."""
    for rows in (0, 1, 3):
        pw = torch.arange(2 * rows, dtype=torch.float32,
                          device=cuda_device).reshape(rows, 2)
        mask = torch.ones(rows, 8, dtype=torch.bool, device=cuda_device)
        got = device_fetch((pw[:, 0], pw[:, 1], mask[:, 2]))
        for a, b in zip(got, (pw[:, 0], pw[:, 1], mask[:, 2])):
            assert a.device.type == "cpu" and torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_oracle_on_card_matches_cpu(cuda_device):
    """The sequential oracle (engine.make_replay) on the card against the
    same oracle on the CPU, on a seeded random cluster, under every method
    row (the draws of 01-Random and the profile from one root key): every
    output and the final state."""
    from tpusim_torch.policies import make_policy
    from tpusim_torch.sim.engine import make_replay

    for row in METHODS:
        _, policies, gpu_sel, dim_ext, norm = row[:5]
        replay = make_replay([(make_policy(n, dim_ext, norm), w)
                              for n, w in policies], gpu_sel, report=False)
        outs = []
        for dev in (cuda_device, torch.device("cpu")):
            state, pods, _, evk, evp, tp, rank = random_case(41, 64, 200,
                                                             dev)
            outs.append(replay(state, pods, evk, evp, tp, (0, 9), rank))
        got, want = outs
        for name in ("placed_node", "dev_mask", "ever_failed", "event_node",
                     "event_dev"):
            assert torch.equal(getattr(got, name).cpu(),
                               getattr(want, name)), (row[0], name)
        _assert_equal(got.state, want.state)


# configurations whose chunked replay the key-out tests hold: 01-Random
# and gpu_sel random (the randomized instantiation, flat), and the key
# alone (key_out) through FGD flat and blocked and BestFit blocked
CHUNK_CASES = (
    ("01-Random", [("RandomScore", 1000)], "random", -1),
    ("FGD-random", [("FGDScore", 1000)], "random", -1),
    ("06-FGD", [("FGDScore", 1000)], "FGDScore", -1),
    ("06-FGD/hbm", [("FGDScore", 1000)], "FGDScore", 128),
    ("05-BestFit/hbm", [("BestFitScore", 1000)], "best", 128),
)


@pytest.mark.cuda
@pytest.mark.parametrize("label,policies,gpu_sel,block", CHUNK_CASES,
                         ids=[c[0] for c in CHUNK_CASES])
def test_chunk_key_out_matches_plain(cuda_device, label, policies, gpu_sel,
                                     block):
    """The chunk surface on the card (init_tables, then replay or
    replay_blocked from the carry, writing the chain's key after the
    chunk's last event) against its plain versions on the CPU, on a seeded
    256-node cluster cut into three chunks: the carry after each chunk
    (the key included) and the final outputs; and the chunked run on the
    card equals one launch over the whole stream."""
    from tpusim_torch.sim import table_engine as te

    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        state, pods, types, evk, evp, tp, rank = random_case(43, 256, 300,
                                                             dev)
        fn = te.make_table_replay(policies, gpu_sel, block)
        e = int(evk.shape[0])
        carry = fn.init_carry(state, pods, types, tp, (0, 11), rank)
        carries, nodes = [], []
        for a, b in ((0, e // 3), (e // 3, e // 2), (e // 2, e)):
            carry, (n, _) = fn.run_chunk(carry, pods, types, evk[a:b],
                                         evp[a:b], tp, rank)
            carries.append(te.carry_arrays(carry))
            nodes.append(n.cpu())
        whole = fn(state, pods, types, evk, evp, tp, (0, 11), rank)
        runs.append((carries, torch.cat(nodes), whole))
    (gpu, gpu_nodes, gpu_whole), (cpu, cpu_nodes, _) = runs
    for g, c in zip(gpu, cpu):
        assert g.keys() == c.keys()
        for name in g:
            assert np.array_equal(g[name], c[name]), (label, name)
    assert torch.equal(gpu_nodes, cpu_nodes)
    assert torch.equal(gpu_whole.event_node.cpu(), gpu_nodes)
    assert np.array_equal(gpu_whole.placed_node.cpu().numpy(),
                          gpu[-1]["placed"])


@pytest.mark.cuda
@pytest.mark.parametrize("residency", ["auto", "hbm"])
def test_chunked_run_on_card_matches_unchunked(cuda_device, tmp_path,
                                               residency):
    """run() with checkpoint_every on a 400-pod openb prefix on the card
    equals the one-launch run and the chunked run on the CPU: log without
    [Engine], result; a chunk is one init_tables and one replay launch; a
    run killed after its second checkpoint resumes on the card."""
    import tpusim_torch.io.storage as storage

    nodes, pods = _openb_cut()
    runs = []
    for device, every in (("cuda", 0), ("cuda", 60), ("cpu", 60)):
        sim = Simulator(nodes, SimulatorConfig(
            table_residency=residency, checkpoint_every=every,
            checkpoint_dir=str(tmp_path / device)), device=device)
        sim.set_workload_pods(pods)
        fe.reset_launch_counts()
        sim.run()
        if device == "cuda" and every:
            kernel = he.replay_blocked if residency == "hbm" else fe.replay
            assert kernel.launches == fe.init_tables.launches == 7
        runs.append((sim.last_result, [line for line in sim.log.lines
                                       if "[Engine]" not in line]))
    for res, log in runs[1:]:
        assert log == runs[0][1]
        _same_result(res, runs[0][0])

    real = storage.save_checkpoint
    saves = []

    def killing_save(*a, **k):
        saves.append(real(*a, **k))
        if len(saves) == 2:
            raise KeyboardInterrupt("simulated preemption")
        return saves[-1]

    cfg = SimulatorConfig(table_residency=residency, checkpoint_every=60,
                          checkpoint_dir=str(tmp_path / "kill"))
    storage.save_checkpoint = killing_save
    try:
        sim = Simulator(nodes, cfg, device="cuda")
        sim.set_workload_pods(pods)
        with pytest.raises(KeyboardInterrupt):
            sim.run()
    finally:
        storage.save_checkpoint = real
    sim = Simulator(nodes, cfg, device="cuda")
    sim.set_workload_pods(pods)
    sim.run()
    assert any("resumed replay at event 120/400" in line
               for line in sim.log.lines)
    _same_result(sim.last_result, runs[0][0])


# the record forms (replay_records.cu, replay_blocked_records.cu): (label,
# policies, gpu_sel, blocked); BestFit normalises (the blocked form's drift
# rebuilds)
RECORD_CASES = (
    ("06-FGD/flat", [("FGDScore", 1000)], "FGDScore", False),
    ("06-FGD/blocked", [("FGDScore", 1000)], "FGDScore", True),
    ("PWR+BestFit+FGD/flat", [("PWRScore", 500), ("BestFitScore", 300),
                              ("FGDScore", 200)], "FGDScore", False),
    ("PWR+BestFit+FGD/blocked", [("PWRScore", 500), ("BestFitScore", 300),
                                 ("FGDScore", 200)], "FGDScore", True),
    ("Simon/blocked", [("Simon", 1000)], "best", True),
    ("profile/flat", [("Simon", 1), ("BestFitScore", 1), ("RandomScore", 1),
                      ("DotProductScore", 1), ("FGDScore", 1),
                      ("PWRScore", 1)], "best", False),
    ("Random+random/flat", [("RandomScore", 1000)], "random", False),
    ("BestFit/flat", [("BestFitScore", 1000)], "best", False),
    ("BestFit/blocked", [("BestFitScore", 1000)], "best", True),
)


def _record_spec(device, ctr=(3, 2, 1, 0, 4, 0)):
    from tpusim_torch.sim.records import RecordSpec

    t = torch.tensor(ctr, dtype=torch.int32, device=device)
    return RecordSpec(True, 7, 0, t, ctr[0] + ctr[3] + ctr[4])


def _record_cases(device, policies, gpu_sel):
    """The record card tests' inputs: a seeded 300-node cluster with pinned
    pods and deletes, the openb prefix's first 200 events, and the record
    edge case (chip_smoke.record_edge_case)."""
    from tpusim_torch.sim.table_engine import build_pod_types

    cases = [random_case(53, 300, 160, device)]
    nodes = load_node_csv(os.path.join(
        REPO, "data/csv/openb_node_list_gpu_node.csv"))
    trace = load_pod_csv(os.path.join(
        REPO, "data/csv/openb_pod_list_default.csv"))[:200]
    sim = Simulator(nodes, SimulatorConfig(policies=tuple(policies),
                                           gpu_sel_method=gpu_sel),
                    device=device)
    sim.set_workload_pods(trace)
    sim.set_typical_pods()
    specs = pods_to_specs(trace, sim.node_index, device)
    evk, evp = (torch.as_tensor(a, device=device)
                for a in build_events(trace))
    cases.append((sim.init_state, specs, build_pod_types(specs), evk, evp,
                  sim.typical, sim.rank))
    cases.append(record_edge_case(device))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("label,policies,gpu_sel,blocked", RECORD_CASES,
                         ids=[c[0] for c in RECORD_CASES])
def test_record_forms_match_plain_on_card(cuda_device, label, policies,
                                          gpu_sel, blocked):
    """replay_record and replay_blocked_record against their plain versions
    (CPU copies), tolerance 0 with the counters carried in, the decision
    rows and the samples: on a seeded 300-node cluster with pinned pods and
    deletes, on the openb prefix's first 200 events, and on the record
    edge case (chip_smoke.record_edge_case: 301 nodes, tied totals, fewer
    than three feasible nodes, pinned creates feasible and not, a top-3
    inside one block and across blocks), there also through the chunk
    instantiation with the key out."""
    cfg = fe.make_config(policies, gpu_sel)
    name = "replay_blocked" if blocked else "replay"
    cases = _record_cases(cuda_device, policies, gpu_sel)
    for c, (state, pods, types, evk, evp, tp, rank) in enumerate(cases):
        st, rk = (pad_nodes(state, rank, 128) if blocked else (state, rank))
        tables = fe.init_tables(st, types, tp, cfg)
        for key_out in (False, True) if c == 2 else (False,):
            assert record_against_plain(
                name, (st, pods, types, evk, evp, tp, rk, tables), cfg,
                _record_spec(cuda_device), n_real=state.num_nodes,
                key_out=key_out) == 0, (label, c, key_out)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["counters", "heartbeat"])
@pytest.mark.parametrize("blocked", [False, True], ids=["flat", "blocked"])
def test_counting_record_forms_match_plain_on_card(cuda_device, blocked,
                                                   what):
    """The record forms that take no decision and no sample, against their
    plain versions (CPU copies) under 06-FGD, tolerance 0 with the counters
    carried in: the counters alone, or a heartbeat at stride 5, whose
    ticks from the mapped ring must be the plain loop's. Blocked, this is
    the kCountOnly instantiation (launch_blocked_counting), the heartbeat's
    form at scale; flat, the kRecord one with no decision rows. On the
    seeded cluster, the openb prefix and the record edge case (creates
    with no feasible node, pinned creates that do not fit), each with and
    without the key out."""
    from tpusim_torch.sim.records import RecordSpec

    policies = [("FGDScore", 1000)]
    cfg = fe.make_config(policies, "FGDScore")
    ctr = (3, 2, 1, 0, 4, 0)
    spec = RecordSpec(False, 0, 5 if what == "heartbeat" else 0,
                      torch.tensor(ctr, dtype=torch.int32,
                                   device=cuda_device),
                      ctr[0] + ctr[3] + ctr[4])
    for c, (state, pods, types, evk, evp, tp, rank) in enumerate(
            _record_cases(cuda_device, policies, "FGDScore")):
        st, rk = (pad_nodes(state, rank, 128) if blocked else (state, rank))
        tables = fe.init_tables(st, types, tp, cfg)
        for key_out in (False, True):
            assert record_against_plain(
                "replay_blocked" if blocked else "replay",
                (st, pods, types, evk, evp, tp, rk, tables), cfg, spec,
                n_real=state.num_nodes, key_out=key_out) == 0, (c, key_out)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["linear", "mixed"])
def test_learned_record_forms_match_plain_on_edge_case(cuda_device, family):
    """replay_learned_record and replay_blocked_learned_record against
    their plain versions on the record edge case, tolerance 0 (node
    features at the winner, ties, fewer than three feasible nodes, pinned
    creates), also through the chunk instantiation with the key out."""
    cfg = fe.make_config(_learned_family(
        family if family == "linear" else LEARNED_CASES[2][1]),
        "best" if family == "linear" else LEARNED_CASES[2][2])
    assert cfg.learned
    state, pods, types, evk, evp, tp, rank = record_edge_case(cuda_device)
    for blocked in (False, True):
        st, rk = pad_nodes(state, rank, 128) if blocked else (state, rank)
        tables = fe.init_tables(st, types, tp, cfg)
        for key_out in (False, True):
            assert record_against_plain(
                "replay_blocked" if blocked else "replay",
                (st, pods, types, evk, evp, tp, rk, tables), cfg,
                _record_spec(cuda_device), n_real=state.num_nodes,
                key_out=key_out) == 0, (blocked, key_out)


@pytest.mark.cuda
@pytest.mark.parametrize("label", [c[0] for c in PAST_LIMIT])
def test_record_global_forms_match_plain_on_card(cuda_device, label):
    """The record forms' global instantiations (past the staged limits)
    against their plain versions, flat and blocked, under 06-FGD."""
    i = [c[0] for c in PAST_LIMIT].index(label)
    _, ks, kw, t = PAST_LIMIT[i]
    state, pods, types, evk, evp, tp, rank = typed_case(
        300 + i, 130, ks, kw, t, max(ks + kw, 90), cuda_device, 60)
    cfg = fe.make_config([("FGDScore", 1000)], "FGDScore")
    for name, (st, rk) in (("replay", (state, rank)),
                           ("replay_blocked", pad_nodes(state, rank, 128))):
        tables = fe.init_tables(st, types, tp, cfg)
        assert record_against_plain(
            name, (st, pods, types, evk, evp, tp, rk, tables), cfg,
            _record_spec(cuda_device), n_real=state.num_nodes) == 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True], ids=["flat", "blocked"])
def test_record_chunks_with_key_out_match_plain(cuda_device, blocked):
    """A recording chunked replay (make_table_replay with decisions and the
    series: the record forms with kKeyOut) on the card against the same
    on the CPU: each chunk's carry (counters and key included) and
    records, and the concatenated streams equal one recording launch."""
    from tpusim_torch.sim import table_engine as te

    runs = []
    policies, gpu_sel = (([("RandomScore", 3), ("FGDScore", 1000)], "random")
                         if not blocked else ([("FGDScore", 1000)],
                                              "FGDScore"))
    for dev in (cuda_device, torch.device("cpu")):
        state, pods, types, evk, evp, tp, rank = random_case(61, 256, 300,
                                                             dev)
        fn = te.make_table_replay(policies, gpu_sel, 128 if blocked else -1,
                                  decisions=True, series_every=9)
        e = int(evk.shape[0])
        carry = fn.init_carry(state, pods, types, tp, (0, 13), rank)
        carries, decs, sers = [], [], []
        for a, b in ((0, e // 3), (e // 3, e // 2), (e // 2, e)):
            carry, (_, _, rec) = fn.run_chunk(carry, pods, types, evk[a:b],
                                              evp[a:b], tp, rank)
            carries.append(te.carry_arrays(carry))
            decs.append(rec.dec.cpu())
            sers.append(rec.ser.cpu())
        whole = fn(state, pods, types, evk, evp, tp, (0, 13), rank)
        runs.append((carries, torch.cat(decs), torch.cat(sers), whole))
    (gpu, gdec, gser, gwhole), (cpu, cdec, cser, _) = runs
    for g, c in zip(gpu, cpu):
        for name in g:
            assert np.array_equal(g[name], c[name]), name
    assert torch.equal(gdec, cdec) and torch.equal(gser, cser)
    pol = len(policies)
    order = fe.make_config(policies, gpu_sel).order
    from tpusim_torch.sim.records import decision_rows, sample_rows

    want_dec = decision_rows(gdec.numpy(), pol, order)
    want_ser = sample_rows(gser.numpy(), pol, order)
    for a, b in zip(gwhole.decisions, want_dec):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(gwhole.series, want_ser):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
@pytest.mark.parametrize("residency", ["auto", "hbm"])
def test_heartbeat_ring_ticks_on_card(cuda_device, residency):
    """The kernels' heartbeat: a record launch ticks through the mapped
    ring exactly once a stride crossing (events // every), plus the final
    tick; the same run on the CPU ticks the same count from its loop."""
    from tpusim_torch.obs import heartbeat

    nodes = load_node_csv(os.path.join(
        REPO, "data/csv/openb_node_list_gpu_node.csv"))[:300]
    trace = load_pod_csv(os.path.join(
        REPO, "data/csv/openb_pod_list_default.csv"))[:700]
    counts = []
    for dev in (cuda_device, torch.device("cpu")):
        sim = Simulator(nodes, SimulatorConfig(
            policies=(("FGDScore", 1000),), gpu_sel_method="FGDScore",
            heartbeat_every=50, table_residency=residency,
            report_per_event=False), device=dev)
        sim.set_workload_pods(trace)
        sim.run()
        counts.append(heartbeat.tick_count())
    assert counts == [700 // 50 + 1] * 2


# the learned families (tpusim_torch.learn.policy): the linear one, the
# bucketed one and one mixed with built-ins
LEARNED_CASES = (
    ("linear", "linear", "best"),
    ("bucketed", "bucketed", "best"),
    ("mixed", [("PWRScore", 300), ("LearnedScore[free_gpu_pct]", 40),
               ("LearnedScore[fit_dev_pct]", -12), ("BestFitScore", 200),
               ("LearnedScore[frag_pct]", 9),
               ("LearnedScore[frag_delta]", 600)], "PWRScore"),
)


def _learned_family(spec):
    from tpusim_torch.learn.policy import BUCKETED_FEATURES, learned_policies

    theta = [700, -120, 45, 10, 80, -60, 33, 25, -200, 50]
    if spec == "linear":
        return learned_policies(theta)
    if spec == "bucketed":
        return learned_policies(theta + [15, -25, 35, -45, 55, -65, 75, -85,
                                         95, -105], BUCKETED_FEATURES)
    return spec


@pytest.mark.cuda
@pytest.mark.parametrize("label,family,gpu_sel", LEARNED_CASES,
                         ids=[c[0] for c in LEARNED_CASES])
def test_learned_kernels_match_plain_on_card(cuda_device, label, family,
                                             gpu_sel):
    """The learned instantiations of init_tables, replay and replay_blocked
    against their plain versions on a seeded 300-node cluster with pinned
    pods and deletes, tolerance 0 with the final tables and summaries; the
    lanes forms on two lanes of other weights; the record forms."""
    from tpusim_torch.ops.prng import prng_key

    cfg = fe.make_config(_learned_family(family), gpu_sel)
    assert cfg.learned
    state, pods, types, evk, evp, tp, rank = random_case(
        61, 300, 160, cuda_device)
    for blocked in (False, True):
        st, rk = pad_nodes(state, rank, 128) if blocked else (state, rank)
        tables = fe.init_tables(st, types, tp, cfg)
        _assert_equal(tables, fe.plain_init_tables(st, types, tp, cfg))
        name = "replay_blocked" if blocked else "replay"
        args = (st, pods, types, evk, evp, tp, rk, tables)
        assert against_plain(name, args, cfg, plain_on_cpu=True) == 0
        assert record_against_plain(name, args, cfg,
                                    _record_spec(cuda_device),
                                    n_real=state.num_nodes) == 0
        rows = [[w + 17 * (i + 1) for w in cfg.fam_weights]
                for i in range(2)]
        lanes = [fe.Lane(pods, types.type_id, evk, evp, rk,
                         fe.lane_weights(cfg, row), prng_key(7))
                 for row in rows]
        got = (he.replay_blocked_lanes if blocked else fe.replay_lanes)(
            st, types, tp, tables, cfg, lanes)
        plain = (he.plain_replay_blocked_lanes if blocked
                 else fe.plain_replay_lanes)
        want = plain(to_cpu(st), to_cpu(types), to_cpu(tp), to_cpu(tables),
                     cfg, [fe.Lane(*to_cpu(tuple(lane[:5])), lane.weights,
                                   lane.key) for lane in lanes])
        _assert_equal(tuple(got), tuple(want))


# the forced form's gpu_sel cases: the teacher's policy and gpuSelMethod
# whose recorded nodes it replays
FORCED_TEACHERS = {"best": ("FGDScore", "best"), "worst": ("FGDScore", "worst"),
                   "FGDScore": ("FGDScore", "FGDScore"),
                   "PWRScore": ("PWRScore", "PWRScore"),
                   "DotProductScore": ("DotProductScore", "DotProductScore")}


@pytest.mark.cuda
@pytest.mark.parametrize("t", ("random",) + LEARN_PLAN_COUNTS)
@pytest.mark.parametrize("gpu_sel", list(FORCED_TEACHERS))
def test_replay_forced_matches_plain_on_card(cuda_device, gpu_sel, t):
    """replay_forced against plain_replay_forced (the oracle's step
    functions, CPU copies) on a seeded 200-node cluster with pinned pods
    and deletes ("random"), and on the synthetic cluster of t typical pods
    (chip_smoke.plan_case, whose feature plans have vector loops): the
    argmax, feasible counts and feature rows, recorded nodes from a replay
    of a teacher under `gpu_sel` (its selector's pick at the recorded node
    for FGDScore, PWRScore and DotProductScore), recorded top-3s with a
    -1 and a shifted node."""
    from tpusim_torch.learn.policy import learned_policies

    state, pods, types, evk, evp, tp, rank = (
        random_case(67, 200, 120, cuda_device) if t == "random"
        else plan_case(t, cuda_device))
    policy, teacher_sel = FORCED_TEACHERS[gpu_sel]
    teacher = fe.make_config([(policy, 1000)], teacher_sel)
    res = fe.replay(state, pods, types, evk, evp, tp, rank,
                    fe.init_tables(state, types, tp, teacher), teacher)
    rec = res.event_node.clone()
    topk = torch.stack([rec, torch.roll(rec, 1), torch.full_like(rec, -1)],
                       1).contiguous()
    cfg = fe.make_config(learned_policies(
        [700, -120, 45, 10, 80, -60, 33, 25, -200, 50]), "best")
    tables = fe.init_tables(state, types, tp, cfg)
    got = fe.replay_forced(state, pods, types, evk, evp, tp, rank, tables,
                           cfg, rec, topk, gpu_sel)
    want = fe.plain_replay_forced(*to_cpu((state, pods, evk, evp, tp, rank)),
                                  cfg, rec.cpu(), topk.cpu(), gpu_sel)
    _assert_equal(got, want)
