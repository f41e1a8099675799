"""Scalarized tuning objective over sweep-lane outputs (counterpart of
tpusim/learn/objective.py).

The paper's own quality metrics are the objective: GPU allocation up, FGD
fragmentation down, unscheduled pods bounded. Every term is on a SweepLane
(sim/driver.py schedule_pods_sweep), so one rollout yields the scalar

    J(w) = w_alloc * gpu_alloc_pct
         - w_frag  * frag_pct           (frag gpu-milli / cluster GPU milli)
         - w_unsched * unsched_pct      (unscheduled pods / trace pods)
         - w_disrupt * disrupt_pct      (pods lost to disruption / pods)

All terms are percentages. The term dicts and their JSON bytes are
tpusim's, so a tuning log either package began, the other continues.

The optional robustness evaluator re-runs a candidate through
`Simulator.run_with_faults` under one seeded fault schedule and scores the
same objective on the faulted outcome.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ObjectiveConfig:
    """Term weights of the scalarized objective (all terms in percent).
    w_disrupt charges pods permanently lost to disruption; 0 keeps the
    fault-free log header's bytes."""

    w_alloc: float = 1.0
    w_frag: float = 1.0
    w_unsched: float = 1.0
    w_disrupt: float = 0.0

    def canonical(self) -> list:
        """Deterministic JSON form for the tuning-log header; the
        disruption weight joins only when non-zero."""
        base = [float(self.w_alloc), float(self.w_frag),
                float(self.w_unsched)]
        if self.w_disrupt:
            base.append(float(self.w_disrupt))
        return base


def lane_terms(lane) -> dict:
    """SweepLane -> the objective's term dict: plain ints and floats,
    JSON-stable."""
    from tpusim_torch.constants import MILLI

    pn = np.asarray(lane.placed_node, np.int32)
    dm = np.asarray(lane.dev_mask, bool)
    h = hashlib.sha256()
    h.update(pn.tobytes())
    h.update(dm.tobytes())
    dis = getattr(lane, "disruption", None)
    return {
        "weights": [int(w) for w in lane.weights],
        "seed": int(lane.seed),
        "events": int(lane.events),
        "pods": int(pn.shape[0]),
        "placed": int(lane.placed),
        "failed": int(lane.failed),
        "unscheduled": int(lane.unscheduled),
        # chaos-sweep lanes: pods terminally lost to disruption and the
        # evictions; 0 on fault-free lanes
        "disrupted": int(dis.unscheduled_after_retries) if dis else 0,
        "evicted": int(dis.evicted_pods) if dis else 0,
        "gpu_total_milli": int(
            np.asarray(lane.state.gpu_cnt, np.int64).sum()) * MILLI,
        "gpu_alloc_pct": float(lane.gpu_alloc_pct),
        "frag_gpu_milli": float(lane.frag_gpu_milli),
        "placements_sha256": h.hexdigest(),
    }


def terms_from_result(doc: dict) -> dict:
    """A result document (the service's summarize_lane form) -> the term
    dict lane_terms builds."""
    return {
        "weights": [int(w) for w in doc["weights"]],
        "seed": int(doc["seed"]),
        "events": int(doc["events"]),
        "pods": int(doc["pods"]),
        "placed": int(doc["placed"]),
        "failed": int(doc["failed"]),
        "unscheduled": int(doc["unscheduled"]),
        "disrupted": int(doc.get("disrupted", 0)),
        "evicted": int(doc.get("evicted", 0)),
        "gpu_total_milli": int(doc["gpu_total_milli"]),
        "gpu_alloc_pct": float(doc["gpu_alloc_pct"]),
        "frag_gpu_milli": float(doc["frag_gpu_milli"]),
        "placements_sha256": str(doc["placements_sha256"]),
    }


def scalarize(terms: dict, cfg: ObjectiveConfig = None) -> float:
    """One term dict -> the scalar objective J(w) (maximize)."""
    cfg = cfg or ObjectiveConfig()
    frag_pct = 100.0 * terms["frag_gpu_milli"] / max(
        terms["gpu_total_milli"], 1)
    unsched_pct = 100.0 * terms["unscheduled"] / max(terms["pods"], 1)
    disrupt_pct = 100.0 * terms.get("disrupted", 0) / max(terms["pods"], 1)
    return (
        cfg.w_alloc * terms["gpu_alloc_pct"]
        - cfg.w_frag * frag_pct
        - cfg.w_unsched * unsched_pct
        - cfg.w_disrupt * disrupt_pct
    )


def terms_from_simulate(res, total_gpu_milli: int, typical) -> dict:
    """SimulateResult -> the same term vocabulary, for runs outside the
    sweep (the robustness evaluator's run_with_faults outcome): the
    allocation and frag total of the final state, as the sweep lanes
    compute them."""
    from tpusim_torch.constants import MILLI, Q3_SATISFIED
    from tpusim_torch.ops.frag import cluster_frag_report
    from tpusim_torch.types import NodeState

    st = NodeState(*(a.cpu() for a in res.state))
    gpu_left, gpu_cnt = st.gpu_left.numpy(), st.gpu_cnt.numpy()
    slot = np.arange(gpu_left.shape[1])[None, :] < gpu_cnt[:, None]
    # DOWN nodes park at mem_left -1 with gpu_left zeroed: their slots
    # read as allocated (capacity lost to faults is not free capacity)
    denom = max(int(gpu_cnt.sum()) * MILLI, 1)
    alloc = 100.0 * float(np.where(slot, MILLI - gpu_left, 0).sum()) / denom
    tp = type(typical)(*(a.cpu() for a in typical))
    amounts = np.asarray(cluster_frag_report(st, tp)[0], np.float32)
    pn = np.asarray(res.placed_node, np.int32)
    return {
        "weights": [],  # stamped by the caller (the candidate's vector)
        "seed": -1,
        "events": int(res.events),
        "pods": int(pn.shape[0]),
        "placed": int((pn >= 0).sum()),
        "failed": len(res.unscheduled_pods),
        "unscheduled": len(res.unscheduled_pods),
        "gpu_total_milli": int(total_gpu_milli),
        "gpu_alloc_pct": alloc,
        "frag_gpu_milli": float(amounts.sum(-1) - amounts[Q3_SATISFIED]),
        "placements_sha256": hashlib.sha256(pn.tobytes()).hexdigest(),
    }


def make_robust_eval(nodes, workload_pods, policies, fault_cfg,
                     base_cfg=None, device="cuda"):
    """The optional per-generation robustness evaluator: a callable
    (weights) -> terms that replays the workload through
    `run_with_faults` with the candidate weights in a fresh Simulator
    config, under the same seeded fault schedule every generation, on
    `device`."""
    from tpusim_torch.sim.driver import Simulator, SimulatorConfig

    base = base_cfg or SimulatorConfig()

    def evaluate(weights) -> dict:
        cfg = SimulatorConfig(
            policies=tuple(
                (name, int(w)) for (name, _), w in zip(policies, weights)),
            gpu_sel_method=base.gpu_sel_method,
            norm_method=base.norm_method,
            dim_ext_method=base.dim_ext_method,
            engine=base.engine,
            seed=base.seed,
            report_per_event=False,
            shuffle_pod=False,
        )
        sim = Simulator(nodes, cfg, device=device)
        sim.set_workload_pods(list(workload_pods))
        res = sim.run_with_faults(fault_cfg)
        terms = terms_from_simulate(res, sim.node_total_milli_gpu,
                                    sim.typical)
        terms["weights"] = [int(w) for w in weights]
        terms["seed"] = int(base.seed)
        return terms

    return evaluate
