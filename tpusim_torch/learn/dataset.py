"""Decision logs -> imitation data for the learned policy (counterpart of
tpusim/learn/dataset.py; `imitate`).

A decision log names, per create event, the teacher's chosen node and its
top-K runner-ups. What it lacks are the per-node feature rows the learned
policy scores with; TeacherReplay rebuilds them by teacher-forcing the
trace: one replay binds every create to the RECORDED node (the teacher's
state trajectory, the device picked as the recorded gpuSelMethod picks),
and at each create emits the feature rows of the recorded winner and
runner-ups, the feasible count, and the learned family's own argmax (and
its row) at the teacher's state under a parameter vector theta.

On the card that replay is one launch of the `replay_forced` kernel
(kernels/replay_forced.cu, sim/fused_engine.py replay_forced) over tables
built once: theta is an operand, so `agreement` over many candidate vectors
reuses one build. On the CPU it is the kernel's plain version, a loop over
the sequential oracle's step functions.

Sanity contract: at every create event the rebuilt feasible count must
equal the recorded one; a mismatch means the trace or the prep options do
not match the log, and raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusim_torch.learn.policy import (
    LINEAR_FEATURES,
    learned_policies,
    parse_learned_name,
)
from tpusim_torch.obs.decisions import DECISION_TOPK

DATASET_GPU_SEL = ("best", "worst") + (
    # a selector's device pick is its column at the recorded node; per-event
    # randomness is not reproduced (the log does not carry the draws)
    "FGDScore", "PWRScore", "DotProductScore")


@dataclass
class ImitationPairs:
    """The (feature-row, chosen-node, runner-up) tuples of one log: pair i
    says the teacher ranked pos[i] above neg[i], strictly where tie[i] is
    False, equal (decided by the tie-break rank) where True. Rows whose
    winner and runner-up carry identical features are dropped."""

    features: Tuple[str, ...]
    pos: np.ndarray  # f64[M, F] winner feature rows
    neg: np.ndarray  # f64[M, F] runner-up feature rows
    event: np.ndarray  # i64[M] source event index of each pair
    tie: np.ndarray  # bool[M] teacher totals tied (rank-decided pair)


class TeacherReplay:
    """One decision log and its trace, ready for feature extraction and
    teacher-forced evaluation on `device` ("cuda" by default: the
    replay_forced kernel; "cpu": its plain version)."""

    def __init__(self, nodes, pods, header: dict, rows: List[dict],
                 features: Sequence[str] = LINEAR_FEATURES,
                 gpu_sel: str = "", seed: Optional[int] = None,
                 device="cuda"):
        from tpusim_torch.io.trace import (
            build_events,
            nodes_to_state,
            pods_to_specs,
            tiebreak_rank,
        )
        from tpusim_torch.sim.fused_engine import make_config
        from tpusim_torch.sim.table_engine import build_pod_types
        from tpusim_torch.sim.typical import (
            TypicalPodsConfig,
            get_typical_pods,
            pad_typical_pods,
        )

        meta = header.get("meta") or {}
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the teacher-forced replay runs "
                "its CUDA kernel on a GPU; pass device='cpu' for its plain "
                "version")
        self.features = tuple(features)
        self.policies = learned_policies(features=self.features)
        self.gpu_sel = gpu_sel or str(meta.get("gpu_sel", "best"))
        if self.gpu_sel not in DATASET_GPU_SEL:
            raise ValueError(
                f"gpu_sel {self.gpu_sel!r} cannot be replayed from a "
                "decision log (per-event random device draws are not "
                f"recorded); supported: {', '.join(DATASET_GPU_SEL)}")
        self.seed = int(meta.get("seed", 42) if seed is None else seed)

        node_index = {n.name: i for i, n in enumerate(nodes)}
        dev = self.device
        self.state0 = nodes_to_state(nodes, dev)
        self.specs = pods_to_specs(pods, node_index, dev)
        ev_kind, ev_pod = build_events(pods, False)
        if len(ev_kind) != len(rows):
            raise ValueError(
                f"decision log has {len(rows)} events but the trace "
                f"builds {len(ev_kind)} — wrong trace or prep options "
                "(max_pods / shuffle must match the recorded run)")
        self.ev_kind = np.asarray(ev_kind, np.int32)
        self.ev_pod = np.asarray(ev_pod, np.int32)
        self.rec_node = np.asarray([r["node"] for r in rows], np.int32)
        self.rec_feas = np.asarray([r["feasible"] for r in rows], np.int32)
        topk = np.full((len(rows), DECISION_TOPK), -1, np.int32)
        topk_total = np.zeros((len(rows), DECISION_TOPK), np.int64)
        for i, r in enumerate(rows):
            for j, (n, t, _rk) in enumerate(r.get("topk", [])):
                if j < DECISION_TOPK:
                    topk[i, j] = int(n)
                    topk_total[i, j] = int(t)
        self.topk = topk
        self.topk_total = topk_total
        # the recorded run's typical-pod distribution (Simulator.
        # set_typical_pods: histogram, then zero-frequency padding)
        self.typical = pad_typical_pods(
            get_typical_pods(pods, TypicalPodsConfig(), dev)[0])
        n = self.state0.num_nodes
        self.rank = torch.as_tensor(tiebreak_rank(n, self.seed),
                                    device=dev)
        self.config = make_config(self.policies, "best")
        self.types = build_pod_types(self.specs)
        self._t = {name: torch.as_tensor(x, device=dev) for name, x in (
            ("ev_kind", self.ev_kind), ("ev_pod", self.ev_pod),
            ("rec_node", self.rec_node), ("rec_topk", self.topk))}
        self._tables = None  # built once, on the first card run
        self._cache = None  # (theta tuple) -> host outputs of the last run
        self.runs = 0  # teacher-forced replays run

    def _run(self, theta) -> tuple:
        from tpusim_torch.sim import fused_engine as fe

        key = tuple(int(t) for t in theta)
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        cfg = fe.with_weights(self.config, key)
        if self.device.type == "cuda" and self._tables is None:
            self._tables = fe.init_tables(self.state0, self.types,
                                          self.typical, cfg)
        out = fe.replay_forced(
            self.state0, self.specs, self.types, self._t["ev_kind"],
            self._t["ev_pod"], self.typical, self.rank, self._tables, cfg,
            self._t["rec_node"], self._t["rec_topk"], self.gpu_sel)
        self.runs += 1
        host = tuple(x.cpu().numpy() for x in out)
        self._cache = (key, host)
        return host

    def _check_feasible(self, feas: np.ndarray):
        creates = self.ev_kind == 0
        bad = creates & (feas != self.rec_feas)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"event {i}: reconstructed feasible count {int(feas[i])} "
                f"!= recorded {int(self.rec_feas[i])} — the trace/config "
                "does not match the decision log")

    def pairs(self) -> ImitationPairs:
        """One (winner, runner-up) pair per recorded runner-up of every
        successful create; pairs whose teacher totals tied carry tie=True.
        Identical-feature rows are dropped."""
        theta0 = [w for _, w in self.policies]
        feats, feas, _, _ = self._run(theta0)
        self._check_feasible(feas)
        pos, neg, evs, ties = [], [], [], []
        creates = np.flatnonzero((self.ev_kind == 0) & (self.rec_node >= 0))
        for i in creates:
            if self.topk[i, 0] < 0:
                continue
            win = feats[i, 0].astype(np.float64)
            for j in range(1, self.topk.shape[1]):
                if self.topk[i, j] < 0:
                    continue
                run = feats[i, j].astype(np.float64)
                if np.array_equal(win, run):
                    continue
                pos.append(win)
                neg.append(run)
                evs.append(i)
                ties.append(
                    bool(self.topk_total[i, j] == self.topk_total[i, 0]))
        f = len(self.features)
        return ImitationPairs(
            features=self.features,
            pos=(np.stack(pos) if pos else np.zeros((0, f))),
            neg=(np.stack(neg) if neg else np.zeros((0, f))),
            event=np.asarray(evs, np.int64),
            tie=np.asarray(ties, bool))

    def mined_pairs(self, theta, end_event: Optional[int] = None
                    ) -> ImitationPairs:
        """Hard negatives under `theta`: wherever the learned argmax
        differs from the teacher's choice (before `end_event`), a
        (teacher-winner, learned-pick) pair; identical-feature mismatches
        are dropped."""
        feats, feas, pick, pick_feats = self._run(theta)
        self._check_feasible(feas)
        end = len(self.ev_kind) if end_event is None else int(end_event)
        pos, neg, evs = [], [], []
        creates = np.flatnonzero(
            (self.ev_kind[:end] == 0) & (self.rec_node[:end] >= 0))
        for i in creates:
            if pick[i] < 0 or pick[i] == self.rec_node[i]:
                continue
            win = feats[i, 0].astype(np.float64)  # topk[0] is the winner
            run = pick_feats[i].astype(np.float64)
            if self.topk[i, 0] < 0 or np.array_equal(win, run):
                continue
            pos.append(win)
            neg.append(run)
            evs.append(i)
        f = len(self.features)
        return ImitationPairs(
            features=self.features,
            pos=(np.stack(pos) if pos else np.zeros((0, f))),
            neg=(np.stack(neg) if neg else np.zeros((0, f))),
            event=np.asarray(evs, np.int64),
            tie=np.zeros(len(evs), bool))

    def agreement(self, theta, start_event: int = 0,
                  end_event: Optional[int] = None) -> dict:
        """Teacher-forced top-1 agreement of integer theta over the
        events in [start_event, end_event): {'matches', 'creates',
        'agreement'}; runs the feasible-count check."""
        feats, feas, pick, _ = self._run(theta)
        self._check_feasible(feas)
        creates = (self.ev_kind == 0) & (self.rec_node >= 0)
        creates[:start_event] = False
        if end_event is not None:
            creates[int(end_event):] = False
        n = int(creates.sum())
        m = int((pick[creates] == self.rec_node[creates]).sum())
        return {
            "matches": m,
            "creates": n,
            "agreement": (m / n) if n else 1.0,
        }


def concat_pairs(parts: Sequence[ImitationPairs]) -> ImitationPairs:
    parts = [p for p in parts if p.pos.shape[0]]
    if not parts:
        raise ValueError("no imitation pairs to train on")
    return ImitationPairs(
        features=parts[0].features,
        pos=np.concatenate([p.pos for p in parts]),
        neg=np.concatenate([p.neg for p in parts]),
        event=np.concatenate([p.event for p in parts]),
        tie=np.concatenate([p.tie for p in parts]))


def imitate_with_mining(replay: TeacherReplay, cfg=None,
                        end_event: Optional[int] = None,
                        rounds: int = 6, out=None):
    """The imitation recipe (`imitate`): fit on the recorded pairs, then
    alternate train -> mine hard negatives on the training prefix
    `end_event` -> retrain, until agreement stops improving or `rounds`
    run out; then zero small weights greedily while train agreement holds.
    Returns (theta float64, theta_i32 list, per-round train agreement)."""
    from tpusim_torch.learn.loop import project_theta, run_imitation

    end = len(replay.ev_kind) if end_event is None else int(end_event)
    base = replay.pairs()
    keep = base.event < end
    pool = [ImitationPairs(base.features, base.pos[keep], base.neg[keep],
                           base.event[keep], base.tie[keep])]
    best = None  # (agreement, theta_f, theta_i32)
    history = []
    # the i32 export is tried at several projection scales: a small one
    # rounds near-zero nuisance weights to 0, a large one keeps resolution
    scales = (25, 100, 1000, 4000)
    for r in range(max(rounds, 1)):
        theta_f, _ = run_imitation(concat_pairs(pool), cfg)
        round_best = None
        for s in scales:
            cand = project_theta(theta_f, s)
            rep = replay.agreement(cand, end_event=end)
            if round_best is None or rep["agreement"] > round_best[0][
                    "agreement"]:
                round_best = (rep, cand)
        train_rep, theta = round_best
        history.append(train_rep["agreement"])
        if out is not None:
            print(
                f"[imitate] round {r}: {concat_pairs(pool).pos.shape[0]} "
                f"pairs, train agreement "
                f"{100 * train_rep['agreement']:.2f}%", file=out)
        if best is None or train_rep["agreement"] > best[0]:
            best = (train_rep["agreement"], theta_f, theta)
        if train_rep["matches"] == train_rep["creates"]:
            break
        mined = replay.mined_pairs(theta, end_event=end)
        if mined.pos.shape[0] == 0:
            break  # every remaining miss is a feature tie (rank-owned)
        pool.append(mined)
    # greedy sparsification: zero each weight (ascending magnitude) while
    # train agreement does not drop
    theta = list(best[2])
    score = best[0]
    order = sorted((j for j in range(len(theta)) if theta[j] != 0),
                   key=lambda j: abs(theta[j]))
    for j in order:
        cand = list(theta)
        cand[j] = 0
        if not any(cand):
            continue
        rep = replay.agreement(cand, end_event=end)
        if rep["agreement"] >= score:
            theta, score = cand, rep["agreement"]
    if out is not None and score > best[0]:
        print(f"[imitate] sparsified: train agreement "
              f"{100 * score:.2f}%", file=out)
    return best[1], theta, history


def load_teacher_log(path: str):
    """(header, rows) of a decision JSONL, verified (digest, schema) and
    checked to hold successful create events."""
    from tpusim_torch.obs.decisions import read_decisions

    header, rows = read_decisions(path)
    if not any(r["kind"] == 0 and r["node"] >= 0 for r in rows):
        raise ValueError(
            f"{path}: no successful create events — nothing to imitate")
    return header, rows


def feature_names_of(policies) -> Tuple[str, ...]:
    """The feature vocabulary of a learned policy family; raises on a mixed
    or non-learned family."""
    feats = []
    for name, _ in policies:
        f = parse_learned_name(str(name))
        if f is None:
            raise ValueError(
                f"{name!r} is not a learned-policy member (want "
                "LearnedScore[<feature>] names)")
        feats.append(f)
    return tuple(feats)
