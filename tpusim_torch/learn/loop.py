"""The tuning loop: optimizer-in-the-loop over the vectorized sweep
(counterpart of tpusim/learn/loop.py; `tune` and `imitate`).

Each generation: ask the optimizer for a float population, project it
onto the replays' i32 weight space, dedup integer collisions, roll the
unique candidates out through ONE backend call (a lanes launch of the
replay kernels, learn.rollout), scalarize (learn.objective), tell the
optimizer, and append a generation record to the tuning log.

The log is digest-signed JSONL (io.storage.write_signed_jsonl — the
decisions-file torn-write discipline): a header naming the trajectory-
defining config, then one record per generation carrying the full
population, the unique rollouts' term dicts, every candidate's
objective, the best-so-far, and the optimizer's complete state. It is
the loop's only state: `resume=True` restores the optimizer from the
last record and continues — and because generation-g draws are a pure
function of (seed, g), the resumed run's log is BYTE-identical to an
uninterrupted one. Everything written is deterministic (sorted keys, no
walls, no paths, no backend identity), so the log's bytes are tpusim's
under the same seed, and either package resumes a log the other began.

The final held-out report replays tuned-vs-default on a trace suffix
the optimizer never saw (one 2-lane sweep) — the generalization check
that the tuned vector beats the paper-default weights off its own
training data.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from tpusim_torch.learn.cma import DiagonalCMA
from tpusim_torch.learn.es import OpenAIES
from tpusim_torch.learn.objective import ObjectiveConfig, lane_terms, scalarize
from tpusim_torch.learn.rollout import dedup_rows, project_weights

LOG_SCHEMA = "tpusim-tune-log/1"


@dataclass
class TuneConfig:
    """Knobs of one tuning run. Everything here except `generations`
    defines the trajectory and lands in the log header (a resumed run
    must match it exactly); `generations` is only the stopping point —
    extending a finished run is a legitimate resume."""

    algo: str = "es"  # es | cma
    generations: int = 10
    popsize: int = 8
    sigma: float = 250.0
    lr: float = 300.0  # es only (cma adapts its own step sizes)
    seed: int = 0  # optimizer draw seed
    eval_seed: int = 42  # replay seed every candidate shares (common
    # random numbers — candidates differ by weights only)
    w_lo: int = 0
    w_hi: int = 4000
    objective: ObjectiveConfig = field(default_factory=ObjectiveConfig)

    def canonical(self, policies) -> dict:
        """The log-header form: trajectory-defining knobs only, JSON-
        deterministic. No backend identity, no paths, no generation
        count — local/remote and short/extended runs must share it."""
        return {
            "algo": self.algo,
            "popsize": int(self.popsize),
            "sigma": float(self.sigma),
            "lr": float(self.lr),
            "seed": int(self.seed),
            "eval_seed": int(self.eval_seed),
            "w_lo": int(self.w_lo),
            "w_hi": int(self.w_hi),
            "objective": self.objective.canonical(),
            "policies": [[str(n), int(w)] for n, w in policies],
        }


@dataclass
class TuneResult:
    best_weights: List[int]
    best_objective: float
    records: List[dict]
    log_path: str
    report: Optional[dict] = None


def make_optimizer(cfg: TuneConfig, x0):
    if cfg.algo == "es":
        return OpenAIES(x0, sigma=cfg.sigma, lr=cfg.lr,
                        popsize=cfg.popsize, seed=cfg.seed)
    if cfg.algo == "cma":
        return DiagonalCMA(x0, sigma=cfg.sigma, popsize=cfg.popsize,
                           seed=cfg.seed)
    raise ValueError(f"unknown algo {cfg.algo!r}: expected es | cma")


def write_log(log_path: str, header_cfg: dict, records: List[dict]) -> str:
    """Rewrite the whole signed log atomically (records are small — a
    few KB per generation; rewriting keeps the signature covering every
    line, so a torn tail can never read back as a shorter valid run)."""
    from tpusim_torch.io import storage

    header = {"schema": LOG_SCHEMA, "config": header_cfg}
    lines = [
        json.dumps(r, sort_keys=True, separators=(",", ":"))
        for r in records
    ]
    return storage.write_signed_jsonl(log_path, header, lines)


def read_log(log_path: str):
    """(header, records) from a tuning log; torn/edited files raise."""
    from tpusim_torch.io import storage

    header, payload = storage.read_signed_jsonl(log_path, LOG_SCHEMA)
    return header, [json.loads(line) for line in payload]


def run_tune(backend, policies, cfg: TuneConfig, log_path: str,
             resume: bool = False, robust_eval=None, robust_meta=None,
             train_fault_meta=None, out=None) -> TuneResult:
    """The generation loop (see module docstring). `backend` is a
    learn.rollout backend; `robust_eval` an optional callable
    (weights) -> terms re-running the generation's best candidate under
    injected faults (objective.make_robust_eval) — logged, never fed
    back into the optimizer (disruption robustness is a report by
    default; `tune --train-fault-*` instead rolls the whole
    population through the chaos sweep so w_disrupt trains directly).
    `robust_meta` / `train_fault_meta` describe the
    evaluator's / training schedule's knobs for the log header:
    both shape the log's bytes, so a resume that toggles or retunes
    them must fail the config check instead of appending records of a
    different shape."""
    header_cfg = cfg.canonical(policies)
    if (robust_eval is not None) or (robust_meta is not None):
        header_cfg["robust"] = robust_meta if robust_meta is not None \
            else True
    if train_fault_meta is not None:
        header_cfg["train_fault"] = train_fault_meta
    x0 = np.asarray([float(w) for _, w in policies], np.float64)
    opt = make_optimizer(cfg, x0)

    records: List[dict] = []
    start_gen = 0
    if resume and os.path.isfile(log_path):
        header, records = read_log(log_path)
        if header.get("config") != header_cfg:
            raise ValueError(
                f"{log_path}: existing log was tuned under a different "
                "config — resume needs identical algo/popsize/sigma/lr/"
                "seed/bounds/objective/policies/robust knobs (delete the "
                "log or match the flags)"
            )
        if records:
            opt.load_state(records[-1]["state"])
            start_gen = int(records[-1]["gen"]) + 1
            if out is not None:
                print(
                    f"[tune] resumed at generation {start_gen} from "
                    f"{log_path}", file=out,
                )

    best_obj = -float("inf")
    best_w: List[int] = [int(w) for _, w in policies]
    for r in records:
        if r["best"]["objective"] > best_obj:
            best_obj = r["best"]["objective"]
            best_w = list(r["best"]["weights"])

    for gen in range(start_gen, cfg.generations):
        xs = opt.ask(gen)
        rows = project_weights(xs, cfg.w_lo, cfg.w_hi)
        uniq, where = dedup_rows(rows)
        terms = backend.rollout(uniq, cfg.eval_seed)
        objs_u = [scalarize(t, cfg.objective) for t in terms]
        objs = [objs_u[where[i]] for i in range(cfg.popsize)]
        opt.tell(gen, np.asarray(objs, np.float64))

        gi = int(np.argmax(objs_u))
        gen_best = {"weights": list(uniq[gi]), "objective": objs_u[gi]}
        if gen_best["objective"] > best_obj:
            best_obj = gen_best["objective"]
            best_w = list(uniq[gi])

        rec = {
            "gen": gen,
            "population": [[int(w) for w in row] for row in rows],
            "unique": [list(u) for u in uniq],
            "candidate_unique": list(where),
            "terms": terms,
            "objectives": objs,
            "gen_best": gen_best,
            "best": {"weights": list(best_w), "objective": best_obj},
            "state": opt.state_dict(),
        }
        if robust_eval is not None:
            rterms = robust_eval(gen_best["weights"])
            rec["robust"] = {
                "terms": rterms,
                "objective": scalarize(rterms, cfg.objective),
            }
        records.append(rec)
        write_log(log_path, header_cfg, records)
        if out is not None:
            line = (
                f"[tune] gen {gen:>3}: best {gen_best['objective']:+.4f} "
                f"(weights {','.join(str(w) for w in gen_best['weights'])})"
                f"  best-so-far {best_obj:+.4f}"
                f"  [{len(uniq)}/{cfg.popsize} unique]"
            )
            if "robust" in rec:
                line += f"  robust {rec['robust']['objective']:+.4f}"
            print(line, file=out)

    return TuneResult(
        best_weights=list(best_w), best_objective=best_obj,
        records=records, log_path=log_path,
    )


# ---------------------------------------------------------------------------
# Supervised imitation of a teacher policy
# ---------------------------------------------------------------------------


@dataclass
class ImitateConfig:
    """Knobs of the imitation trainer: full-batch Adam on the pairwise
    ranking loss over (winner, runner-up) feature rows. Pure numpy
    float64 — deterministic for a fixed seed, no device round trips
    (the data is a few thousand tiny rows).

    tie_w weighs the TIE-preservation term: pairs the teacher decided
    by rank (equal teacher totals) contribute (theta . d)^2 — breaking
    a teacher tie with an irrelevant feature overrides the rank order
    the engines reproduce for free, and is the dominant way a blended
    theta loses top-1 agreement."""

    steps: int = 500
    lr: float = 0.15
    l2: float = 1e-4
    tie_w: float = 1.0
    seed: int = 0
    theta_hi: int = 4000  # |theta| bound of the i32 export


def project_theta(theta, hi: int = 4000) -> List[int]:
    """Float parameters -> the engines' i32 operand space. The argmax is
    scale-invariant, so the vector is rescaled to fill [-hi, hi] before
    rounding — the export keeps as much ranking resolution as the i32
    vocabulary allows."""
    theta = np.asarray(theta, np.float64)
    m = float(np.max(np.abs(theta))) if theta.size else 0.0
    scale = (hi / m) if m > 0 else 1.0
    return [int(t) for t in
            np.clip(np.rint(theta * scale), -hi, hi).astype(np.int64)]


def run_imitation(pairs, cfg: ImitateConfig = None, out=None):
    """Train theta on the pairwise constraints of a teacher log:

      strict pairs (teacher totals differed)
          softplus(-(theta . d))      -- rank pos above neg
      tie pairs (teacher decided by rank)
          tie_w * (theta . d)^2       -- PRESERVE the tie

    with d = x_pos - x_neg, plus l2 |theta|^2. Returns (theta
    float64[F], theta_i32 list) — the i32 export is what replays (and
    what the agreement metric scores). Identical-feature rows never
    reach here (TeacherReplay.pairs drops them; the engines' shared
    tie-break rank reproduces those decisions for free)."""
    cfg = cfg or ImitateConfig()
    pos = np.asarray(pairs.pos, np.float64)
    neg = np.asarray(pairs.neg, np.float64)
    tie = np.asarray(
        getattr(pairs, "tie", np.zeros(pos.shape[0], bool)), bool
    )
    if pos.shape[0] == 0:
        raise ValueError(
            "no trainable imitation pairs (every recorded runner-up "
            "tied the winner feature-for-feature)"
        )
    # features live in [0, 100]; train at unit scale for conditioning
    d = (pos[~tie] - neg[~tie]) / 100.0  # [Ms, F] strict
    dt = (pos[tie] - neg[tie]) / 100.0  # [Mt, F] tie-preserving
    f = pos.shape[1]
    rng = np.random.default_rng(cfg.seed)
    theta = 0.01 * rng.standard_normal(f)
    m1 = np.zeros(f)
    m2 = np.zeros(f)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, cfg.steps + 1):
        grad = 2.0 * cfg.l2 * theta
        z = np.zeros(0)
        if d.shape[0]:
            z = d @ theta
            sig = 1.0 / (1.0 + np.exp(np.clip(z, -60, 60)))  # sigma(-z)
            grad = grad - (sig[:, None] * d).mean(0)
        if dt.shape[0]:
            zt = dt @ theta
            grad = grad + 2.0 * cfg.tie_w * (zt[:, None] * dt).mean(0)
        m1 = b1 * m1 + (1 - b1) * grad
        m2 = b2 * m2 + (1 - b2) * grad * grad
        mh = m1 / (1 - b1 ** t)
        vh = m2 / (1 - b2 ** t)
        theta = theta - cfg.lr * mh / (np.sqrt(vh) + eps)
        if out is not None and (t % max(cfg.steps // 5, 1) == 0):
            loss = float(np.mean(np.logaddexp(0.0, -z))) if z.size else 0.0
            acc = float((z > 0).mean()) if z.size else 1.0
            print(
                f"[imitate] step {t:>5}: loss {loss:.4f}  pairwise "
                f"acc {acc:.3f}", file=out,
            )
    # rescale back to the raw-feature space before the i32 export (the
    # /100 training scale cancels in the argmax either way)
    return theta / 100.0, project_theta(theta, cfg.theta_hi)


# ---------------------------------------------------------------------------
# Held-out report: tuned vs paper-default on the trace suffix
# ---------------------------------------------------------------------------


def holdout_report(eval_sim, policies, tuned_weights,
                   objective: ObjectiveConfig = None,
                   eval_seed: int = 42, bucket: int = 512) -> dict:
    """Replay tuned-vs-default weight vectors over `eval_sim`'s workload
    (the held-out trace suffix) in one 2-lane sweep and scalarize both.
    Returns {"tuned": terms+objective, "default": ..., "improvement"}."""
    objective = objective or ObjectiveConfig()
    default_w = [int(w) for _, w in policies]
    rows = np.asarray([list(tuned_weights), default_w], np.int32)
    lanes = eval_sim.run_sweep(
        rows, seeds=[int(eval_seed)] * 2, bucket=bucket
    )
    out = {}
    for label, lane in zip(("tuned", "default"), lanes):
        terms = lane_terms(lane)
        out[label] = dict(terms, objective=scalarize(terms, objective))
    out["improvement"] = out["tuned"]["objective"] - out["default"]["objective"]
    return out


def format_holdout_report(report: dict, policies) -> str:
    """Terminal table of the held-out comparison — the `tune`
    epilogue."""
    names = ",".join(n for n, _ in policies)
    head = (
        f"{'config':<9} {'weights(' + names + ')':<32} {'placed':>7} "
        f"{'unsched':>8} {'gpu_alloc%':>10} {'frag_gpu_milli':>15} "
        f"{'objective':>11}"
    )
    rows = [head, "-" * len(head)]
    for label in ("tuned", "default"):
        t = report[label]
        rows.append(
            f"{label:<9} {','.join(str(w) for w in t['weights']):<32} "
            f"{t['placed']:>7} {t['unscheduled']:>8} "
            f"{t['gpu_alloc_pct']:>10.2f} {t['frag_gpu_milli']:>15.0f} "
            f"{t['objective']:>+11.4f}"
        )
    verdict = (
        "tuned beats default" if report["improvement"] > 0
        else "tuned does NOT beat default"
    )
    rows.append(
        f"held-out improvement: {report['improvement']:+.4f} ({verdict})"
    )
    return "\n".join(rows)
