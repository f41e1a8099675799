"""The learned scorer as a policy (counterpart of tpusim/learn/policy.py).

A learned policy is a linear model over a per-node feature row: the family

    policies = [("LearnedScore[f]", theta_f) for f in features]

whose weights theta are the replays' i32 weight operand. Each feature is an
i32 in [0, MAX_NODE_SCORE], normalised "none", so a decision's total is
sum_f theta_f x feature_f, wrapping as XLA's int32 sum does.

Every feature is a column function, (nodes [B], types [K], ks, tp) ->
(raw i32[K, B], sdev i32[K, B]), as the built-in policies' (policies/), and
a per-pod scorer for the sequential oracle. Two read the pod type:
`frag_delta` is FGD's raw score (policies/fgd.py), and `fit_dev_pct` the
devices the type's per-GPU request fits. The other eighteen (NODE_FEATURES)
read the node alone; `node_features` computes them, and the CUDA replays
fold them into one column (sim/fused_engine.py `fold`).

Float order. `q3_sat_pct` sums the typical pods' frequencies over those of
frag class Q3, and `frag_pct` the node's frag contributions (ops/frag.py
node_frag_contrib) over (typical pod, class) minus those of class Q3.
Each of the three float32 sums follows the order of tpusim's compiled
feature kernels at the count T of typical pods, `feature_plans(T)`: a
float32 sum's last bit flips a feature where it lands on an integer
percent. The CUDA kernels (kernels/replay.cu node_features and the
refresh's learned_node_stage) read the same plans, packed into ReplayArgs
(`plan_words`).

The artifact: a trained parameter vector persists as a digest-signed JSON
document (io.storage.write_signed_json) naming the features it was trained
over; its bytes are tpusim's, so either package loads what the other wrote.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from tpusim_torch.constants import (
    MAX_GPUS_PER_NODE,
    MAX_NODE_SCORE,
    MILLI,
    NUM_FRAG_CLASSES,
    Q3_SATISFIED,
)
from tpusim_torch.kernels import PLAN_SLOTS, PLAN_STAGES
from tpusim_torch.obs.series import UTIL_BUCKETS
from tpusim_torch.ops.frag import (
    SumPlan,
    frag_class,
    node_frag_contrib,
    plan_sum,
)
from tpusim_torch.policies.base import column_scorer
from tpusim_torch.policies.fgd import fgd_column
from tpusim_torch.types import NodeState, PodSpec, TypicalPods

POLICY_SCHEMA = "tpusim-learned-policy/1"

LEARNED_PREFIX = "LearnedScore["

# i32 parameter bounds: features are <= 100, so |theta| <= 4000 keeps any
# total well inside i32 (4000 x 100 x F); the sign is meaningful
THETA_LO = -4000
THETA_HI = 4000

# the features that read the node alone, in the kernel's feature-id order
# (replay.cu node_features)
NODE_FEATURES = (
    "free_gpu_pct", "free_cpu_pct", "free_mem_pct", "free_gpus_pct",
    "max_dev_free_pct", "q3_sat_pct", "frag_pct", "down",
) + tuple(f"util_bucket{k}" for k in range(UTIL_BUCKETS))
LINEAR_FEATURES = (
    "frag_delta", "free_gpu_pct", "free_cpu_pct", "free_mem_pct",
    "free_gpus_pct", "fit_dev_pct", "max_dev_free_pct", "q3_sat_pct",
    "frag_pct", "down",
)
BUCKETED_FEATURES = LINEAR_FEATURES + tuple(
    f"util_bucket{k}" for k in range(10))
FEATURE_SETS = {"linear": LINEAR_FEATURES, "bucketed": BUCKETED_FEATURES}
# every feature, in tpusim's order
FEATURE_NAMES = BUCKETED_FEATURES


def _pct(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """floor(MAX_NODE_SCORE x num / max(den, 1)) clipped to [0, 100], in
    XLA's int32 (the product wraps)."""
    val = num.to(torch.int64) * MAX_NODE_SCORE
    val = ((val + 2**31) % 2**32) - 2**31
    val = torch.div(val, den.to(torch.int64).clamp(min=1),
                    rounding_mode="floor")
    return val.clamp(0, MAX_NODE_SCORE).to(torch.int32)


def _floor_pct(x: torch.Tensor) -> torch.Tensor:
    """clip(floor(x), 0, 100) of a float32 as int32."""
    return torch.floor(x).clamp(0, MAX_NODE_SCORE).to(torch.int32)


def sat_stages(t: int):
    """The vector loops of `q3_sat_pct`'s sum over t <= 32 typical pods
    (the class Q3 pods' frequencies, fused into the loop that classifies
    them; ops/frag.py vector_sum): each pod in turn up to 2; 8 lanes over
    the first 8 (masked past t) up to 8, over the first 16 up to 19; 4
    lanes over the first 20 up to 23; 8 lanes over the first 24 up to 31,
    over all 32 at 32. The pods past them are added one by one."""
    if t <= 2:
        return ()
    if t <= 8:
        return ((8, 1, 8),)
    if t <= 19:
        return ((8, 1, 16),)
    if t <= 23:
        return ((4, 1, 20),)
    if t <= 31:
        return ((8, 1, 24),)
    return ((8, 1, 32),)


def q3_stages(t: int):
    """The vector loops of `frag_pct`'s Q3 amount over t <= 32 typical pods
    (the class Q3 column of the node's contributions, read with a stride
    of 7): each pod in turn up to 15; 8 lanes over the first 8 at 16, over
    the first 16 from 17 to 19 and at 24; 4 lanes over the first 16 at 20,
    then 4 lanes over the next 4 at 21 and 22, 2 lanes over the next 6 at
    23; 8 lanes over the first 24 from 25 to 32. The pods past them are
    added one by one."""
    if t <= 15:
        return ()
    if t == 16:
        return ((8, 1, 8),)
    if t <= 19 or t == 24:
        return ((8, 1, 16),)
    if t == 20:
        return ((4, 1, 16),)
    if t <= 22:
        return ((4, 1, 16), (4, 1, 4))
    if t == 23:
        return ((4, 1, 16), (2, 1, 6))
    return ((8, 1, 24),)


class FeaturePlans(NamedTuple):
    """The orders of the learned features' three float32 sums
    (ops/frag.py SumPlan): q3_sat_pct's (`sat`), frag_pct's contributions
    over (typical pod, class) (`all`, 7 terms a pod) and its Q3 amount
    (`q3`)."""

    sat: SumPlan
    all: SumPlan
    q3: SumPlan


def feature_plans(t: int) -> FeaturePlans:
    """The orders in which tpusim's compiled feature kernels
    (tpusim/learn/policy.py `_q3_sat_pct`, `_frag_pct` under the vmap over
    nodes that feature_policy builds; XLA's CPU build) add their sums over
    t typical pods. Read from the kernels' optimised LLVM IR and confirmed
    pair by pair (two terms of +-2^40 among ones: the sum loses the ones
    added under the pair's common ancestor, which names the tree) at t =
    1-32, 48, 64, 80, 96 and 128, where the trees are the same over 1 node
    and 600, and in tpusim's table engine's build and refresh. Up to 32
    pods a sum is one loop: `sat_stages`, `q3_stages`, and the (pod, class)
    terms in order for `all`. Past 32, XLA's tree reduction: windows of 32
    pods padded evenly (ops/frag.py tree_sum), each added in order, but
    where t is a multiple of 32 `all`'s windows are added by 4 lanes over
    their pods, each pod's 7 terms in turn."""
    if t <= 32:
        return FeaturePlans(SumPlan(1, t, 0, sat_stages(t)),
                            SumPlan(NUM_FRAG_CLASSES, t, 0, ()),
                            SumPlan(1, t, 0, q3_stages(t)))
    pad = -t % 32
    lanes = ((4, 1, 32),) if pad == 0 else ()
    return FeaturePlans(SumPlan(1, 32, pad // 2, ()),
                        SumPlan(NUM_FRAG_CLASSES, 32, pad // 2, lanes),
                        SumPlan(1, 32, pad // 2, ()))


def plan_words(t: int) -> list:
    """feature_plans(t) as the kernels read them (ReplayArgs.ln_plan): the
    sat, all and q3 plans' kernels.PLAN_WORDS words each: per_pod, window,
    lead, the stage count, then (vf, uf, m) of each of PLAN_STAGES
    stages (at most PLAN_SLOTS lanes, a power of 2, a stage)."""
    words = []
    for plan in feature_plans(t):
        stages = list(plan.stages)
        lanes = [vf * uf for vf, uf, _ in stages]
        if len(stages) > PLAN_STAGES or any(
                n > PLAN_SLOTS or n & (n - 1) for n in lanes):
            raise ValueError(f"the kernels take no plan {plan}")
        words += [plan.per_pod, plan.window, plan.lead, len(stages)]
        for vf, uf, m in stages + [(1, 1, 0)] * (PLAN_STAGES - len(stages)):
            words += [vf, uf, m]
    return words


def q3_sat(nodes: NodeState, tp: TypicalPods) -> torch.Tensor:
    """float32 [B]: the frequency of the typical pods of class Q3 on each
    node, summed in tpusim's order (feature_plans' `sat`)."""
    cls = frag_class(nodes.cpu_left, nodes.gpu_left, nodes.gpu_type, tp)
    return plan_sum(torch.where(cls == Q3_SATISFIED, tp.freq, 0.0).T,
                    feature_plans(tp.size).sat)


def frag_score(nodes: NodeState, tp: TypicalPods) -> torch.Tensor:
    """float32 [B]: each node's frag score, its frag amounts over every class
    but Q3, as XLA computes tpusim's node_frag_score: the contributions
    summed over (typical pod, class) in one sum, minus Q3's amount summed
    over the typical pods in another (feature_plans' `all` and `q3`)."""
    contrib = node_frag_contrib(nodes.cpu_left, nodes.gpu_left,
                                nodes.gpu_type, tp)
    plans = feature_plans(tp.size)
    terms = contrib.permute(1, 2, 0).reshape(-1, contrib.shape[0])
    return (plan_sum(terms, plans.all)
            - plan_sum(contrib[:, :, Q3_SATISFIED].T, plans.q3))


def node_features(nodes: NodeState, tp: TypicalPods,
                  names=NODE_FEATURES) -> torch.Tensor:
    """i32 [len(names), B]: the node-only features `names` of a batch of
    nodes (tpusim/learn/policy.py :78-188)."""
    g = nodes.gpu_left
    gsum = g.sum(-1)
    cap = nodes.gpu_cnt * MILLI
    out = []
    for name in names:
        if name == "free_gpu_pct":
            # DOWN nodes hold gpu_left 0: they read 0
            v = _pct(gsum, cap)
        elif name == "free_cpu_pct":
            v = _pct(nodes.cpu_left.clamp(min=0), nodes.cpu_cap)
        elif name == "free_mem_pct":
            # mem_left -1 is the DOWN sentinel: 0 here, `down` carries it
            v = _pct(nodes.mem_left.clamp(min=0), nodes.mem_cap)
        elif name == "free_gpus_pct":
            v = _pct((g == MILLI).sum(-1), nodes.gpu_cnt)
        elif name == "max_dev_free_pct":
            v = _pct(g.max(-1).values, torch.full_like(gsum, MILLI))
        elif name == "q3_sat_pct":
            v = _floor_pct(q3_sat(nodes, tp) * float(MAX_NODE_SCORE))
        elif name == "frag_pct":
            total = gsum.to(torch.float32)
            v = _floor_pct(frag_score(nodes, tp) * float(MAX_NODE_SCORE)
                           / total.clamp(min=1.0))
        elif name == "down":
            v = torch.where(nodes.mem_left < 0, MAX_NODE_SCORE, 0)
        elif name.startswith("util_bucket"):
            k = int(name[len("util_bucket"):])
            used = cap - gsum
            bucket = torch.div(used * UTIL_BUCKETS, cap.clamp(min=1),
                               rounding_mode="floor").clamp(
                                   0, UTIL_BUCKETS - 1)
            live = (nodes.mem_left >= 0) & (nodes.gpu_cnt > 0)
            v = torch.where(live & (bucket == k), MAX_NODE_SCORE, 0)
        else:
            raise KeyError(f"not a node-only feature: {name!r}")
        out.append(v.to(torch.int32))
    if not out:
        return torch.zeros((0, g.shape[0]), dtype=torch.int32,
                           device=g.device)
    return torch.stack(out)


def fit_dev_column(nodes: NodeState, types: PodSpec, ks: int,
                   tp: TypicalPods):
    """fit_dev_pct i32[K, B]: the devices with at least max(milli, 1) free
    over the fixed MAX_GPUS_PER_NODE width (pad devices hold 0 and never
    fit); 0 for a CPU-only type. No device pick."""
    need = types.gpu_milli.clamp(min=1)[:, None, None]  # [K, 1, 1]
    fits = (nodes.gpu_left[None] >= need).sum(-1)  # [K, B]
    pct = _pct(fits, torch.full_like(fits, MAX_GPUS_PER_NODE))
    gpu = (types.gpu_milli * types.gpu_num > 0)[:, None]
    score = torch.where(gpu, pct, 0).to(torch.int32)
    return score, torch.full_like(score, -1)


def frag_delta_column(nodes: NodeState, types: PodSpec, ks: int,
                      tp: TypicalPods):
    """frag_delta i32[K, B]: FGD's raw score; its device pick is no
    gpuSelMethod's (the feature is not a self-select policy)."""
    score, _ = fgd_column(nodes, types, ks, tp)
    return score, torch.full_like(score, -1)


def node_feature_column(name: str):
    """The column function of node-only feature `name`: its value on each
    node, the same for every type."""

    def column(nodes: NodeState, types: PodSpec, ks: int, tp: TypicalPods):
        row = node_features(nodes, tp, (name,))
        score = row.expand(types.cpu.shape[0], row.shape[1]).contiguous()
        return score, torch.full_like(score, -1)

    column.feature = name
    return column


def feature_column(feature: str):
    """The column function of a learned feature; KeyError names the known
    ones."""
    if feature == "frag_delta":
        return frag_delta_column
    if feature == "fit_dev_pct":
        return fit_dev_column
    if feature in NODE_FEATURES:
        return _NODE_COLUMNS[feature]
    raise KeyError(f"unknown learned feature {feature!r} (known: "
                   f"{', '.join(FEATURE_NAMES)})")


_NODE_COLUMNS = {f: node_feature_column(f) for f in NODE_FEATURES}
_SCORERS = {}


def feature_scorer(feature: str):
    """The per-pod scorer of a learned feature (the sequential oracle's)."""
    if feature not in _SCORERS:
        _SCORERS[feature] = column_scorer(feature_column(feature))
    return _SCORERS[feature]


def learned_policy_name(feature: str) -> str:
    return f"{LEARNED_PREFIX}{feature}]"


def parse_learned_name(name: str):
    """'LearnedScore[feat]' -> 'feat', or None for other names."""
    if name.startswith(LEARNED_PREFIX) and name.endswith("]"):
        return name[len(LEARNED_PREFIX):-1]
    return None


def is_learned_name(name: str) -> bool:
    feat = parse_learned_name(name)
    return feat is not None and feat in FEATURE_NAMES


def default_theta(features) -> list:
    """All mass on frag_delta: FGDScore's argmax, the tuned-vs-default
    baseline."""
    return [1000 if f == "frag_delta" else 0 for f in features]


def learned_policies(theta=None, features=LINEAR_FEATURES):
    """[(name, theta_f)] pairs of a learned policy; theta None =
    default_theta. Raises ValueError on unknown features, a length
    mismatch or a theta outside [THETA_LO, THETA_HI]."""
    features = tuple(features)
    for f in features:
        if f not in FEATURE_NAMES:
            raise ValueError(f"unknown learned feature {f!r} (known: "
                             f"{', '.join(FEATURE_NAMES)})")
    if theta is None:
        theta = default_theta(features)
    theta = [int(t) for t in theta]
    if len(theta) != len(features):
        raise ValueError(
            f"theta has {len(theta)} entries for {len(features)} features")
    for t in theta:
        if not THETA_LO <= t <= THETA_HI:
            raise ValueError(f"theta entry {t} outside the i32 export bounds "
                             f"[{THETA_LO}, {THETA_HI}]")
    return [(learned_policy_name(f), t) for f, t in zip(features, theta)]


def save_policy_artifact(path: str, theta, features=LINEAR_FEATURES,
                         meta=None) -> str:
    """Write a trained parameter vector as a signed artifact (atomic); the
    features pin the vocabulary theta indexes."""
    from tpusim_torch.io import storage

    pairs = learned_policies(theta, features)  # validates
    doc = {
        "features": [str(f) for f in features],
        "theta": [int(w) for _, w in pairs],
        "meta": dict(meta or {}),
    }
    return storage.write_signed_json(path, {"schema": POLICY_SCHEMA}, doc)


def load_policy_artifact(path: str):
    """(features tuple, theta list, meta dict) of a signed artifact; raises
    ValueError on torn, edited or wrong-schema files and unknown
    features."""
    from tpusim_torch.io import storage

    _, doc = storage.read_signed_json(path, POLICY_SCHEMA)
    features = tuple(str(f) for f in doc.get("features", ()))
    theta = [int(t) for t in doc.get("theta", ())]
    learned_policies(theta, features)  # validates
    return features, theta, dict(doc.get("meta") or {})


def policies_from_artifact(path: str):
    """Artifact file -> its [(name, weight)] policy pairs."""
    features, theta, _ = load_policy_artifact(path)
    return learned_policies(theta, features)


def parse_policy_spec(spec: str):
    """One `--policy` value -> [(name, weight)] pairs: 'LearnedScore:PATH'
    (a signed artifact), 'learned' / 'learned-linear' / 'learned-bucketed'
    (the default-theta families), or a built-in policy name at weight
    1000."""
    from tpusim_torch.policies import POLICY_NAMES

    if spec.startswith("LearnedScore:"):
        path = spec[len("LearnedScore:"):]
        if not os.path.isfile(path):
            raise ValueError(f"--policy artifact not found: {path!r}")
        return policies_from_artifact(path)
    if spec in ("learned", "learned-linear"):
        return learned_policies()
    if spec == "learned-bucketed":
        return learned_policies(features=BUCKETED_FEATURES)
    if spec in POLICY_NAMES:
        return [(spec, 1000)]
    raise ValueError(
        f"unknown --policy {spec!r}: want LearnedScore:FILE.json, "
        "learned, learned-bucketed, or a built-in policy name "
        f"({', '.join(POLICY_NAMES)})")
