"""Score-policy registry (counterpart of tpusim/policies/__init__.py:53-93;
plugin names from the reference's pkg/type/const.go:4-13).

make_policy(name, dim_ext_method, norm_method) resolves a scheduler-config
plugin name to a `Policy`: its column function, which scores a batch of B
nodes against all K pod types,

    column(nodes [B], types [K], ks, tp) -> (raw i32[K, B], sdev i32[K, B])

(sdev is the device the policy would hand a share-GPU pod at Reserve, -1 =
none), its normalisation over the feasible nodes, whether a gpuSelMethod
may name it (self-select), the column id the CUDA kernel switches on, and
its per-pod scorer, which the sequential oracle (tpusim_torch.sim.step)
runs,

    scorer(state [N], pod, ctx) -> PolicyResult(raw i32[N], sdev i32[N])

(tpusim/policies' kernels; policies/base.py). RandomScore's score is a
draw per event (policies/random_policy.py): it has no column and no table
rows, and `per_event` marks it.

Beside the built-ins, 'LearnedScore[<feature>]' resolves to a learned
feature (tpusim_torch.learn.policy; tpusim/policies/__init__.py:56-106):
normalised "none", never a gpuSelMethod's. frag_delta is FGD's column,
fit_dev_pct has a column of its own, and the node-only features fold into
one node column (LEARNED_NODE, sim/fused_engine.py `fold`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from tpusim_torch.policies.base import PolicyResult, ScoreContext
from tpusim_torch.policies.bestfit import bestfit_column, bestfit_score
from tpusim_torch.policies.clustering import (
    clustering_column,
    clustering_score,
)
from tpusim_torch.policies.dotprod import (
    DIM_EXT_METHODS,
    NORM_METHODS,
    make_dotprod_column,
    make_dotprod_score,
)
from tpusim_torch.policies.fgd import fgd_column, fgd_score
from tpusim_torch.policies.packing import packing_column, packing_score
from tpusim_torch.policies.pwr import pwr_column, pwr_score
from tpusim_torch.policies.random_policy import random_score
from tpusim_torch.policies.simon import simon_column, simon_score

POLICY_NAMES = (
    "FGDScore",
    "PWRScore",
    "BestFitScore",
    "GpuPackingScore",
    "GpuClusteringScore",
    "RandomScore",
    "Simon",
    "DotProductScore",
)

# policies whose own Reserve-phase device pick a gpuSelMethod may name
# (the allocateGpuIdFunc registry, plugin/open_gpu_share.go:39)
SELF_SELECT_POLICIES = frozenset({"FGDScore", "PWRScore", "DotProductScore"})

# the kernel's column ids (replay.cu `Column`)
COLUMN_IDS = {
    "FGDScore": 0,
    "BestFitScore": 1,
    "GpuPackingScore": 2,
    "GpuClusteringScore": 3,
    "PWRScore": 4,
    "DotProductScore": 5,
    "Simon": 6,
    "RandomScore": 7,
    "LearnedScore[frag_delta]": 0,
    "LearnedScore[fit_dev_pct]": 8,
}
# the folded column of a learned family's node-only features (replay.cu
# kLearnedNode): the weighted sum of the features, the same for every type
LEARNED_NODE = "LearnedNode"
COLUMN_IDS[LEARNED_NODE] = 9
NORMALIZE_IDS = {"none": 0, "minmax": 1, "pwr": 2}


class Policy(NamedTuple):
    name: str
    column: Optional[Callable]  # None for the per-event RandomScore
    normalize: str  # "none" | "minmax" | "pwr"
    self_select: bool
    scorer: Callable  # (state, pod, ctx) -> PolicyResult

    @property
    def column_id(self) -> int:
        return COLUMN_IDS[self.name]

    @property
    def node_feature(self):
        """The node-only learned feature this policy scores (it folds into
        the node column), else None."""
        from tpusim_torch.learn.policy import NODE_FEATURES, parse_learned_name

        feat = parse_learned_name(self.name)
        return feat if feat in NODE_FEATURES else None

    @property
    def per_event(self) -> bool:
        """Whether the score is drawn per event instead of read from the
        tables (RandomScore)."""
        return self.name == "RandomScore"


def make_policy(name: str, dim_ext_method: str = "share",
                norm_method: str = "max") -> Policy:
    """The policy of a scheduler-config plugin name or a learned feature
    ('LearnedScore[<feature>]'). Raises KeyError for an unknown name."""
    if name.startswith("LearnedScore["):
        from tpusim_torch.learn.policy import (
            feature_column,
            feature_scorer,
            parse_learned_name,
        )

        feat = parse_learned_name(name)
        if feat is None:
            raise KeyError(f"malformed learned-policy name: {name!r}")
        return Policy(name, feature_column(feat), "none", False,
                      feature_scorer(feat))
    sel = name in SELF_SELECT_POLICIES
    if name == "DotProductScore":
        return Policy(name, make_dotprod_column(dim_ext_method, norm_method),
                      "none", sel,
                      make_dotprod_score(dim_ext_method, norm_method))
    table = {
        "FGDScore": (fgd_column, "none", fgd_score),
        "PWRScore": (pwr_column, "pwr", pwr_score),
        "BestFitScore": (bestfit_column, "minmax", bestfit_score),
        "GpuPackingScore": (packing_column, "none", packing_score),
        "GpuClusteringScore": (clustering_column, "none", clustering_score),
        "Simon": (simon_column, "minmax", simon_score),
        "RandomScore": (None, "none", random_score),
    }
    if name not in table:
        raise KeyError(f"unknown score plugin: {name!r}")
    column, normalize, scorer = table[name]
    return Policy(name, column, normalize, sel, scorer)


def is_policy_name(name: str) -> bool:
    """Whether `name` resolves through make_policy: a built-in or a learned
    feature."""
    if name in POLICY_NAMES:
        return True
    if name.startswith("LearnedScore["):
        from tpusim_torch.learn.policy import is_learned_name

        return is_learned_name(name)
    return False


__all__ = [
    "DIM_EXT_METHODS",
    "LEARNED_NODE",
    "NORM_METHODS",
    "NORMALIZE_IDS",
    "POLICY_NAMES",
    "SELF_SELECT_POLICIES",
    "Policy",
    "is_policy_name",
    "PolicyResult",
    "ScoreContext",
    "make_policy",
]
