"""Score-policy registry (counterpart of tpusim/policies/__init__.py:53-93;
plugin names from the reference's pkg/type/const.go:4-13).

make_policy(name, dim_ext_method, norm_method) resolves a scheduler-config
plugin name to a `Policy`: its column function, which scores a batch of B
nodes against all K pod types,

    column(nodes [B], types [K], ks, tp) -> (raw i32[K, B], sdev i32[K, B])

(sdev is the device the policy would hand a share-GPU pod at Reserve, -1 =
none), its normalisation over the feasible nodes, whether a gpuSelMethod
may name it (self-select), and the column id the CUDA kernel switches on.
RandomScore's score is a draw per event (policies/random_policy.py): it
has no column and no table rows, and `per_event` marks it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from tpusim_torch.policies.bestfit import bestfit_column
from tpusim_torch.policies.clustering import clustering_column
from tpusim_torch.policies.dotprod import (
    DIM_EXT_METHODS,
    NORM_METHODS,
    make_dotprod_column,
)
from tpusim_torch.policies.fgd import fgd_column
from tpusim_torch.policies.packing import packing_column
from tpusim_torch.policies.pwr import pwr_column
from tpusim_torch.policies.simon import simon_column

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
}
NORMALIZE_IDS = {"none": 0, "minmax": 1, "pwr": 2}


class Policy(NamedTuple):
    name: str
    column: Optional[Callable]  # None for the per-event RandomScore
    normalize: str  # "none" | "minmax" | "pwr"
    self_select: bool

    @property
    def column_id(self) -> int:
        return COLUMN_IDS[self.name]

    @property
    def per_event(self) -> bool:
        """Whether the score is drawn per event instead of read from the
        tables (RandomScore)."""
        return self.name == "RandomScore"


def make_policy(name: str, dim_ext_method: str = "share",
                norm_method: str = "max") -> Policy:
    """The policy of a scheduler-config plugin name. Raises KeyError for an
    unknown name."""
    sel = name in SELF_SELECT_POLICIES
    if name == "DotProductScore":
        return Policy(name, make_dotprod_column(dim_ext_method, norm_method),
                      "none", sel)
    table = {
        "FGDScore": (fgd_column, "none"),
        "PWRScore": (pwr_column, "pwr"),
        "BestFitScore": (bestfit_column, "minmax"),
        "GpuPackingScore": (packing_column, "none"),
        "GpuClusteringScore": (clustering_column, "none"),
        "Simon": (simon_column, "minmax"),
        "RandomScore": (None, "none"),
    }
    if name not in table:
        raise KeyError(f"unknown score plugin: {name!r}")
    column, normalize = table[name]
    return Policy(name, column, normalize, sel)


__all__ = [
    "DIM_EXT_METHODS",
    "NORM_METHODS",
    "NORMALIZE_IDS",
    "POLICY_NAMES",
    "SELF_SELECT_POLICIES",
    "Policy",
    "make_policy",
]
