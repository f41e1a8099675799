"""Constants the trace replay uses, copied from the JAX package's table
(the reference's pkg/type/const.go and open-gpu-share/utils/const.go).

Strings are interned into integer ids at trace-ingest time, so every tensor
is integer-typed: gpu_type -1 means "no GPU", unknown CPU models map to 0.
"""

from __future__ import annotations

import numpy as np

MILLI = 1000  # 1 GPU == 1000 milli-GPU
MAX_GPUS_PER_NODE = 8
MAX_NODE_SCORE = 100  # k8s framework.MaxNodeScore
NUM_AFF_CLASSES = 1 + MAX_GPUS_PER_NODE  # share + 1..8 whole-GPU pods
MAX_SPEC_CPU = 128_000  # milli vCPU (ref: utils/const.go:16)
MAX_SPEC_GPU = 8_000  # milli GPU (ref: utils/const.go:18)


# Fragmentation classes (ref: pkg/utils/frag.go:17-35). Order == index.
Q1_LACK_BOTH = 0
Q2_LACK_GPU = 1
Q3_SATISFIED = 2
Q4_LACK_CPU = 3
XL_SATISFIED = 4
XR_LACK_CPU = 5
NO_ACCESS = 6
NUM_FRAG_CLASSES = 7
FRAG_CLASS_NAMES = (
    "q1_lack_both",
    "q2_lack_gpu",
    "q3_satisfied",
    "q4_lack_cpu",
    "xl_satisfied",
    "xr_lack_cpu",
    "no_access",
)

NO_GPU = -1  # gpu_type id of CPU-only nodes

# GPU model registry: index == integer id; a pod's gpu_spec "A|B" OR-list
# becomes a bitmask over these ids. Models outside the trace's 14 register
# on first sight, capped by the int32 bitmask width. The registry belongs to
# the process, as in the reference, so ids stay stable across loads.
MAX_GPU_MODELS = 31
GPU_MODELS = [
    "P4", "2080", "1080", "M40", "T4", "V100M16", "P100", "A10", "3090",
    "V100M32", "A100", "G1", "G2", "G3",
]
GPU_MODEL_IDS = {name: i for i, name in enumerate(GPU_MODELS)}

# device memory of each model in MiB, for the snapshot exports'
# gpu_mem_mib columns (as tpusim/constants.py has it)
GPU_MEMORY_MIB = {
    "P4": 7980711936 // 1024 // 1024,
    "2080": 11554258944 // 1024 // 1024,
    "1080": 11720982528 // 1024 // 1024,
    "M40": 12004098048 // 1024 // 1024,
    "T4": 15842934784 // 1024 // 1024,
    "V100M16": 16944988160 // 1024 // 1024,
    "P100": 17070817280 // 1024 // 1024,
    "A10": 23835181056 // 1024 // 1024,
    "3090": 25446842368 // 1024 // 1024,
    "V100M32": 34089205760 // 1024 // 1024,
    "A100": 85198045184 // 1024 // 1024,
    "G1": 1048576000 // 1024 // 1024,
    "G2": 20971520000 // 1024 // 1024,
    "G3": 31457280000 // 1024 // 1024,
}

CPU_MODELS = (
    "",
    "Intel-Xeon-8269CY",
    "Intel-Xeon-8163",
    "Intel-Xeon-ES-2682-V4",
    "Intel-Xeon-6326",
    "Intel-Xeon-8369B",
)
CPU_MODEL_IDS = {name: i for i, name in enumerate(CPU_MODELS)}

# CPU energy (idle W, full W, physical cores) per CPU model (ref:
# utils/const.go:48-55); index 0, the unknown model, uses 2682's numbers
_CPU_ENERGY = {
    "": (15.0, 120.0, 16.0),
    "Intel-Xeon-8269CY": (20.0, 205.0, 26.0),
    "Intel-Xeon-8163": (20.0, 165.0, 24.0),
    "Intel-Xeon-ES-2682-V4": (15.0, 120.0, 16.0),
    "Intel-Xeon-6326": (20.0, 185.0, 16.0),
    "Intel-Xeon-8369B": (20.0, 270.0, 32.0),
}
CPU_IDLE_W = np.array([_CPU_ENERGY[m][0] for m in CPU_MODELS], np.float32)
CPU_FULL_W = np.array([_CPU_ENERGY[m][1] for m in CPU_MODELS], np.float32)
CPU_NCORES = np.array([_CPU_ENERGY[m][2] for m in CPU_MODELS], np.float32)

# GPU energy (idle W, full W) per model id (ref: utils/const.go:62-121);
# models the reference has no entry for draw 0 W. The tables are
# MAX_GPU_MODELS wide, so models registered later index in range.
_GPU_ENERGY = {
    "T4": (10.0, 70.0),
    "A10": (30.0, 150.0),
    "P100": (25.0, 250.0),
    "V100M16": (30.0, 300.0),
    "V100M32": (30.0, 300.0),
    "A100": (50.0, 400.0),
    "G2": (30.0, 150.0),
    "G3": (50.0, 400.0),
}
GPU_IDLE_W = np.zeros(MAX_GPU_MODELS, np.float32)
GPU_FULL_W = np.zeros(MAX_GPU_MODELS, np.float32)
for _i, _m in enumerate(GPU_MODELS):
    GPU_IDLE_W[_i], GPU_FULL_W[_i] = _GPU_ENERGY.get(_m, (0.0, 0.0))

# typical-pod extraction defaults (ref: pkg/type/resource.go:46-49)
DEFAULT_TYPICAL_POD_POPULARITY = 60
DEFAULT_TYPICAL_POD_INCREASE_STEP = 10


def register_gpu_model(name: str) -> int:
    """Id of `name`, registering an unknown model on first sight."""
    mid = GPU_MODEL_IDS.get(name)
    if mid is None:
        if len(GPU_MODELS) >= MAX_GPU_MODELS:
            raise ValueError(
                f"too many distinct GPU models (> {MAX_GPU_MODELS}): the "
                "gpu_spec bitmask is int32"
            )
        mid = len(GPU_MODELS)
        GPU_MODELS.append(name)
        GPU_MODEL_IDS[name] = mid
    return mid


def gpu_spec_to_mask(spec: str) -> int:
    """Encode a 'V100M16|V100M32' OR-list as a bitmask over GPU_MODELS; an
    empty spec (no constraint) is 0."""
    mask = 0
    for part in str(spec).split("|"):
        part = part.strip()
        if not part or part == "nan":
            continue
        mask |= 1 << register_gpu_model(part)
    return mask
