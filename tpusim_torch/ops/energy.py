"""Node power model (counterpart of tpusim/ops/energy.py; ref:
pkg/type/resource.go:533-563 GetEnergyConsumptionNode and the energy tables
of open-gpu-share/utils/const.go:48-121).

GPU power: fully idle devices draw idle watts, every other device draws
full watts. CPU power: 2 vCPUs per physical core; whole CPU packages flip
from idle to full watts as cores become busy.

Float order: every watt figure and count is an integer held exactly in
float32, so the only rounding is in `/ MILLI / 2`, which the JAX package's
compiled code performs as two multiplications by float32 reciprocals; the
port does the same before the floor and ceil.
"""

from __future__ import annotations

import functools

import torch

from tpusim_torch.constants import (
    CPU_FULL_W,
    CPU_IDLE_W,
    CPU_NCORES,
    GPU_FULL_W,
    GPU_IDLE_W,
    MILLI,
)
from tpusim_torch.ops.f32 import recip_f32

_R_MILLI = recip_f32(MILLI)


_TABLES = {"cpu_full": CPU_FULL_W, "cpu_idle": CPU_IDLE_W,
           "cpu_ncores": CPU_NCORES, "gpu_full": GPU_FULL_W,
           "gpu_idle": GPU_IDLE_W}


@functools.lru_cache(maxsize=None)
def _on_device(name: str, device: torch.device) -> torch.Tensor:
    """A watt or core table on `device`, copied there once (the sequential
    oracle reads them every event)."""
    return torch.as_tensor(_TABLES[name], device=device)


def _table(name: str, idx: torch.Tensor) -> torch.Tensor:
    return _on_device(name, idx.device)[idx.long()]


def vcpu_cores(milli_cpu: torch.Tensor) -> torch.Tensor:
    """milli-CPU / 1000 / 2 in float32, as the JAX package computes it."""
    return milli_cpu.to(torch.float32) * _R_MILLI * 0.5


def gpu_power_watts(gpu_left, gpu_cnt, gpu_type):
    """GPU watts per node (resource.go:537-545)."""
    n_idle = (gpu_left == MILLI).sum(-1).to(torch.float32)
    n_working = gpu_cnt.to(torch.float32) - n_idle
    typ = gpu_type.clamp(min=0)
    idle_w = torch.where(gpu_type >= 0, _table("gpu_idle", typ), 0.0)
    full_w = torch.where(gpu_type >= 0, _table("gpu_full", typ), 0.0)
    return idle_w * n_idle + full_w * n_working


def gpu_busy_delta_watts(gpu_type):
    """Watts added when one fully idle device starts working."""
    typ = gpu_type.clamp(min=0)
    return torch.where(gpu_type >= 0,
                       _table("gpu_full", typ) - _table("gpu_idle", typ), 0.0)


def cpu_power_watts(cpu_left, cpu_cap, cpu_type):
    """CPU watts per node (resource.go:547-559)."""
    real_cores = torch.ceil(vcpu_cores(cpu_cap))
    idle_cores = torch.floor(vcpu_cores(cpu_left))
    ncores = _table("cpu_ncores", cpu_type)
    num_cpus = torch.ceil(real_cores / ncores)
    active = torch.ceil((real_cores - idle_cores) / ncores)
    return (_table("cpu_idle", cpu_type) * (num_cpus - active)
            + _table("cpu_full", cpu_type) * active)


def node_power(cpu_left, cpu_cap, gpu_left, gpu_cnt, gpu_type, cpu_type):
    """(cpu watts, gpu watts) per node."""
    return (cpu_power_watts(cpu_left, cpu_cap, cpu_type),
            gpu_power_watts(gpu_left, gpu_cnt, gpu_type))
