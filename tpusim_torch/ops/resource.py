"""Resource algebra (counterpart of tpusim/ops/resource.py; ref:
pkg/type/resource.go:454-531 Sub/Add, utils.go:950-1005
IsNodeAccessibleToPod, cache/gpunodeinfo.go:136-204 AllocateGpuId).

Every function takes device vectors `gpu_left: i32[..., 8]` with any
leading batch shape and broadcasts the pod fields against it. 0-milli
padding devices never fit a positive request.
"""

from __future__ import annotations

import torch

from tpusim_torch.constants import MAX_GPUS_PER_NODE, MILLI
from tpusim_torch.ops.prng import uniform

_INT_MAX = torch.iinfo(torch.int32).max


def node_bit(gpu_type: torch.Tensor) -> torch.Tensor:
    """GPU-model bit of a node's gpu_type id (-1 = no GPU -> no bit)."""
    return torch.where(gpu_type >= 0,
                       torch.ones_like(gpu_type) << gpu_type.clamp(min=0), 0)


def is_accessible(gpu_type, pod_gpu_mask):
    """GPU-model constraint: mask 0 is accessible anywhere; otherwise the
    node's model bit must be set (CPU-only nodes match nothing)."""
    return (pod_gpu_mask == 0) | ((pod_gpu_mask & node_bit(gpu_type)) != 0)


def request_units(gpu_left, pod_gpu_milli):
    """floor(left / milli) request units per device (0 for milli == 0)."""
    milli = torch.as_tensor(pod_gpu_milli, device=gpu_left.device)[..., None]
    return torch.where(milli > 0, gpu_left // milli.clamp(min=1), 0)


def can_allocate(gpu_left, pod_gpu_milli, pod_gpu_num):
    """Feasibility of the Filter-phase two-pointer packer: the pointer takes
    floor(left/milli) units per device, so the pod fits iff their sum
    reaches gpu_num."""
    return request_units(gpu_left, pod_gpu_milli).sum(-1) >= pod_gpu_num


def allocate_two_pointer(gpu_left, pod_gpu_milli, pod_gpu_num):
    """Reserve-phase AllocateGpuId for whole/multi-GPU pods: walk devices in
    index order taking floor(left/milli) units from each until gpu_num are
    packed. Returns per-device unit counts i32[..., 8]."""
    units = request_units(gpu_left, pod_gpu_milli)
    prev = torch.cumsum(units, -1, dtype=torch.int32) - units
    num = torch.as_tensor(pod_gpu_num, device=gpu_left.device)
    return torch.minimum((num[..., None] - prev).clamp(min=0), units)


def allocate_share_best(gpu_left, pod_gpu_milli):
    """Tightest-fit device for a share-GPU pod: least free milli among
    fitting devices, first index on ties; -1 if none fits."""
    milli = torch.as_tensor(pod_gpu_milli, device=gpu_left.device)
    fits = gpu_left >= milli[..., None]
    key = torch.where(fits, gpu_left, _INT_MAX)
    lane = torch.arange(MAX_GPUS_PER_NODE, device=gpu_left.device,
                        dtype=torch.int32)
    first = torch.where(key == key.min(-1, keepdim=True).values, lane,
                        MAX_GPUS_PER_NODE).min(-1).values
    return torch.where(fits.any(-1), first, -1)


def select_devices_packed(gpu_left, pod_gpu_milli, pod_gpu_num):
    """Sub's device choice: gpu_num fitting devices, least free first, ties
    by device index. Returns (dev_mask bool[..., 8], ok bool[...])."""
    milli = torch.as_tensor(pod_gpu_milli, device=gpu_left.device)[..., None]
    num = torch.as_tensor(pod_gpu_num, device=gpu_left.device)
    lane = torch.arange(MAX_GPUS_PER_NODE, device=gpu_left.device)
    g_d, g_e = gpu_left[..., :, None], gpu_left[..., None, :]
    # position of device d in the stable ascending order
    ahead = (g_e < g_d) | ((g_e == g_d) & (lane[None, :] < lane[:, None]))
    pos = ahead.sum(-1)
    fit = (gpu_left >= milli) & (milli > 0)
    earlier = fit[..., None, :] & (pos[..., None, :] < pos[..., :, None])
    take = fit & (earlier.sum(-1) < num[..., None])
    return take, take.sum(-1) >= num


def sub_pod(cpu_left, mem_left, gpu_left, pod):
    """Hypothetical placement of `pod` (ref: resource.go:454-480 Sub).
    Returns (cpu_left', mem_left', gpu_left', dev_mask); memory is not
    checked, as in Sub itself."""
    take, _ = select_devices_packed(gpu_left, pod.gpu_milli, pod.gpu_num)
    take = take & (pod.gpu_num > 0)[..., None]
    new_gpu = gpu_left - take.to(gpu_left.dtype) * pod.gpu_milli[..., None]
    return cpu_left - pod.cpu, mem_left - pod.mem, new_gpu, take


def add_pod(cpu_left, mem_left, gpu_left, pod, dev_mask):
    """Return the pod's resources to the devices it held
    (ref: resource.go:482-531 Add)."""
    return (
        cpu_left + pod.cpu,
        mem_left + pod.mem,
        gpu_left + dev_mask.to(gpu_left.dtype) * pod.gpu_milli[..., None],
    )


def allocate_share_worst(gpu_left, pod_gpu_milli):
    """Loosest-fit device for a share-GPU pod (open_gpu_share.go:306-325):
    most free milli among fitting devices, first index on ties; -1 if none
    fits."""
    milli = torch.as_tensor(pod_gpu_milli, device=gpu_left.device)
    fits = gpu_left >= milli[..., None]
    key = torch.where(fits, gpu_left, torch.iinfo(torch.int32).min)
    lane = torch.arange(MAX_GPUS_PER_NODE, device=gpu_left.device,
                        dtype=torch.int32)
    first = torch.where(key == key.max(-1, keepdim=True).values, lane,
                        MAX_GPUS_PER_NODE).min(-1).values
    return torch.where(fits.any(-1), first, -1)


def can_host_on_gpu(gpu_left, pod_gpu_milli, pod_gpu_num):
    """True where at least gpu_num devices each have gpu_milli free
    (ref: frag.go:447-458 CanNodeHostPodOnGpuMemory). Only meaningful for
    gpu_milli > 0."""
    milli = torch.as_tensor(pod_gpu_milli, device=gpu_left.device)[..., None]
    fit = (gpu_left >= milli) & (milli > 0)
    return fit.sum(-1) >= torch.as_tensor(pod_gpu_num, device=gpu_left.device)


def gpu_frag_milli(gpu_left, pod_gpu_milli):
    """Free milli on the devices individually too small for the pod
    (ref: frag.go:205-213 GetGpuFragMilliByNodeResAndPodRes)."""
    milli = torch.as_tensor(pod_gpu_milli, device=gpu_left.device)[..., None]
    return torch.where(gpu_left < milli, gpu_left, 0).sum(-1)


def allocate_exclusive(gpu_left, pod_total_milli):
    """First fully free devices, in index order, until the whole-GPU request
    is covered (resource.go:383-403 AllocateExclusiveGpuId): a bool[..., 8]
    device mask, empty where the idle devices do not cover it."""
    free = gpu_left == MILLI
    total = torch.as_tensor(pod_total_milli, device=gpu_left.device)
    need = torch.div(total + MILLI - 1, MILLI, rounding_mode="floor")
    take = free & (free.cumsum(-1) <= need[..., None])
    enough = free.sum(-1) * MILLI >= total
    return take & enough[..., None]


def allocate_share_random(gpu_left, pod_gpu_milli, key):
    """A uniformly drawn fitting device for a share-GPU pod
    (open_gpu_share.go:327-343): the fitting device of the largest
    `uniform(key, (8,))`, the first on ties; -1 where none fits. For one
    node's row gpu_left [8]."""
    fits = gpu_left >= pod_gpu_milli
    u = uniform(key, MAX_GPUS_PER_NODE, gpu_left.device)
    dev = torch.where(fits, u, -1.0).argmax(-1).to(torch.int32)
    return torch.where(fits.any(-1), dev, -1)


def flatten_gpu_left(gpu_left):
    """Devices sorted by free milli, most first (resource.go:199-215
    Flatten): the canonical key of a node's GPU state."""
    return -torch.sort(-gpu_left, dim=-1).values
