"""One device-to-host transfer for a nest of tensors (counterpart of
tpusim/sim/fetch.py device_fetch).

A replay result and its report rows are some twenty tensors. Reading them
back one by one pays a synchronising copy each; `device_fetch` packs every
device tensor of a nest of NamedTuples and tuples into one byte buffer on
the device (bit copies, so float bits survive), copies that once, and
slices it back into CPU tensors of the original dtypes and shapes.
"""

from __future__ import annotations

from typing import List

import torch


def _leaves(tree, out: List[torch.Tensor]):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, tuple):
        for x in tree:
            _leaves(x, out)


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, tuple):
        items = [_rebuild(x, it) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def device_fetch(tree):
    """`tree` with every tensor on the CPU, moved in one copy. Leaves that
    are not tensors (None, numbers) pass through; a tree already on the CPU
    is returned as it is."""
    leaves: List[torch.Tensor] = []
    _leaves(tree, leaves)
    dev = [x for x in leaves if x.device.type != "cpu"]
    if not dev:
        return tree
    parts = []
    for x in dev:
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        b = x.reshape(-1)
        if b.numel() <= 1:  # an empty or one-element view keeps its stride
            b = b.as_strided((b.numel(),), (1,))
        b = b.view(torch.uint8)
        # keep every part 8-byte aligned, so each slices back as a view
        parts += [b, b.new_zeros(-b.numel() % 8)]
    buf = torch.cat(parts).cpu()
    host, off = [], 0
    for x in leaves:
        if x.device.type == "cpu":
            host.append(x)
            continue
        dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
        nbytes = x.numel() * dtype.itemsize
        y = buf[off:off + nbytes].view(dtype).reshape(x.shape)
        host.append(y.to(torch.bool) if x.dtype == torch.bool else y)
        off += nbytes + -nbytes % 8
    return _rebuild(tree, iter(host))
