"""End-of-run ASCII report tables (counterpart of
tpusim/sim/report_tables.py; ref: pkg/apply/apply.go:289-548 report()).

The reference builds tablewriter tables for per-pod placement, per-node
utilization, and per-GPU-device occupancy. That function is defined but not
wired into Run() in the reference revision; here it is a first-class output
surface behind the CLI's --report flag.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from tpusim_torch.constants import MILLI
from tpusim_torch.io.storage import parse_node_storage
from tpusim_torch.io.trace import NodeRow, PodRow


def _table(header: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in header]
    for r in rows:
        for i, cell in enumerate(r):
            widths[i] = max(widths[i], len(cell))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep, "| " + " | ".join(h.ljust(w) for h, w in zip(header, widths)) + " |", sep]
    for r in rows:
        out.append("| " + " | ".join(c.ljust(w) for c, w in zip(r, widths)) + " |")
    out.append(sep)
    return "\n".join(out)


def pod_info_table(
    pods: Sequence[PodRow],
    placed_node: np.ndarray,
    nodes: Sequence[NodeRow],
    gpu: bool = True,
) -> str:
    """Per-pod placement table (apply.go:291-372), sorted by node."""
    rows = []
    for i, p in enumerate(pods):
        ni = int(placed_node[i])
        if ni < 0:
            continue
        n = nodes[ni]
        cpu_frac = 100.0 * p.cpu_milli / n.cpu_milli if n.cpu_milli else 0
        mem_frac = 100.0 * p.memory_mib / n.memory_mib if n.memory_mib else 0
        row = [
            n.name,
            p.name,
            f"{p.cpu_milli}m({int(cpu_frac)}%)",
            f"{p.memory_mib}Mi({int(mem_frac)}%)",
        ]
        if gpu:
            milli = p.total_gpu_milli
            ratio = int(100.0 * milli / (n.gpu * MILLI)) if n.gpu else 0
            row.append(f"{milli}({ratio}%)")
        row.append(p.workload_name)
        rows.append(row)
    rows.sort(key=lambda r: r[0])
    header = ["Node", "Pod", "CPU Requests", "Memory Requests"]
    if gpu:
        header.append("GPU Milli Requests")
    header.append("APP Name")
    return "Pod Info\n" + _table(header, rows)


def node_info_table(
    pods: Sequence[PodRow],
    placed_node: np.ndarray,
    nodes: Sequence[NodeRow],
    gpu: bool = True,
) -> str:
    """Per-node utilization table (apply.go:374-470) + cluster totals."""
    n_nodes = len(nodes)
    cpu_req = np.zeros(n_nodes, np.int64)
    mem_req = np.zeros(n_nodes, np.int64)
    gpu_req = np.zeros(n_nodes, np.int64)
    cnt = np.zeros(n_nodes, np.int64)
    for i, p in enumerate(pods):
        ni = int(placed_node[i])
        if ni < 0:
            continue
        cpu_req[ni] += p.cpu_milli
        mem_req[ni] += p.memory_mib
        gpu_req[ni] += p.total_gpu_milli
        cnt[ni] += 1
    rows = []
    for ni, n in enumerate(nodes):
        cpu_frac = 100.0 * cpu_req[ni] / n.cpu_milli if n.cpu_milli else 0
        mem_frac = 100.0 * mem_req[ni] / n.memory_mib if n.memory_mib else 0
        row = [
            n.name,
            f"{n.cpu_milli}m",
            f"{int(cpu_req[ni])}m({int(cpu_frac)}%)",
            f"{n.memory_mib}Mi",
            f"{int(mem_req[ni])}Mi({int(mem_frac)}%)",
        ]
        if gpu:
            frac = 100.0 * gpu_req[ni] / (n.gpu * MILLI) if n.gpu else 0
            row += [str(n.gpu), f"{int(gpu_req[ni])}({int(frac)}%)"]
        row.append(str(int(cnt[ni])))
        rows.append(row)
    header = ["Node", "CPU", "CPU Requests", "Memory", "Memory Requests"]
    if gpu:
        header += ["GPU", "GPU Milli Requests"]
    header.append("Pod Count")
    return "Node Info\n" + _table(header, rows)


def gpu_device_table(
    pods: Sequence[PodRow],
    placed_node: np.ndarray,
    dev_mask: np.ndarray,
    nodes: Sequence[NodeRow],
) -> str:
    """Per-device occupancy (apply.go:472-548: node × GPU index → milli
    used and resident pods). The pods of each device are listed in pod
    order; one pass over the placed pods finds them."""
    placed = np.asarray(placed_node)
    mask = np.asarray(dev_mask, bool)
    on_dev = {}
    for i in np.flatnonzero(placed >= 0):
        for d in np.flatnonzero(mask[i]):
            on_dev.setdefault((int(placed[i]), int(d)), []).append(pods[i])
    rows = []
    for ni, n in enumerate(nodes):
        for d in range(n.gpu):
            resident = on_dev.get((ni, d))
            if not resident:
                continue
            milli = sum(p.gpu_milli for p in resident)
            rows.append(
                [
                    n.name,
                    n.model,
                    str(d),
                    f"{milli}/{MILLI}",
                    ", ".join(p.name for p in resident),
                ]
            )
    return "GPU Device Info\n" + _table(
        ["Node", "Model", "GPU Index", "Milli Used", "Pods"], rows
    )


def _bytes_str(n: int) -> str:
    """Binary-SI quantity rendering like k8s resource.Quantity.String()."""
    for suf, div in (("Ti", 1024**4), ("Gi", 1024**3), ("Mi", 1024**2), ("Ki", 1024)):
        if n and n % div == 0:
            return f"{n // div}{suf}"
        if n >= div:
            return f"{n / div:.1f}{suf}"
    return str(n)


def node_storage_table(nodes: Sequence[NodeRow]) -> str:
    """Node Local Storage table (ref: apply.go:440-490): one VG row per
    volume group with requested% and one row per exclusive device."""
    rows = []
    for n in nodes:
        st = parse_node_storage(n.local_storage)
        if st is None:
            continue
        for vg in st.vgs:
            pct = int(vg.requested / vg.capacity * 100) if vg.capacity else 0
            rows.append(
                [n.name, "VG", vg.name, _bytes_str(vg.capacity),
                 f"{_bytes_str(vg.requested)}({pct}%)"]
            )
        for dev in st.devices:
            rows.append(
                [n.name, f"Device({dev.media_type})", dev.device,
                 _bytes_str(dev.capacity),
                 "used" if dev.is_allocated else "unused"]
            )
    return "Node Local Storage\n" + _table(
        ["Node", "Storage Kind", "Storage Name", "Storage Allocatable",
         "Storage Requests"],
        rows,
    )


def full_report(
    pods: Sequence[PodRow],
    placed_node: np.ndarray,
    dev_mask: np.ndarray,
    nodes: Sequence[NodeRow],
    extended_resources: Sequence[str] = ("gpu",),
) -> str:
    gpu = "gpu" in extended_resources
    parts = [
        pod_info_table(pods, placed_node, nodes, gpu),
        node_info_table(pods, placed_node, nodes, gpu),
    ]
    if gpu:
        parts.append(gpu_device_table(pods, placed_node, dev_mask, nodes))
    if "open-local" in extended_resources:
        parts.append(node_storage_table(nodes))
    return "\n\n".join(parts)
