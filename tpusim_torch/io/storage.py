"""open-local storage extension (counterpart of the open-local half of
tpusim/io/storage.py): node VG/device inventory + pod volume
requests (ref: pkg/utils/utils.go:555-668 NodeStorage/VolumeRequest/
GetPodLocalPVCs, pkg/simulator/utils.go:325-343
MatchAndSetLocalStorageAnnotationOnNode, pkg/utils/const.go:16-27 SC names).

In the reference revision this extension is ingest + reporting: per-node
storage JSON (from `<node-name>.json` files beside the cluster YAMLs, or the
`simon/node-local-storage` node annotation) feeds the Node Local Storage
report table (apply.go:440-490) and the MaxVG occupancy verdict
(apply.go:550-631); pod volume annotations (`simon/pod-local-storage`)
synthesize PVCs. No registered scheduler plugin consumes storage, so it does
not constrain placement — faithfully mirrored here.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ANNO_NODE_LOCAL_STORAGE = "simon/node-local-storage"
ANNO_POD_LOCAL_STORAGE = "simon/pod-local-storage"


def maybe_json(raw):
    """Annotation value → dict (annotations arrive as JSON strings; snapshot
    round-trips may already carry dicts). Malformed JSON → None, matching the
    reference's log-and-skip (utils.go:612-615)."""
    if raw is None or not isinstance(raw, str):
        return raw
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return None

OPEN_LOCAL_SC_LVM = "open-local-lvm"
YODA_SC_LVM = "yoda-lvm-default"
LVM_SC_NAMES = (OPEN_LOCAL_SC_LVM, YODA_SC_LVM)


@dataclass
class VG:
    """LVM volume group (ref: open-local SharedResource)."""

    name: str
    capacity: int  # bytes
    requested: int = 0  # bytes


@dataclass
class StorageDevice:
    """Exclusive disk (ref: open-local ExclusiveResource)."""

    device: str
    capacity: int  # bytes
    media_type: str = ""  # HDD | SSD
    is_allocated: bool = False


@dataclass
class NodeStorage:
    """ref: utils.go:555-558."""

    vgs: List[VG] = field(default_factory=list)
    devices: List[StorageDevice] = field(default_factory=list)


@dataclass
class Volume:
    """ref: utils.go:561-567 (size serialized as a string in the JSON)."""

    size: int  # bytes
    kind: str  # LVM | HDD | SSD
    sc_name: str = ""


@dataclass
class PVC:
    """Synthesized claim (ref: GetPodLocalPVCs, utils.go:620-668)."""

    name: str
    namespace: str
    sc_name: str
    size: int


def parse_node_storage(raw) -> Optional[NodeStorage]:
    """JSON (string or dict) → NodeStorage (ref: GetNodeStorage,
    utils.go:572-585)."""
    if raw is None:
        return None
    data = json.loads(raw) if isinstance(raw, str) else raw
    return NodeStorage(
        vgs=[
            VG(
                name=v.get("name", ""),
                capacity=int(v.get("capacity", 0) or 0),
                requested=int(v.get("requested", 0) or 0),
            )
            for v in data.get("vgs") or []
        ],
        devices=[
            StorageDevice(
                device=d.get("device", ""),
                capacity=int(d.get("capacity", 0) or 0),
                media_type=d.get("mediaType", d.get("media_type", "")) or "",
                is_allocated=bool(d.get("isAllocated", d.get("is_allocated", False))),
            )
            for d in data.get("devices") or []
        ],
    )


def parse_pod_storage(raw) -> Optional[List[Volume]]:
    """JSON (string or dict) → volume list (ref: GetPodStorage,
    utils.go:606-618; Volume.Size is a JSON string)."""
    if raw is None:
        return None
    data = json.loads(raw) if isinstance(raw, str) else raw
    return [
        Volume(
            size=int(v.get("size", 0) or 0),
            kind=v.get("kind", ""),
            sc_name=v.get("scName", v.get("sc_name", "")) or "",
        )
        for v in data.get("volumes") or []
    ]


def pod_local_pvcs(
    pod_name: str, namespace: str, volumes: Sequence[Volume]
) -> Tuple[List[PVC], List[PVC]]:
    """Volumes → (lvm PVCs, device PVCs) (ref: GetPodLocalPVCs,
    utils.go:620-668: unsupported kinds are skipped; LVM storage classes go
    to the lvm list, everything else to the device list)."""
    lvm, device = [], []
    for i, v in enumerate(volumes):
        if v.kind not in ("LVM", "HDD", "SSD"):
            continue
        pvc = PVC(
            name=f"pvc-{pod_name}-{i}",
            namespace=namespace,
            sc_name=v.sc_name,
            size=v.size,
        )
        (lvm if v.sc_name in LVM_SC_NAMES else device).append(pvc)
    return lvm, device


def match_local_storage_files(node_names: Sequence[str], path: str) -> Dict[str, dict]:
    """`<node-name>.json` files in the cluster-config dir → per-node raw
    storage info (ref: MatchAndSetLocalStorageAnnotationOnNode,
    pkg/simulator/utils.go:325-343)."""
    found: Dict[str, dict] = {}
    if not os.path.isdir(path):
        return found
    names = set(node_names)
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".json"):
            continue
        name = fname[: -len(".json")]
        if name not in names:
            continue
        try:
            with open(os.path.join(path, fname)) as f:
                found[name] = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
    return found


def cluster_vg_totals(storages: Sequence[Optional[NodeStorage]]) -> Tuple[int, int]:
    """(requested, capacity) bytes over all VGs (ref: apply.go:590-612
    totalVGResource accumulation)."""
    req = cap = 0
    for st in storages:
        if st is None:
            continue
        for vg in st.vgs:
            req += vg.requested
            cap += vg.capacity
    return req, cap
