"""open-local storage extension and the replay's checkpoint and table
files, and the digest-signed JSON(L) of the learned-policy artifact and
the tuning log (counterpart of tpusim/io/storage.py, without its chain
files).

The open-local half: node VG/device inventory + pod volume
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


# ---------------------------------------------------------------------------
# Replay checkpoints: exact resume of a chunked replay (the port's copy of
# tpusim/io/storage.py's checkpoint and table-cache files)
# ---------------------------------------------------------------------------
#
# A checkpoint is the carry of the port's chunk surface
# (tpusim_torch.sim.table_engine FlatTableCarry/BlockedTableCarry: the node
# state, the placements, masks and failed flags so far, the arrived
# counters and the event key chain's key) plus the per-event telemetry so
# far, written after every segment of a chunked replay
# (driver.SimulatorConfig.checkpoint_every). Files are content-addressed:
# the name is the sha256 of everything that determines the run (the port's
# source salt, the initial state, the pod specs, the event stream, the root
# key, the tie-break rank, the weights and the configuration), so a resumed
# process only ever picks up a checkpoint of the identical run, and a code
# or input change starts fresh instead of resuming into divergence. Every
# leaf is an exact dtype (int32, bool, uint32), so a save and load is
# bit-transparent. The port's salt differs from tpusim's, so neither
# package reads the other's files.

CHECKPOINT_SUFFIX = ".ckpt.npz"


def checkpoint_digest(chunks) -> str:
    """sha256 hex over an iterable of byte chunks: the content key of one
    replay run (or table build). Callers feed every input that defines it;
    the driver prepends its source salt."""
    import hashlib

    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def checkpoint_path(cache_dir: str, digest: str, cursor: int) -> str:
    return os.path.join(
        cache_dir, f"{digest}.e{cursor:010d}{CHECKPOINT_SUFFIX}"
    )


def save_checkpoint(
    cache_dir: str, digest: str, cursor: int, arrays: Dict[str, "object"]
) -> str:
    """Write one checkpoint atomically (a temporary file, then a rename: a
    killed writer leaves no torn file). `arrays` maps leaf names to numpy
    arrays; `cursor` is the number of events already consumed. Returns the
    file path."""
    import numpy as np

    os.makedirs(cache_dir, exist_ok=True)
    path = checkpoint_path(cache_dir, digest, cursor)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __cursor__=np.int64(cursor), **arrays)
    os.replace(tmp, path)
    return path


def iter_checkpoints(cache_dir: str, digest: str) -> list:
    """Every (cursor, path) checkpoint of a run digest, newest first. Files
    of other runs never match: the digest prefix is the whole contract."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return []
    out = []
    prefix = digest + ".e"
    for fname in os.listdir(cache_dir):
        if not (fname.startswith(prefix)
                and fname.endswith(CHECKPOINT_SUFFIX)):
            continue
        try:
            cursor = int(fname[len(prefix):-len(CHECKPOINT_SUFFIX)])
        except ValueError:
            continue
        out.append((cursor, os.path.join(cache_dir, fname)))
    out.sort(reverse=True)
    return out


def find_checkpoint(cache_dir: str, digest: str) -> Optional[Tuple[int, str]]:
    """The newest (cursor, path) checkpoint of a run digest, or None."""
    cands = iter_checkpoints(cache_dir, digest)
    return cands[0] if cands else None


def load_valid_checkpoint(cache_dir: str, digest: str, validate=None,
                          on_skip=None, max_cursor: Optional[int] = None,
                          delete_invalid: bool = True):
    """(cursor, arrays, path) of the newest checkpoint that loads and
    passes `validate(arrays)`. A torn, truncated or edited file is skipped,
    with `on_skip(path, err)`, and deleted (so it cannot shadow later
    saves), and the search goes on to its predecessors. Returns None when
    no usable checkpoint exists: a fresh start is always safe.

    `max_cursor` bounds the search to cursors <= that event (a fork's
    nearest checkpoint at or before its divergence); newer ones are left
    alone. `delete_invalid=False` skips unusable files without deleting
    them: a fork reading another run's ladder destroys nothing."""
    for cursor, path in iter_checkpoints(cache_dir, digest):
        if max_cursor is not None and cursor > max_cursor:
            continue
        try:
            cur, arrays = load_checkpoint(path)
            if cur != cursor:
                raise ValueError(
                    f"cursor mismatch: file says {cur}, name says {cursor}"
                )
            if validate is not None:
                validate(arrays)
            return cursor, arrays, path
        except Exception as err:
            if on_skip is not None:
                on_skip(path, err)
            if delete_invalid:
                try:
                    os.unlink(path)
                except OSError:
                    pass
    return None


def load_checkpoint(path: str) -> Tuple[int, Dict[str, "object"]]:
    """(cursor, {leaf name: numpy array}) from a checkpoint file."""
    import numpy as np

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__cursor__"}
        cursor = int(z["__cursor__"])
    return cursor, arrays


def prune_checkpoints(cache_dir: str, digest: str, keep_cursor: int,
                      keep: int = 0) -> None:
    """Drop a run's checkpoints below `keep_cursor` (each save supersedes
    its predecessors; only the newest is resumed from). Missing files are
    fine: concurrent resumers may race here.

    `keep` is SimulatorConfig.checkpoint_keep: 0 deletes everything below
    keep_cursor (checkpoints exist to survive a kill), < 0 keeps every
    checkpoint (the ladder forks resume from), N > 0 keeps the newest N."""
    if keep < 0 or not cache_dir or not os.path.isdir(cache_dir):
        return
    cands = iter_checkpoints(cache_dir, digest)  # newest first
    doomed = (
        cands[keep:] if keep > 0
        else [(c, p) for c, p in cands if c < keep_cursor]
    )
    for _, path in doomed:
        try:
            os.unlink(path)
        except OSError:
            pass


# The table cache: the (score, sdev, feas) tables init_tables builds are a
# function of the port's source, the configuration, the initial state, the
# distinct pod types and the typical pods, not of the events, the key or
# the weights. The driver keeps them under the same content addressing, and
# a hit serves them instead of an init_tables launch, bit for bit.

TABLES_SUFFIX = ".tables.npz"


def tables_path(cache_dir: str, digest: str) -> str:
    return os.path.join(cache_dir, f"{digest}{TABLES_SUFFIX}")


def find_tables(cache_dir: str, digest: str) -> Optional[str]:
    """Path of a cached table build for this digest, or None."""
    if not cache_dir:
        return None
    path = tables_path(cache_dir, digest)
    return path if os.path.isfile(path) else None


def save_tables(cache_dir: str, digest: str,
                arrays: Dict[str, "object"]) -> str:
    """Persist one table build atomically (the checkpoint discipline).
    `arrays` maps table names to numpy arrays."""
    import numpy as np

    os.makedirs(cache_dir, exist_ok=True)
    path = tables_path(cache_dir, digest)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_tables(path: str) -> Dict[str, "object"]:
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def file_sha256(path: str) -> str:
    """sha256 hex of a file's bytes."""
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_bytes_atomic(path: str, data: bytes) -> str:
    """Write raw bytes atomically (a temporary file, then a rename): a
    killed writer leaves the previous file intact, never a torn one. The
    temporary name is scoped by process and thread, so two writers of one
    path in one process cannot truncate each other's file."""
    import threading

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# Digest-signed JSON(L) (tpusim/io/storage.py:393-501): the learned-policy
# artifact and the tuning log. One header line (a JSON object with at least
# `schema` and `digest`, the sha256 over the payload lines) and the payload,
# one JSON document a line; written atomically (tmp + os.replace), read back
# with the digest checked, so a torn or edited file raises ValueError. The
# bytes are tpusim's, so either package reads what the other wrote.
# ---------------------------------------------------------------------------


def payload_digest(lines) -> str:
    """sha256 hex over payload lines, each newline-terminated."""
    import hashlib

    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


def write_signed_jsonl(path: str, header: dict, lines) -> str:
    """Write header + payload lines atomically; the header gains a `digest`
    key over the payload. Returns the file path."""
    lines = list(lines)
    header = dict(header)
    header["digest"] = payload_digest(lines)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(header, sort_keys=True, separators=(",", ":")))
        f.write("\n")
        for line in lines:
            f.write(line + "\n")
    os.replace(tmp, path)
    return path


def read_signed_jsonl(path: str, schema: str = ""):
    """(header, payload lines) of a signed-JSONL file; raises ValueError on
    a wrong schema (where given) or a payload digest mismatch."""
    with open(path) as f:
        raw = [line.rstrip("\n") for line in f if line.strip()]
    if not raw:
        raise ValueError(f"{path}: empty signed-JSONL file")
    header = json.loads(raw[0])
    if schema and header.get("schema") != schema:
        raise ValueError(
            f"{path}: not a {schema} file (schema={header.get('schema')!r})")
    payload = raw[1:]
    digest = payload_digest(payload)
    if digest != header.get("digest"):
        raise ValueError(
            f"{path}: payload digest mismatch (torn or edited file): "
            f"header {header.get('digest')} != computed {digest}")
    return header, payload


def write_signed_json(path: str, header: dict, doc: dict) -> str:
    """write_signed_jsonl of one canonical-JSON document."""
    line = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return write_signed_jsonl(path, header, [line])


def read_signed_json(path: str, schema: str = ""):
    """(header, doc) of a one-document signed-JSON file; raises ValueError
    as read_signed_jsonl does, or where the file holds more documents."""
    header, payload = read_signed_jsonl(path, schema)
    if len(payload) != 1:
        raise ValueError(f"{path}: want exactly one payload document, found "
                         f"{len(payload)}")
    return header, json.loads(payload[0])
