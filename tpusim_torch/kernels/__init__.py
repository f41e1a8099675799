"""Build and bind the port's hand-written CUDA kernels.

The sources in this directory are compiled on first use with `nvcc` for
sm_90a, each to an object by an nvcc of its own, all in parallel, and
linked into one shared library with a plain C interface, which is loaded
with ctypes. The library lands in `.tpusim_torch_build/` at the root of the
checkout (or the directory `set_build_dir` or $TPUSIM_COMPILE_CACHE_DIR
names: build_dir), named by a digest of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing
here runs when the module is imported.

Each launcher takes a pointer to a `ReplayArgs` and the CUDA stream, and
returns the launch's CUDA error code. A configuration with a learned
column (learn/policy.py) runs the kLearned instantiations (replay_learned.cu,
replay_blocked_learned.cu, replay_learned_records.cu,
replay_learned_faults.cu, replay_blocked_learned_faults.cu), which `init_tables`, `replay`, `replay_blocked`,
the lanes launchers and the fault forms dispatch to;
`replay_forced` (replay_forced.cu) is the teacher-forced form of `replay`
(learn/dataset.py). `replay` and `replay_blocked` run
their chunk forms (replay_chunks.cu) where `key_out` is set: those also
write the event key chain's key after the last event; where `ctr` is set,
their record forms (replay_records.cu, replay_blocked_records.cu,
`RECORD_KERNELS`), which also write the obs records
(tpusim_torch/sim/records.py). The replays' fault forms
(`FAULT_KERNELS`, the in-scan fault lane) read the fault fields of the
same `ReplayArgs`. `MappedBuffer` is a host buffer the card writes
directly (the heartbeat's ring). The lanes launchers (`LANE_KERNELS`)
take an array of B `ReplayArgs` in host memory, B, a device buffer of B
`ReplayArgs` that they copy the array into on the stream, and the stream:
block b of their grid replays lane b. They refuse lanes that would need
different instantiations of the kernel.

A variant of the library is built from the same sources with extra
preprocessor definitions (`VARIANTS`): "clocked" adds the phase clocks
that chip_smoke.py reads (it has no record forms: their launchers refuse).
The main path loads the plain build, "" (no definitions).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
# compiled apart, in parallel, and linked into one library (replay_lanes.cu
# includes replay.cu's device code for the lanes kernels; the fault forms'
# files include replay_lanes.cu's; replay_chunks.cu, replay.cu's, for the
# chunk forms of replay and replay_blocked; replay_records.cu and
# replay_blocked_records.cu, replay.cu's, for their record forms, the
# longest compiles, each in a source of its own; the learned instantiations
# in replay_learned.cu and replay_blocked_learned.cu, replay_lanes.cu's,
# their record forms in replay_learned_records.cu, replay.cu's, their fault
# forms in replay_learned_faults.cu and replay_blocked_learned_faults.cu,
# replay_lanes.cu's, and the forced form in replay_forced.cu, replay.cu's)
SOURCES = tuple(os.path.join(_DIR, name) for name in (
    "replay.cu", "replay_lanes.cu", "replay_faults.cu",
    "replay_blocked_faults.cu", "replay_chunks.cu", "replay_records.cu",
    "replay_blocked_records.cu", "replay_learned.cu",
    "replay_blocked_learned.cu", "replay_learned_records.cu",
    "replay_learned_faults.cu", "replay_blocked_learned_faults.cu",
    "replay_forced.cu"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                         ".tpusim_torch_build")
_build_dir = None  # set_build_dir's directory
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add is contracted but the explicit __fmaf_rn ones: the
    # columns round where the JAX package's compiled code rounds
    "--fmad=false",
    "-Xptxas=-v", "-Xcompiler", "-fPIC",
)
# the CUDA kernels the port has, by the name chip_smoke.py reports
KERNELS = ("init_tables", "replay", "replay_blocked", "replay_lanes",
           "replay_blocked_lanes")
# the replays' fault forms (the in-scan fault lane, fault_lane.py)
FAULT_KERNELS = ("replay_faults", "replay_blocked_faults",
                 "replay_lanes_faults", "replay_blocked_lanes_faults")
# the replays' record forms, which `replay` and `replay_blocked` launch
# where ReplayArgs.ctr is set (records.py)
RECORD_KERNELS = ("replay_record", "replay_blocked_record")
# the teacher-forced form of `replay` (learn/dataset.py)
FORCED_KERNELS = ("replay_forced",)
# the most node-only features a node column folds, and the most policies a
# learned family names (replay.cu kMaxFamily)
MAX_FAMILY = 32
# the launchers that take an array of lanes (launch_lanes)
LANE_KERNELS = ("replay_lanes", "replay_blocked_lanes", "replay_lanes_faults",
                "replay_blocked_lanes_faults")
# the most policies one configuration may combine (replay.cu kMaxPolicies)
MAX_POLICIES = 6
# the most pod types and typical pods the kernels' staged forms hold in
# shared memory (replay.cu kMaxTypes, kMaxTypical); past either, the host
# launches their global forms
MAX_TYPES = 2048
MAX_TYPICAL = 1024
# the library variants by name: their extra nvcc definitions
VARIANTS = {
    "": (),
    "clocked": ("-DTPUSIM_PHASE_CLOCKS",),
}
# int64 slots of ReplayArgs.clocks in the clocked variant (replay.cu
# ClockSlot): cycles per phase, thread 0's barrier wait, the event loop's
# cycles, the summaries' init, then counts
CLOCK_SLOTS = ("refresh", "block", "drift", "extrema", "select", "commit",
               "wait", "loop", "init", "refreshes", "rescans", "work",
               "setup", "sum", "items")
NUM_CLOCKS = 16

POINTER_FIELDS = (
    "cpu_left", "mem_left", "gpu_left", "aff_cnt", "cpu_cap", "cpu_type",
    "gpu_cnt", "gpu_type", "rank",
    "t_cpu", "t_mem", "t_milli", "t_num", "t_mask",
    "tp_cpu", "tp_milli", "tp_num", "tp_mask", "tp_freq",
    "gpu_idle_w", "gpu_full_w", "cpu_idle_w", "cpu_full_w", "cpu_ncores",
    "score", "sdev", "feas",
    "p_cpu", "p_mem", "p_milli", "p_num", "p_pinned", "p_type",
    "ev_kind", "ev_pod",
    "placed", "maskb", "failed", "ev_node", "ev_devb",
    "bt", "br", "bn", "brmin", "brmax", "slo", "shi", "stats", "clocks",
    "t_order", "mem_cap", "scratch", "key_out",
)
# the fault forms' pointers and sizes, after the key (replay.cu)
FAULT_POINTER_FIELDS = (
    "f_pos", "f_arg", "f_aux", "f_draws",
    "q_ready", "q_seq", "q_pod", "q_att", "q_era",
    "f_seq", "f_attempts", "f_evicted_at", "f_dead", "f_down_at", "f_dctr",
    "y_rpod", "y_lat", "y_vpod", "y_vnode", "y_nvict", "y_rec",
    "snap_cpu", "snap_gpu", "snap_node",
)
FAULT_SIZE_FIELDS = ("f_rows", "f_cols", "f_cap_r", "f_base", "f_cap",
                     "f_maxr", "f_nrec")
# the record forms' pointers and sizes, after the fault fields (replay.cu)
RECORD_POINTER_FIELDS = ("ctr", "rec_dec", "rec_ser", "hb_ring")
RECORD_SIZE_FIELDS = ("rec_every", "hb_every", "hb_slots", "rec_nodes")
# the forced form's pointers, after the learned fields (replay.cu)
FORCED_POINTER_FIELDS = ("fr_node", "fr_topk", "fr_pick", "fr_feasible",
                         "fr_feats", "fr_pick_feats")


class ReplayArgs(ctypes.Structure):
    """Mirror of `struct ReplayArgs` in replay.cu: device pointers, the
    int32 sizes, then the policy descriptor."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in POINTER_FIELDS]
        + [(name, ctypes.c_int32) for name in ("n", "k", "ks", "t", "p", "e",
                                               "n_pol")]
        + [(name, ctypes.c_int32 * MAX_POLICIES)
           for name in ("pol_column", "pol_norm", "pol_weight")]
        + [(name, ctypes.c_int32) for name in ("sel", "gpu_sel", "dim_ext",
                                               "norm")]
        + [("key", ctypes.c_uint32 * 2)]
        + [(name, ctypes.c_void_p) for name in FAULT_POINTER_FIELDS]
        + [(name, ctypes.c_int32) for name in FAULT_SIZE_FIELDS]
        + [(name, ctypes.c_void_p) for name in RECORD_POINTER_FIELDS]
        + [(name, ctypes.c_int32) for name in RECORD_SIZE_FIELDS]
        + [("ln_n", ctypes.c_int32)]
        + [(name, ctypes.c_int32 * MAX_FAMILY)
           for name in ("ln_feat", "ln_theta")]
        + [("fam_n", ctypes.c_int32), ("fam_src", ctypes.c_int32 * MAX_FAMILY)]
        + [(name, ctypes.c_void_p) for name in FORCED_POINTER_FIELDS]
        + [("fr_sel", ctypes.c_int32)]
    )


class BuildInfo:
    """What the last build did: the library path, its wall seconds (0 when
    an earlier build was reused) and the compiler's resource report."""

    def __init__(self, path: str, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


_libs = {}
_build_info = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from source on first use"
        )
    return path


def set_build_dir(path: str) -> None:
    """Build and look for the libraries in `path` from now on (the
    driver's compile_cache_dir); a library already loaded stays loaded."""
    global _build_dir
    _build_dir = path


def build_dir() -> str:
    """Where the libraries are built: set_build_dir's directory, else
    $TPUSIM_COMPILE_CACHE_DIR, else BUILD_DIR."""
    return (_build_dir or os.environ.get("TPUSIM_COMPILE_CACHE_DIR", "")
            or BUILD_DIR)


def _target(variant: str):
    """(library path, full nvcc flags) of a variant."""
    flags = NVCC_FLAGS + VARIANTS[variant]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    name = f"libtpusim_torch{'_' + variant if variant else ''}"
    lib = f"{name}_{h.hexdigest()[:16]}.so"
    return os.path.join(build_dir(), lib), flags


def build_all(variants=("",)) -> dict:
    """Compile every variant in `variants` whose library for these sources
    and flags is not built yet: one nvcc process a source and variant, all
    started together, each compiling its source to an object, then one
    link a variant. Returns {variant: BuildInfo}; raises with the
    compiler's output if an nvcc fails."""
    os.makedirs(build_dir(), exist_ok=True)
    jobs = {}
    for variant in variants:
        if variant in _build_info:
            continue
        lib, flags = _target(variant)
        if os.path.exists(lib):
            _build_info[variant] = BuildInfo(lib, 0.0, "")
            continue
        tmp = f"{lib}.{os.getpid()}"
        objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
        jobs[variant] = (lib, tmp, objs, time.perf_counter(), [
            subprocess.Popen([_nvcc(), *flags, "-c", "-o", obj, src],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for obj, src in zip(objs, SOURCES)])
    for variant, (lib, tmp, objs, t0, procs) in jobs.items():
        log = ""
        for proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                                   f"variant {variant!r}:\n{out}")
        link = subprocess.run([_nvcc(), "-shared", "-o", f"{tmp}.so", *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}) for "
                               f"variant {variant!r}:\n{link.stdout}")
        os.replace(f"{tmp}.so", lib)
        for obj in objs:
            os.remove(obj)
        _build_info[variant] = BuildInfo(lib, time.perf_counter() - t0,
                                         log + link.stdout)
    return {v: _build_info[v] for v in variants}


def build(variant: str = "") -> BuildInfo:
    """Compile one variant unless its library is already built."""
    return build_all((variant,))[variant]


def library(variant: str = "") -> ctypes.CDLL:
    """The loaded kernel library of a variant, built first if need be."""
    if variant not in _libs:
        lib = ctypes.CDLL(build(variant).path)
        for name in (KERNELS + FAULT_KERNELS + RECORD_KERNELS
                     + FORCED_KERNELS):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.POINTER(ReplayArgs), ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p]
                           if name in LANE_KERNELS else
                           [ctypes.POINTER(ReplayArgs), ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.replay_scratch_bytes.argtypes = [ctypes.c_int] * 4
        lib.replay_scratch_bytes.restype = ctypes.c_size_t
        lib.empty_launch.argtypes = [ctypes.c_void_p]
        lib.empty_launch.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.mapped_alloc.argtypes = [ctypes.c_size_t,
                                     ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_void_p)]
        lib.mapped_alloc.restype = ctypes.c_int
        lib.mapped_free.argtypes = [ctypes.c_void_p]
        lib.mapped_free.restype = ctypes.c_int
        _libs[variant] = lib
    return _libs[variant]


def launch(name: str, args: ReplayArgs, stream: int,
           variant: str = "") -> None:
    """Launch kernel `name` of a library variant on `stream`; raises if the
    launch is refused."""
    lib = library(variant)
    code = getattr(lib, name)(ctypes.byref(args), ctypes.c_void_p(stream))
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def launch_lanes(name: str, lanes, lanes_dev: int, stream: int,
                 variant: str = "") -> None:
    """Launch lanes kernel `name` of a library variant on `stream` over
    `lanes` (a sequence of ReplayArgs, one a lane), copied into the device
    buffer at `lanes_dev` (len(lanes) * sizeof(ReplayArgs) bytes); raises
    if the launch is refused."""
    lib = library(variant)
    array = (ReplayArgs * len(lanes))(*lanes)
    code = getattr(lib, name)(array, len(lanes), ctypes.c_void_p(lanes_dev),
                              ctypes.c_void_p(stream))
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def staged(num_types: int, num_typical: int) -> bool:
    """Whether a shape fits the kernels' staged forms; the host launches
    the global forms past them."""
    return num_types <= MAX_TYPES and num_typical <= MAX_TYPICAL


def scratch_bytes(k: int, t: int, n_pol: int, blocked: bool) -> int:
    """Bytes of a replay's scratch buffer in the global form (replay.cu
    replay_scratch_bytes)."""
    return int(library().replay_scratch_bytes(k, t, n_pol, int(blocked)))


def launch_empty(stream: int, variant: str = "") -> None:
    """Launch an empty kernel through the same library and ctypes call as
    the port's kernels: what a launch costs without work (chip_smoke.py
    times it beside init_tables)."""
    lib = library(variant)
    code = lib.empty_launch(ctypes.c_void_p(stream))
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"empty launch failed: CUDA error {code} ({msg})")


class MappedBuffer:
    """`words` int32 words of pinned host memory mapped into the card's
    address space (cudaHostAlloc with cudaHostAllocMapped, replay_records.cu
    mapped_alloc): `device_ptr` is what a kernel writes through, `words()`
    a numpy view of the host side. close() (or the buffer's collection)
    frees it."""

    def __init__(self, words: int):
        import numpy as np

        self.host_ptr = self.device_ptr = None
        lib = library()
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        code = lib.mapped_alloc(4 * int(words), ctypes.byref(host),
                                ctypes.byref(dev))
        if code != 0:
            msg = lib.kernel_error_string(code).decode()
            raise RuntimeError(f"mapped_alloc failed: CUDA error {code} "
                               f"({msg})")
        self.host_ptr, self.device_ptr = host.value, dev.value
        self._view = np.ctypeslib.as_array(
            (ctypes.c_int32 * int(words)).from_address(self.host_ptr))

    def words(self):
        return self._view

    def zero(self) -> None:
        self._view[:] = 0

    def close(self) -> None:
        if self.host_ptr:
            self._view = None
            library().mapped_free(ctypes.c_void_p(self.host_ptr))
            self.host_ptr = self.device_ptr = None

    def __del__(self):
        self.close()
