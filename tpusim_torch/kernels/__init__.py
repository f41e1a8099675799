"""Build and bind the port's hand-written CUDA kernels.

The sources in this directory are compiled on first use with `nvcc` for
sm_90a into a shared library with a plain C interface, which is loaded with
ctypes. The library lands in `.tpusim_torch_build/` at the root of the
checkout, named by a digest of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Nothing here runs when
the module is imported.

Each launcher takes a pointer to a `ReplayArgs` and the CUDA stream, and
returns the launch's CUDA error code.

A variant of the library is built from the same sources with extra
preprocessor definitions (`VARIANTS`): "clocked" adds the phase clocks
that chip_smoke.py reads. The main path loads the plain build, "" (no
definitions).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_DIR, "replay.cu"),)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                         ".tpusim_torch_build")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add is contracted but the explicit __fmaf_rn ones: the
    # columns round where the JAX package's compiled code rounds
    "--fmad=false",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
# the CUDA kernels the port has, by the name chip_smoke.py reports
KERNELS = ("init_tables", "replay", "replay_blocked")
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
    "t_order", "mem_cap", "scratch",
)


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


def _target(variant: str):
    """(library path, full nvcc flags) of a variant."""
    flags = NVCC_FLAGS + VARIANTS[variant]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    name = f"libtpusim_torch{'_' + variant if variant else ''}"
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so"), flags


def build_all(variants=("",)) -> dict:
    """Compile every variant in `variants` whose library for these sources
    and flags is not built yet, one nvcc process each, all started
    together. Returns {variant: BuildInfo}; raises with the compiler's
    output if an nvcc fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for variant in variants:
        if variant in _build_info:
            continue
        lib, flags = _target(variant)
        if os.path.exists(lib):
            _build_info[variant] = BuildInfo(lib, 0.0, "")
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[variant] = (lib, tmp, time.perf_counter(), subprocess.Popen(
            [_nvcc(), *flags, "-o", tmp, *SOURCES], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for variant, (lib, tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for variant {variant!r}:\n"
                f"{out}")
        os.replace(tmp, lib)
        _build_info[variant] = BuildInfo(lib, time.perf_counter() - t0, out)
    return {v: _build_info[v] for v in variants}


def build(variant: str = "") -> BuildInfo:
    """Compile one variant unless its library is already built."""
    return build_all((variant,))[variant]


def library(variant: str = "") -> ctypes.CDLL:
    """The loaded kernel library of a variant, built first if need be."""
    if variant not in _libs:
        lib = ctypes.CDLL(build(variant).path)
        for name in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(ReplayArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.replay_scratch_bytes.argtypes = [ctypes.c_int] * 4
        lib.replay_scratch_bytes.restype = ctypes.c_size_t
        lib.empty_launch.argtypes = [ctypes.c_void_p]
        lib.empty_launch.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
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
