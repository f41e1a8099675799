"""Build and bind the port's hand-written CUDA kernels.

The sources in this directory are compiled on first use with `nvcc` for
sm_90a into a shared library with a plain C interface, which is loaded with
ctypes. The library lands in `.tpusim_torch_build/` at the root of the
checkout, named by a digest of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Nothing here runs when
the module is imported.

Each launcher takes a pointer to a `ReplayArgs` and the CUDA stream, and
returns the launch's CUDA error code.
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
    "bt", "br", "bn", "brmin", "brmax", "slo", "shi", "stats",
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
    )


class BuildInfo:
    """What the last build did: the library path, its wall seconds (0 when
    an earlier build was reused) and the compiler's resource report."""

    def __init__(self, path: str, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


_lib = None
_build_info = None


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


def build() -> BuildInfo:
    """Compile the kernels unless a library for these sources and flags is
    already built. Raises with the compiler's output if nvcc fails."""
    global _build_info
    if _build_info is not None:
        return _build_info
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"libtpusim_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        _build_info = BuildInfo(lib, 0.0, "")
        return _build_info
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    _build_info = BuildInfo(lib, time.perf_counter() - t0,
                            proc.stdout + proc.stderr)
    return _build_info


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build().path)
        for name in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(ReplayArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, args: ReplayArgs, stream: int) -> None:
    """Launch kernel `name` on `stream`; raises if the launch is refused."""
    lib = library()
    code = getattr(lib, name)(ctypes.byref(args), ctypes.c_void_p(stream))
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
