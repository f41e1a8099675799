"""The host's C++ Bellman evaluator (bellman.cpp), bound with ctypes.

The source is compiled with g++ on first use into a shared library in
`.tpusim_torch_build/` at the root of the checkout, named by a digest of
the source and flags, as the CUDA kernels are (tpusim_torch.kernels).
Nothing is built when the module is imported. A failed build raises: there
is no slower fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "bellman.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                         ".tpusim_torch_build")
# no multiply-add is contracted, on any host architecture: the doubles
# round as the reference's x86-64 build rounds them
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None

_I32 = ctypes.POINTER(ctypes.c_int32)


def _target() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbellman_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the evaluator unless its library is built; returns its path.
    Raises with the compiler's output if g++ fails."""
    lib = _target()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded evaluator library, built first if need be."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.bellman_new.restype = ctypes.c_void_p
        lib.bellman_new.argtypes = [
            _I32, _I32, _I32, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
        ]
        lib.bellman_eval.restype = ctypes.c_double
        lib.bellman_eval.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32,
                                     ctypes.c_int32]
        lib.bellman_series.restype = ctypes.c_int32
        lib.bellman_series.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, _I32, _I32, _I32,
            ctypes.c_int64, _I32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int8), _I32, _I32,
            ctypes.POINTER(ctypes.c_double),
        ]
        for name, restype in (("bellman_memo_size", ctypes.c_int64),
                              ("bellman_truncations", ctypes.c_int64),
                              ("bellman_max_depth_seen", ctypes.c_int32)):
            getattr(lib, name).restype = restype
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.bellman_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class BellmanEvaluator:
    """Memoized Bellman value function for one typical-pod distribution.
    The memo lives as long as the evaluator: one experiment, as the
    reference's fragMemo does (its values keep the cum_prob cutoff of their
    first computation, so sharing one across experiments would make the
    reports depend on the order of the runs)."""

    def __init__(self, typical: Sequence[tuple], max_depth: int = 64):
        """typical: [(cpu, gpu_milli, gpu_num, gpu_mask, freq)]."""
        rows = [(int(c), int(m), int(n), int(k), float(f))
                for c, m, n, k, f in typical]
        lib = library()
        cols = list(zip(*rows)) if rows else [()] * 5
        arrs = [np.ascontiguousarray(c, t) for c, t in zip(
            cols, (np.int32, np.int32, np.int32, np.int64, np.float64))]
        self._handle = lib.bellman_new(
            _ptr(arrs[0], ctypes.c_int32), _ptr(arrs[1], ctypes.c_int32),
            _ptr(arrs[2], ctypes.c_int32), _ptr(arrs[3], ctypes.c_int64),
            _ptr(arrs[4], ctypes.c_double), len(rows), max_depth)
        if not self._handle:
            raise ValueError("the typical pods have more than 64 distinct "
                             "GPU milli requests")

    def eval(self, cpu_left: int, gpu_left: Sequence[int],
             gpu_type: int) -> float:
        """The value of one node state."""
        g = (ctypes.c_int32 * 8)(*[int(x) for x in gpu_left])
        return library().bellman_eval(self._handle, int(cpu_left), g,
                                      int(gpu_type))

    def eval_series(self, cpu_left, gpu_left, gpu_type, ev_node, ev_dev,
                    ev_sign, ev_cpu, ev_gpu) -> np.ndarray:
        """The cluster's value after each event, f64[E], in one call.

        cpu_left i32[N], gpu_left i32[N, 8] and gpu_type i32[N] are the
        initial node state; ev_node i32[E] the node each event touched (-1:
        none), ev_dev bool[E, 8] its devices, ev_sign i8[E] +1 for a create
        and -1 for a delete, ev_cpu and ev_gpu i32[E] the event pod's
        milli-CPU and per-device milli-GPU."""
        cpu_left = np.ascontiguousarray(cpu_left, np.int32)
        gpu_left = np.ascontiguousarray(gpu_left, np.int32)
        gpu_type = np.ascontiguousarray(gpu_type, np.int32)
        ev_node = np.ascontiguousarray(ev_node, np.int32)
        ev_dev = np.ascontiguousarray(ev_dev, np.uint8)
        ev_sign = np.ascontiguousarray(ev_sign, np.int8)
        ev_cpu = np.ascontiguousarray(ev_cpu, np.int32)
        ev_gpu = np.ascontiguousarray(ev_gpu, np.int32)
        out = np.empty(len(ev_node), np.float64)
        library().bellman_series(
            self._handle, len(cpu_left), _ptr(cpu_left, ctypes.c_int32),
            _ptr(gpu_left, ctypes.c_int32), _ptr(gpu_type, ctypes.c_int32),
            len(ev_node), _ptr(ev_node, ctypes.c_int32),
            _ptr(ev_dev, ctypes.c_uint8), _ptr(ev_sign, ctypes.c_int8),
            _ptr(ev_cpu, ctypes.c_int32), _ptr(ev_gpu, ctypes.c_int32),
            _ptr(out, ctypes.c_double))
        return out

    def memo_size(self) -> int:
        return int(library().bellman_memo_size(self._handle))

    def truncations(self) -> int:
        """How often the depth guard cut the recursion (0 on real traces:
        the reference recurses without a limit)."""
        return int(library().bellman_truncations(self._handle))

    def max_depth_seen(self) -> int:
        return int(library().bellman_max_depth_seen(self._handle))

    def __del__(self):
        if getattr(self, "_handle", None) and _lib is not None:
            _lib.bellman_free(self._handle)
            self._handle = None
