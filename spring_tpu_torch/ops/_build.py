"""Build and load the port's CUDA kernels.

The sources in spring_tpu_torch/csrc/*.cu are compiled with nvcc for
sm_90a into one shared library with a plain C interface, at first use,
into csrc/build/ (rebuilt when a source is newer than the library), and
loaded with ctypes. Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "build")
_SOURCES = ("masked_hamming.cu",)
_LIB = os.path.join(_BUILD, "libstpu_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def build() -> str:
    """Compile the kernel library if it is missing or stale; return its
    path. Raises with nvcc's output when the compile fails."""
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    if (os.path.exists(_LIB) and os.path.getmtime(_LIB)
            >= max(os.path.getmtime(s) for s in srcs)):
        return _LIB
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            ham = [vp, vp, vp, vp, vp, i64, ci, i64, i64, i64, i64, ci, vp]
            ver = [vp] * 9 + [ci] * 7 + [vp]
            timed = [ci, ctypes.POINTER(ctypes.c_float)]
            for name, args in (
                    ("stpu_masked_hamming", ham),
                    ("stpu_masked_hamming_timed", ham + timed),
                    ("stpu_verify_rows", ver),
                    ("stpu_verify_rows_timed", ver + timed),
                    ("stpu_empty_timed", [ci, vp] + timed)):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ci
            _lib = lib
        return _lib
