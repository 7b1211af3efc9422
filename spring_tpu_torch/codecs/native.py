"""Copied from spring_tpu/codecs/native.py; the build differs.

ctypes loader (with on-demand build) for the port's native host library.

The library holds the sequential/byte-oriented codecs that the
reference implements in C++ (libbsc, id_compression): our xbc block codec
(SA-IS BWT + MTF/RLE0 + adaptive range coder) and the tokenized id codec,
plus the FASTQ parser, the quality codec and the consensus/layout
kernels. It is compiled from csrc/host/*.cpp with the g++ on PATH at
first use, into csrc/build/ (rebuilt when a source is newer than the
library). Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_HOST = os.path.join(_CSRC, "host")
_SO = os.path.join(_CSRC, "build", "libstpu_torch_host.so")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp")
LDFLAGS = ("-shared", "-fopenmp")
_lock = threading.Lock()
_lib = None


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    so_mtime = os.path.getmtime(_SO)
    return any(os.path.getmtime(os.path.join(_HOST, f)) > so_mtime
               for f in os.listdir(_HOST) if f.endswith((".cpp", ".h")))


def _build() -> None:
    """Compile csrc/host/*.cpp into the library; raises with the
    compiler's stderr when the compile fails."""
    srcs = sorted(os.path.join(_HOST, f) for f in os.listdir(_HOST)
                  if f.endswith(".cpp"))
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXXFLAGS, *srcs, *LDFLAGS, "-o", tmp],
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {_SO} failed ({e.returncode}):\n"
                           f"{e.stderr[-4000:]}") from None
    os.replace(tmp, _SO)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _needs_build():
            _build()
        lib = ctypes.CDLL(_SO)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.stpu_xbc_bound.restype = ctypes.c_int64
        lib.stpu_xbc_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.stpu_xbc_compress.restype = ctypes.c_int64
        lib.stpu_xbc_compress.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int]
        lib.stpu_xbc_decompressed_size.restype = ctypes.c_int64
        lib.stpu_xbc_decompressed_size.argtypes = [c_u8p, ctypes.c_int64]
        lib.stpu_xbc_decompress.restype = ctypes.c_int64
        lib.stpu_xbc_decompress.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                            ctypes.c_int64, ctypes.c_int]
        lib.stpu_id_compress.restype = ctypes.c_int64
        lib.stpu_id_compress.argtypes = [c_u8p, c_u32p, ctypes.c_uint32,
                                         c_u8p, ctypes.c_int64]
        lib.stpu_id_decompress.restype = ctypes.c_int64
        lib.stpu_id_decompress.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                           ctypes.c_int64, c_u32p,
                                           ctypes.c_int64, c_u32p]
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        lib.stpu_fastq_ckpt_stride.restype = ctypes.c_int64
        lib.stpu_fastq_ckpt_stride.argtypes = []
        lib.stpu_fastq_scan.restype = ctypes.c_int64
        lib.stpu_fastq_scan.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int,
                                        c_i64p, c_i64p, c_i64p, c_i64p,
                                        c_i64p, c_i64p]
        lib.stpu_fastq_parse.restype = ctypes.c_int64
        lib.stpu_fastq_parse.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_int64, ctypes.c_int64,
                                         c_u8p, c_i32p, c_u8p, ctypes.c_int,
                                         c_u8p, c_u32p, c_i64p, c_i64p,
                                         ctypes.c_int]
        lib.stpu_fastq_parse_packed.restype = ctypes.c_int64
        lib.stpu_fastq_parse_packed.argtypes = [
            c_u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, c_u32p, c_i32p, c_u8p, ctypes.c_int, c_u8p,
            c_u32p, c_i64p, c_i64p, c_i32p, ctypes.c_int64, c_i64p,
            ctypes.c_int]
        lib.stpu_pack_2bit.restype = None
        lib.stpu_pack_2bit.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_uint32),
                                       ctypes.c_int]
        lib.stpu_fastq_format.restype = ctypes.c_int64
        lib.stpu_fastq_format.argtypes = [c_u8p, c_i32p, c_u8p, c_u8p,
                                          c_u32p, ctypes.c_int64,
                                          ctypes.c_int64, c_u8p]
        lib.stpu_qv_bound.restype = ctypes.c_int64
        lib.stpu_qv_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.stpu_qv_compress.restype = ctypes.c_int64
        lib.stpu_qv_compress.argtypes = [c_u8p, ctypes.c_int64, c_i32p,
                                         c_u8p, ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_int]
        lib.stpu_qv_dims.restype = ctypes.c_int
        lib.stpu_qv_dims.argtypes = [c_u8p, ctypes.c_int64, c_i64p, c_i64p,
                                     c_i64p]
        lib.stpu_qv_decompress.restype = ctypes.c_int64
        lib.stpu_qv_decompress.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                           ctypes.c_int64, c_i32p,
                                           ctypes.c_int64, ctypes.c_int]
        lib.stpu_consensus.restype = None
        lib.stpu_consensus.argtypes = [c_u8p, ctypes.c_int64, c_i32p, c_i32p,
                                       c_i64p, c_u8p, ctypes.c_int64,
                                       ctypes.c_int64, c_u8p, ctypes.c_int]
        lib.stpu_noise_count.restype = None
        lib.stpu_noise_count.argtypes = [c_u8p, ctypes.c_int64, c_i32p,
                                         c_i32p, c_i64p, c_u8p,
                                         ctypes.c_int64, c_u8p,
                                         ctypes.c_int64, c_i32p, ctypes.c_int]
        lib.stpu_noise_fill.restype = None
        lib.stpu_noise_fill.argtypes = [c_u8p, ctypes.c_int64, c_i32p, c_i32p,
                                        c_i64p, c_u8p, ctypes.c_int64, c_u8p,
                                        ctypes.c_int64, c_i64p, c_i32p,
                                        c_u8p, ctypes.c_int]
        lib.stpu_unpack_2bit.restype = None
        lib.stpu_unpack_2bit.argtypes = [c_u32p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         c_u8p, ctypes.c_int]
        lib.stpu_consensus_p.restype = None
        lib.stpu_consensus_p.argtypes = [c_u32p, ctypes.c_int64, c_i32p,
                                         c_i32p, c_i64p, c_u8p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         c_u8p, ctypes.c_int]
        lib.stpu_noise_count_p.restype = None
        lib.stpu_noise_count_p.argtypes = [c_u32p, ctypes.c_int64, c_i32p,
                                           c_i32p, c_i64p, c_i32p,
                                           ctypes.c_int64, c_i32p, c_i64p,
                                           c_u8p, ctypes.c_int64, c_u8p,
                                           ctypes.c_int64, c_i32p,
                                           ctypes.c_int]
        lib.stpu_noise_fill_p.restype = None
        lib.stpu_noise_fill_p.argtypes = [c_u32p, ctypes.c_int64, c_i32p,
                                          c_i32p, c_i64p, c_i32p,
                                          ctypes.c_int64, c_i32p, c_i64p,
                                          c_u8p, ctypes.c_int64, c_u8p,
                                          ctypes.c_int64, c_i64p, c_i32p,
                                          c_u8p, ctypes.c_int]
        lib.stpu_reconstruct.restype = None
        lib.stpu_reconstruct.argtypes = [c_u8p, ctypes.c_int64, c_i64p,
                                         c_i32p, c_u8p, c_i32p, c_i64p,
                                         c_i32p, c_u8p, ctypes.c_int64,
                                         ctypes.c_int64, c_u8p, ctypes.c_int]
        _lib = lib
        return _lib


def _as_u8p(buf) -> ctypes.POINTER(ctypes.c_uint8):
    return ctypes.cast(ctypes.c_char_p(bytes(buf)) if isinstance(buf, memoryview)
                       else buf, ctypes.POINTER(ctypes.c_uint8))
