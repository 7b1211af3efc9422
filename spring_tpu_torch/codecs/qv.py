"""Copied from spring_tpu/codecs/qv.py; only the imports differ.

Python API over the native quality codec (csrc/qvcodec.cpp).

Reference analog: the reference routes quality strings through generic
libbsc (src/reorder_compress_quality_id.cpp:170-183); this codec models
quality structure directly — (prev, prev2, position)-context adaptive
range coding — beating the block-sorting approach on both ratio and CPU.

Two front-ends over one ragged-row wire format:
  compress_rows / decompress_rows — zero-padded (n, L) matrix + lengths
  compress_str_array / decompress_str_array — list of byte strings
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import native


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _compress_blob(blob: np.ndarray, lens: np.ndarray,
                   num_threads: int = 0, fine_pos: bool = False) -> bytes:
    lib = native.load()
    n = len(lens)
    cap = int(lib.stpu_qv_bound(len(blob), n))
    dst = np.empty(cap, np.uint8)
    got = lib.stpu_qv_compress(_u8p(blob), n, _i32p(lens), _u8p(dst), cap,
                               num_threads, int(fine_pos))
    if got < 0:
        raise RuntimeError(f"qv_compress failed ({got})")
    return dst[:got].tobytes()


def _decompress_blob(data: bytes,
                     num_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    lib = native.load()
    src = np.frombuffer(data, np.uint8)
    n_o, l_o, t_o = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.stpu_qv_dims(_u8p(src), len(src), ctypes.byref(n_o),
                        ctypes.byref(l_o), ctypes.byref(t_o)) != 0:
        raise RuntimeError("corrupt qv stream")
    n, total = int(n_o.value), int(t_o.value)
    blob = np.empty(max(total, 1), np.uint8)
    lens = np.zeros(max(n, 1), np.int32)
    got = lib.stpu_qv_decompress(_u8p(src), len(src), _u8p(blob), total,
                                 _i32p(lens), n, num_threads)
    if got != n:
        raise RuntimeError(f"qv_decompress failed ({got})")
    return blob[:total], lens[:n]


def compress_rows(mat: np.ndarray, lens: np.ndarray,
                  num_threads: int = 0, fine_pos: bool = False,
                  **_kw) -> bytes:
    """fine_pos: the rows are quantizer output (near-deterministic per
    column) — use fine position contexts regardless of alphabet size."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    L = mat.shape[1] if mat.ndim == 2 else 0
    valid = np.arange(L)[None, :] < lens32[:, None]
    return _compress_blob(np.ascontiguousarray(mat[valid]), lens32,
                          num_threads, fine_pos)


def decompress_rows(data: bytes, max_len: int | None = None,
                    num_threads: int = 0,
                    **_kw) -> tuple[np.ndarray, np.ndarray]:
    blob, lens = _decompress_blob(data, num_threads)
    n = len(lens)
    L = max_len if max_len is not None else int(lens.max()) if n else 0
    mat = np.zeros((n, max(L, 1)), np.uint8)
    valid = np.arange(max(L, 1))[None, :] < lens[:, None]
    mat[valid] = blob
    return mat, lens


def compress_str_array(strings: list[bytes], **_kw) -> bytes:
    lens = np.fromiter((len(s) for s in strings), np.int32, len(strings))
    blob = np.frombuffer(b"".join(strings), np.uint8)
    return _compress_blob(blob, lens)


def decompress_str_array(data: bytes, **_kw) -> list[bytes]:
    blob, lens = _decompress_blob(data)
    raw = blob.tobytes()
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [raw[offs[i]:offs[i + 1]] for i in range(len(lens))]
