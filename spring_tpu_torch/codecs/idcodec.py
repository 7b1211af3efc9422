"""Copied from spring_tpu/codecs/idcodec.py; only the imports differ.

Python API over the native tokenized read-ID codec.

Reference analog: compress_id_block / decompress_id_block wrappers
(src/util.cpp:113-141) over src/id_compression.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import native


def compress_ids(ids: list[bytes]) -> bytes:
    blob = b"".join(ids)
    lens = np.fromiter((len(s) for s in ids), dtype=np.uint32, count=len(ids))
    return compress_ids_raw(np.frombuffer(blob, np.uint8), lens)


def compress_ids_raw(idbuf: np.ndarray, lens: np.ndarray) -> bytes:
    """Compress ids given as a concatenated uint8 buffer + uint32 lengths
    (zero-copy path from the native FASTQ parser)."""
    lib = native.load()
    idbuf = np.ascontiguousarray(idbuf, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.uint32)
    n = int(idbuf.size)
    srcp = (idbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if n
            else ctypes.cast(ctypes.create_string_buffer(1),
                             ctypes.POINTER(ctypes.c_uint8)))
    lens_c = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    cap = n + 16 * len(lens) + 1024
    dst = ctypes.create_string_buffer(cap)
    got = lib.stpu_id_compress(
        srcp, lens_c, len(lens),
        ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), cap)
    if got < 0:
        raise RuntimeError(f"id_compress failed ({got})")
    return dst.raw[:got]


def decompress_ids_raw(data: bytes, expected_count: int,
                       expected_bytes_hint: int = 0
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Decompress to (concatenated uint8 buffer, uint32 lengths) — the
    zero-copy shape the decoder pipeline consumes directly. The output
    buffer starts at a modest guess and regrows on -2 (a fixed 256 B/id
    cap allocated + sliced ~65 MB per 256k block; ctypes' .raw also
    copies the WHOLE buffer before slicing — together several seconds of
    page faults per block on this host)."""
    lib = native.load()
    n = len(data)
    src = (ctypes.c_uint8 * max(n, 1)).from_buffer_copy(data or b"\0")
    srcp = ctypes.cast(src, ctypes.POINTER(ctypes.c_uint8))
    cap = max(expected_bytes_hint, 48 * max(expected_count, 1))
    while True:
        dst = (ctypes.c_uint8 * cap)()
        lens = np.zeros(max(expected_count, 1), dtype=np.uint32)
        count = ctypes.c_uint32(0)
        got = lib.stpu_id_decompress(
            srcp, n, ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), cap,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(lens), ctypes.byref(count))
        if got == -2:
            cap *= 4
            continue
        if got < 0:
            raise RuntimeError(f"id_decompress failed ({got})")
        buf = np.frombuffer(ctypes.string_at(dst, got), np.uint8)
        return buf, lens[: count.value].copy()


def decompress_ids(data: bytes, expected_count: int,
                   expected_bytes_hint: int = 0) -> list[bytes]:
    buf, lens = decompress_ids_raw(data, expected_count,
                                   expected_bytes_hint)
    raw = buf.tobytes()
    out = []
    off = 0
    for l in lens:
        out.append(raw[off:off + int(l)])
        off += int(l)
    return out
