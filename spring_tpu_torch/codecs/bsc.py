"""Copied from spring_tpu/codecs/bsc.py; only the imports differ.

Python API over the native xbc block codec (our libbsc equivalent).

Reference analog: BSC_compress / BSC_decompress / BSC_str_array_compress /
BSC_str_array_decompress (src/libbsc/bsc.h:56-68). We expose:
  compress(bytes) / decompress(bytes)          — general byte blobs
  compress_str_array / decompress_str_array    — string arrays with lengths
All heavy lifting (BWT + range coding, OpenMP over 32 MB blocks) is native.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from . import native

DEFAULT_BLOCK = 4 << 20


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else (os.cpu_count() or 8)


def compress(data: bytes, block_size: int = DEFAULT_BLOCK,
             num_threads: int = 0) -> bytes:
    lib = native.load()
    n = len(data)
    cap = lib.stpu_xbc_bound(n, block_size)
    dst = ctypes.create_string_buffer(cap)
    src = (ctypes.c_uint8 * n).from_buffer_copy(data) if n else (ctypes.c_uint8 * 1)()
    got = lib.stpu_xbc_compress(
        ctypes.cast(src, ctypes.POINTER(ctypes.c_uint8)), n,
        ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), cap,
        block_size, _threads(num_threads))
    if got < 0:
        raise RuntimeError(f"xbc_compress failed ({got})")
    return dst.raw[:got]


def decompress(data: bytes, num_threads: int = 0) -> bytes:
    lib = native.load()
    n = len(data)
    src = (ctypes.c_uint8 * n).from_buffer_copy(data) if n else (ctypes.c_uint8 * 1)()
    srcp = ctypes.cast(src, ctypes.POINTER(ctypes.c_uint8))
    raw = lib.stpu_xbc_decompressed_size(srcp, n)
    if raw < 0:
        raise RuntimeError("corrupt xbc stream")
    try:
        dst = ctypes.create_string_buffer(max(int(raw), 1))
    except MemoryError:
        # the claimed decompressed size comes from the (untrusted) stream
        # header — an unallocatable claim is a corrupt stream, not an OOM
        raise RuntimeError("corrupt xbc stream (implausible size)")
    got = lib.stpu_xbc_decompress(srcp, n,
                                  ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)),
                                  raw, _threads(num_threads))
    if got != raw:
        raise RuntimeError(f"xbc_decompress failed ({got})")
    return dst.raw[:raw]


def compress_str_array(strings: list[bytes], **kw) -> bytes:
    """Compress a list of byte strings (reference: BSC_str_array_compress,
    which joins with newlines; we store explicit lengths so strings may
    contain any byte)."""
    lens = np.fromiter((len(s) for s in strings), dtype=np.uint32,
                       count=len(strings))
    blob = b"".join(strings)
    header = np.uint64(len(strings)).tobytes() + lens.tobytes()
    return compress(header + blob, **kw)


def decompress_str_array(data: bytes, **kw) -> list[bytes]:
    raw = decompress(data, **kw)
    count = int(np.frombuffer(raw[:8], dtype=np.uint64)[0])
    lens = np.frombuffer(raw[8:8 + 4 * count], dtype=np.uint32)
    out = []
    off = 8 + 4 * count
    for l in lens:
        out.append(raw[off:off + int(l)])
        off += int(l)
    return out


def compress_dna_str_array(strings: list[bytes], _force: int | None = None,
                           **kw) -> bytes:
    """Long-mode read blocks: pick the smaller of two encodings per block.

    mode 0: the generic str-array wire (BWT captures cross-read redundancy
            when reads overlap — real long-read data);
    mode 1: 2-bit pack ACGT text, xbc the packed payload — a hard
            ~2.0 bits/base ceiling that wins on low-redundancy blocks where
            BWT+MTF pays ~2.03 (reference libbsc pays ~2.01 on the same
            input, so mode 1 beats it; see AB_REPORT.md se-l row).
    Archive format v3; decode with decompress_dna_str_array.
    """
    from ..io import packing

    blob = np.frombuffer(b"".join(strings), np.uint8)
    codes = packing.CHAR_TO_CODE[blob]
    packable = _force != 0 and len(blob) and int(codes.max()) <= 3
    # _force=1 on an unpackable block (e.g. an N) falls back to raw
    raw = (compress_str_array(strings, **kw)
           if not (_force == 1 and packable) else None)
    if packable:  # pure ACGT
        lens = np.fromiter((len(s) for s in strings), dtype=np.uint32,
                           count=len(strings))
        pad = (-len(codes)) % 4
        c = np.concatenate([codes, np.zeros(pad, np.uint8)])
        packed = (c[0::4] | (c[1::4] << 2) | (c[2::4] << 4)
                  | (c[3::4] << 6)).astype(np.uint8)
        lens_z = compress(np.uint64(len(strings)).tobytes() + lens.tobytes(),
                          **kw)
        payload_z = compress(packed.tobytes(), **kw)
        alt = (np.uint64(len(blob)).tobytes()
               + np.uint64(len(lens_z)).tobytes() + lens_z + payload_z)
        if raw is None or len(alt) < len(raw):
            return b"\x01" + alt
    return b"\x00" + raw


def decompress_dna_str_array(data: bytes, **kw) -> list[bytes]:
    """Inverse of compress_dna_str_array (mode byte dispatch)."""
    from ..io import packing

    mode, body = data[:1], data[1:]
    if mode == b"\x00":
        return decompress_str_array(body, **kw)
    if mode != b"\x01":
        raise RuntimeError("corrupt dna str-array stream")
    if len(body) < 16:
        raise RuntimeError("corrupt dna str-array stream")
    total = int(np.frombuffer(body[:8], np.uint64)[0])
    lz = int(np.frombuffer(body[8:16], np.uint64)[0])
    if lz > len(body) - 16:
        raise RuntimeError("corrupt dna str-array stream")
    raw_lens = decompress(body[16:16 + lz], **kw)
    count = int(np.frombuffer(raw_lens[:8], np.uint64)[0])
    if 8 + 4 * count > len(raw_lens):
        raise RuntimeError("corrupt dna str-array stream")
    lens = np.frombuffer(raw_lens[8:8 + 4 * count], np.uint32)
    packed = np.frombuffer(decompress(body[16 + lz:], **kw), np.uint8)
    # framing consistency bounds the decode to the payload actually shipped
    if not (len(packed) * 4 - 3 <= total <= len(packed) * 4) \
            or int(lens.sum()) != total:
        raise RuntimeError("corrupt dna str-array stream")
    idx = np.arange(total)
    codes = (packed[idx >> 2] >> ((idx & 3) << 1)) & 3
    chars = packing.CODE_TO_CHAR[codes].tobytes()
    out = []
    off = 0
    for l in lens:
        out.append(chars[off:off + int(l)])
        off += int(l)
    return out


def compress_rows(mat: np.ndarray, lens: np.ndarray, **kw) -> bytes:
    """compress_str_array over rows of a padded (n, L) byte matrix —
    vectorized blob construction, no per-row Python objects. Decodes with
    decompress_str_array."""
    lens = np.asarray(lens, dtype=np.uint32)
    L = mat.shape[1] if mat.ndim == 2 else 0
    valid = np.arange(L)[None, :] < lens[:, None]
    blob = mat[valid].tobytes()
    header = np.uint64(len(lens)).tobytes() + lens.tobytes()
    return compress(header + blob, **kw)


def decompress_rows(data: bytes, max_len: int | None = None,
                    **kw) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of compress_rows / compress_str_array into a padded matrix.

    Returns (mat (n, L) uint8 zero-padded, lens (n,) int32).
    """
    raw = decompress(data, **kw)
    count = int(np.frombuffer(raw[:8], dtype=np.uint64)[0])
    lens = np.frombuffer(raw[8:8 + 4 * count], dtype=np.uint32).astype(np.int32)
    blob = np.frombuffer(raw[8 + 4 * count:], dtype=np.uint8)
    L = max_len if max_len is not None else (int(lens.max()) if count else 0)
    mat = np.zeros((count, max(L, 1)), np.uint8)
    valid = np.arange(max(L, 1))[None, :] < lens[:, None]
    mat[valid] = blob
    return mat, lens


def compress_array(arr: np.ndarray, **kw) -> bytes:
    """Compress a numpy array's raw bytes (dtype/shape must be known to the
    caller at decode time)."""
    return compress(np.ascontiguousarray(arr).tobytes(), **kw)


def decompress_array(data: bytes, dtype, **kw) -> np.ndarray:
    return np.frombuffer(decompress(data, **kw), dtype=dtype)
