"""Copied from spring_tpu/encode/streams.py; only the imports differ.

Numeric stream coding helpers (vectorized, lossless).

Reference analogs: the per-read stream files written by the encoder and
re-blocked by reorder_compress_streams — pos as uint16 delta with a 65535
escape to absolute (src/reorder_compress_streams.cpp:254-271), zigzag varints
(src/util.cpp:407-441). All functions here are numpy-vectorized; entropy
coding happens downstream in the native xbc codec.
"""
from __future__ import annotations

import numpy as np

_ESC = np.uint16(0xFFFF)


def zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)) ^ (-(u & np.uint64(1)).astype(np.int64)).astype(np.uint64)).astype(np.int64)


def encode_deltas_u16(values: np.ndarray) -> bytes:
    """Delta-code a non-negative int64 sequence: zigzag(delta) as uint16 with
    0xFFFF escaping to a 64-bit absolute side value (reference trick,
    src/reorder_compress_streams.cpp:254-271).

    Layout: u64 count | u16[count] main | u64[] escapes.
    """
    v = values.astype(np.int64)
    d = np.diff(v, prepend=np.int64(0))
    z = zigzag(d)
    esc = z >= 0xFFFF
    main = np.where(esc, np.uint64(0xFFFF), z).astype(np.uint16)
    side = v[esc].astype(np.uint64)
    return (np.uint64(len(v)).tobytes() + main.tobytes() + side.tobytes())


def decode_deltas_u16(data: bytes) -> np.ndarray:
    n = int(np.frombuffer(data[:8], dtype=np.uint64)[0])
    main = np.frombuffer(data[8:8 + 2 * n], dtype=np.uint16)
    side = np.frombuffer(data[8 + 2 * n:], dtype=np.uint64)
    esc = main == 0xFFFF
    d = unzigzag(main.astype(np.uint64))
    v = np.cumsum(d).astype(np.int64)
    if esc.any():
        # each escape resets the running value to an absolute, so the
        # correction after escape k is side[k] - v_uncorrected[i_k] for every
        # position up to the next escape — corrections don't compound
        abs_idx = np.nonzero(esc)[0]
        last = np.searchsorted(abs_idx, np.arange(n), side="right") - 1
        corr = np.where(last >= 0,
                        side.astype(np.int64)[np.clip(last, 0, None)]
                        - v[abs_idx][np.clip(last, 0, None)], 0)
        v = v + corr
    return v


def encode_u16(values: np.ndarray) -> bytes:
    return values.astype(np.uint16).tobytes()


def decode_u16(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint16).astype(np.int32)


def encode_u8(values: np.ndarray) -> bytes:
    return values.astype(np.uint8).tobytes()


def decode_u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)
