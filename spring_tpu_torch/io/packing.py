"""Copied from spring_tpu/io/packing.py; only the imports differ.

DNA base-code and bit-packing utilities (host side, numpy).

Reference analog: src/util.cpp:269-374 (write_dna_in_bits / read_dna_from_bits,
2-bit ACGT packing and 4-bit ACGTN packing into byte streams) and the
chartorevchar reverse-complement LUT (src/util.h:23-29).

TPU-first redesign: instead of byte streams with per-read headers, reads live
in fixed-shape arrays —
  * code arrays: (num_reads, max_len) uint8 with A=0 C=1 G=2 T=3 N=4,
    padded with 0 beyond each read's length;
  * packed arrays: (num_reads, ceil(max_len/16)) uint32, 16 bases/word,
    base i at bits 2*(i%16) of word i//16 (2-bit, ACGT only).
Fixed shapes are what lets XLA tile the matching kernels onto the VPU/MXU.
"""
from __future__ import annotations

import numpy as np

BASES = b"ACGT"
BASES_N = b"ACGTN"
A, C, G, T, N = 0, 1, 2, 3, 4
BASES_PER_WORD = 16  # 2-bit codes per uint32

# char -> code LUT (255 = invalid)
CHAR_TO_CODE = np.full(256, 255, dtype=np.uint8)
for i, ch in enumerate(BASES_N):
    CHAR_TO_CODE[ch] = i
    CHAR_TO_CODE[ch + 32] = i  # lowercase

CODE_TO_CHAR = np.zeros(256, dtype=np.uint8)
CODE_TO_CHAR[: len(BASES_N)] = np.frombuffer(BASES_N, dtype=np.uint8)

# complement of a base code (N -> N)
COMP = np.array([T, G, C, A, N], dtype=np.uint8)


def words_per_read(max_len: int) -> int:
    return -(-max_len // BASES_PER_WORD)


def strings_to_codes(reads: list[bytes], max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Convert byte-string reads to a padded (n, max_len) uint8 code array.

    Returns (codes, lengths). Invalid characters raise ValueError.
    """
    n = len(reads)
    codes = np.zeros((n, max_len), dtype=np.uint8)
    lengths = np.empty(n, dtype=np.int32)
    for i, r in enumerate(reads):
        lengths[i] = len(r)
        if len(r) > max_len:
            raise ValueError(f"read {i} longer than max_len ({len(r)} > {max_len})")
        c = CHAR_TO_CODE[np.frombuffer(r, dtype=np.uint8)]
        if c.max(initial=0) == 255:
            raise ValueError(f"read {i} contains non-ACGTN character")
        codes[i, : len(r)] = c
    return codes, lengths


def codes_to_strings(codes: np.ndarray, lengths: np.ndarray) -> list[bytes]:
    chars = CODE_TO_CHAR[codes]
    return [chars[i, : lengths[i]].tobytes() for i in range(codes.shape[0])]


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """(n, L) uint8 ACGT codes -> (n, ceil(L/16)) uint32, 2 bits/base.

    Codes are masked to 2 bits (an N packs as A; callers keep N-containing
    reads out of the packed path, reference src/preprocess.cpp:293-304).
    """
    n, L = codes.shape
    W = words_per_read(L)
    padded = np.zeros((n, W * BASES_PER_WORD), dtype=np.uint32)
    padded[:, :L] = codes & 3
    padded = padded.reshape(n, W, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, None, :]
    return np.bitwise_or.reduce(padded << shifts, axis=2).astype(np.uint32)


def unpack_codes(packed: np.ndarray, max_len: int) -> np.ndarray:
    """(n, W) uint32 -> (n, max_len) uint8 codes."""
    n, W = packed.shape
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, None, :]
    codes = ((packed[:, :, None] >> shifts) & 3).astype(np.uint8)
    return codes.reshape(n, W * BASES_PER_WORD)[:, :max_len]


def pack_codes_4bit(codes: np.ndarray) -> np.ndarray:
    """(n, L) uint8 ACGTN codes -> (n, ceil(L/8)) uint32, 4 bits/base.

    Used for N-containing reads (reference 4-bit path, src/util.cpp:322-374).
    """
    n, L = codes.shape
    W = -(-L // 8)
    padded = np.zeros((n, W * 8), dtype=np.uint32)
    padded[:, :L] = codes
    padded = padded.reshape(n, W, 8)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    return np.bitwise_or.reduce(padded << shifts, axis=2).astype(np.uint32)


def unpack_codes_4bit(packed: np.ndarray, max_len: int) -> np.ndarray:
    n, W = packed.shape
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    codes = ((packed[:, :, None] >> shifts) & 15).astype(np.uint8)
    return codes.reshape(n, W * 8)[:, :max_len]


def revcomp_codes(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-read reverse complement of a padded code array."""
    n, L = codes.shape
    out = np.zeros_like(codes)
    lengths = np.asarray(lengths)
    full = lengths == L
    if full.any():
        # common case (uniform read length): plain reversed complement
        out[full] = COMP[codes[full]][:, ::-1]
    rest = np.nonzero(~full)[0]
    if len(rest):
        comp = COMP[codes[rest]]
        idx = lengths[rest, None] - 1 - np.arange(L)[None, :]
        valid = idx >= 0
        rows = np.broadcast_to(np.arange(len(rest))[:, None],
                               (len(rest), L))
        sub = np.zeros_like(comp)
        sub[valid] = comp[rows[valid], idx[valid]]
        out[rest] = sub
    return out


def codes_to_bitstream_2bit(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate reads (ignoring padding) into one dense 2-bit byte stream."""
    mask = np.arange(codes.shape[1])[None, :] < lengths[:, None]
    flat = codes[mask].astype(np.uint8)
    pad = (-len(flat)) % 4
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, dtype=np.uint8)])
    flat = flat.reshape(-1, 4)
    packed = flat[:, 0] | (flat[:, 1] << 2) | (flat[:, 2] << 4) | (flat[:, 3] << 6)
    return packed.tobytes()


def bitstream_2bit_to_flat(data: bytes, total_bases: int) -> np.ndarray:
    raw = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((len(raw), 4), dtype=np.uint8)
    out[:, 0] = raw & 3
    out[:, 1] = (raw >> 2) & 3
    out[:, 2] = (raw >> 4) & 3
    out[:, 3] = (raw >> 6) & 3
    return out.reshape(-1)[:total_bases]
