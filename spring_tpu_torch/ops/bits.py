"""Packed 2-bit DNA primitives on PyTorch tensors.

Port of spring_tpu/ops/bits.py. Reads are (n, W) rows of 32-bit words,
16 bases per word, base i at bits 2*(i%16) of word i//16 (io/packing.py).

torch has no usable uint32 (no shifts, no max), so a packed word travels
as an int32 tensor holding the uint32 bit pattern. XOR/AND/OR/left shift
are the same on both; the helpers below supply the logical right shift
and, for arithmetic that must wrap mod 2^32 (hash products, lane sums,
popcounts), an int64 detour: ``u32`` widens a pattern to its unsigned
value in [0, 2^32), ``i32`` narrows such a value back to the pattern.
"""
from __future__ import annotations

import numpy as np
import torch

BASES_PER_WORD = 16
ODD_MASK = 0x55555555        # low bit of each 2-bit lane
MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 unsigned values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 bit patterns of their low 32 bits."""
    x = x & MASK32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a constant m.

    Split at 16 bits so no partial product leaves int64's range."""
    m = int(m)
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by a static n in [0, 32)."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


def srl_var(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Logical right shift by a per-element n in [1, 32). Lanes where n is
    0 or 32 are left to the caller's select (torch shifts by >= 32 give 0 or
    the sign, never an error)."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of int32 bit patterns (SWAR, int64)."""
    v = u32(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & MASK32) >> 24).to(torch.int32)


def prefix_word(nb: torch.Tensor) -> torch.Tensor:
    """int32 mask covering the first nb (clipped 0..16) 2-bit lanes."""
    nb = nb.clamp(0, 16).to(torch.int64)
    return i32((1 << (2 * nb)) - 1)


def words_per_read(max_len: int) -> int:
    return -(-max_len // BASES_PER_WORD)


def unpack(packed: torch.Tensor, max_len: int) -> torch.Tensor:
    """(..., W) packed words -> (..., max_len) int32 base codes 0..3."""
    shifts = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int32,
                              device=packed.device)
    codes = (packed[..., None] >> shifts) & 3
    return codes.reshape(*packed.shape[:-1], -1)[..., :max_len]


def pack(codes: torch.Tensor) -> torch.Tensor:
    """(..., L) int codes 0..3 -> (..., ceil(L/16)) int32 packed words."""
    L = codes.shape[-1]
    W = words_per_read(L)
    pad = W * BASES_PER_WORD - L
    if pad:
        codes = torch.cat([codes, codes.new_zeros((*codes.shape[:-1], pad))],
                          dim=-1)
    lanes = codes.reshape(*codes.shape[:-1], W, BASES_PER_WORD).to(torch.int64)
    shifts = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int64,
                              device=codes.device)
    # lanes are disjoint, so the sum is the OR
    return i32((lanes << shifts).sum(dim=-1))


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-read base-mismatch count between two packed arrays (..., W):
    the two XOR bits of each 2-bit lane ORed into its low bit, then a
    popcount. Padding lanes must be equal in both inputs."""
    d = a ^ b
    return popcount32((d | srl(d, 1)) & ODD_MASK).sum(dim=-1).to(
        torch.int32)


def mismatch_mask(a_codes: torch.Tensor, b_codes: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Elementwise mismatch over code arrays, False where not ``valid``."""
    return (a_codes != b_codes) & valid


def revcomp_codes(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse-complement padded code rows within their own lengths:
    out[..., j] = 3 - codes[..., len-1-j] for j < len, 0 beyond."""
    L = codes.shape[-1]
    idx = (lengths[..., None].to(torch.int64) - 1
           - torch.arange(L, device=codes.device))
    gathered = torch.take_along_dim(codes, idx.clamp(min=0), dim=-1)
    return torch.where(idx >= 0, 3 - gathered, 0).to(codes.dtype)


def extract_key(codes: torch.Tensor, start, width: int) -> torch.Tensor:
    """Pack ``width`` <= 16 consecutive base codes from ``start`` (an int,
    clamped into the row as a dynamic slice is, or a per-row tensor,
    each index clipped into the row) into one int32 key pattern."""
    if width > BASES_PER_WORD:
        raise ValueError(f"key width {width} > {BASES_PER_WORD}")
    L = codes.shape[-1]
    offs = torch.arange(width, device=codes.device)
    if isinstance(start, int):
        s = min(max(start, 0), L - width)
        window = codes[..., s:s + width]
    else:
        idx = (start[..., None].to(torch.int64) + offs).clamp(0, L - 1)
        window = torch.take_along_dim(codes, idx, dim=-1)
    return i32((window.to(torch.int64) << (2 * offs)).sum(dim=-1))


def pack_np(codes: np.ndarray) -> np.ndarray:
    """Host-side pack, same layout (delegates to io.packing)."""
    from ..io.packing import pack_codes
    return pack_codes(codes)


def _word_shift_left(pk: torch.Tensor, q: int) -> torch.Tensor:
    """out[w] = pk[w+q] (zeros beyond) — static word shift."""
    if q == 0:
        return pk
    W = pk.shape[-1]
    if q >= W:
        return torch.zeros_like(pk)
    return torch.cat([pk[..., q:], pk.new_zeros((*pk.shape[:-1], q))], dim=-1)


def _word_shift_right(pk: torch.Tensor, q: int) -> torch.Tensor:
    if q == 0:
        return pk
    W = pk.shape[-1]
    if q >= W:
        return torch.zeros_like(pk)
    return torch.cat([pk.new_zeros((*pk.shape[:-1], q)), pk[..., :-q]], dim=-1)


def shift_bases_left(pk: torch.Tensor, s: torch.Tensor,
                     max_shift: int) -> torch.Tensor:
    """Packed equivalent of codes[..., p] = codes[..., p + s] (zero fill).

    pk: (..., W); s: (...,) per-row base shift in [0, max_shift]. The word
    part of s selects among static word shifts (shifts past max_shift leave
    the word part unshifted, as the JAX select chain does)."""
    q = (s // BASES_PER_WORD)[..., None]
    r2 = (2 * (s % BASES_PER_WORD))[..., None].to(pk.dtype)
    out = pk
    for qq in range(1, max_shift // BASES_PER_WORD + 1):
        out = torch.where(q == qq, _word_shift_left(pk, qq), out)
    hi = _word_shift_left(out, 1)
    shifted = srl_var(out, r2) | (hi << (32 - r2))
    return torch.where(r2 > 0, shifted, out)


def shift_bases_right(pk: torch.Tensor, s: torch.Tensor,
                      max_shift: int) -> torch.Tensor:
    """Packed equivalent of out[..., p] = codes[..., p - s] (zero fill)."""
    q = (s // BASES_PER_WORD)[..., None]
    r2 = (2 * (s % BASES_PER_WORD))[..., None].to(pk.dtype)
    out = pk
    for qq in range(1, max_shift // BASES_PER_WORD + 1):
        out = torch.where(q == qq, _word_shift_right(pk, qq), out)
    lo = _word_shift_right(out, 1)
    shifted = (out << r2) | srl_var(lo, 32 - r2)
    return torch.where(r2 > 0, shifted, out)


def _reverse_lanes(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit lanes within each 32-bit word."""
    x = ((x & 0x33333333) << 2) | (srl(x, 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | (srl(x, 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | (srl(x, 8) & 0x00FF00FF)
    return (x << 16) | srl(x, 16)


def revcomp_packed(pk: torch.Tensor, nbases: torch.Tensor) -> torch.Tensor:
    """Packed reverse complement within each row's own length.

    pk: (..., W); nbases: (...,). Bits beyond nbases must be zero on input;
    the output also has zeros beyond nbases."""
    W = pk.shape[-1]
    full = _reverse_lanes(~pk).flip(-1)   # reverse of the full W*16 window
    # the reversed read sits at the top; slide it down by W*16 - nbases.
    # padding lanes of ~pk are 0b11 (T) — the left shift drops exactly those
    return shift_bases_left(full, W * BASES_PER_WORD - nbases,
                            W * BASES_PER_WORD)


def shift_bases_left_static(pk: torch.Tensor, s: int) -> torch.Tensor:
    """Static-shift variant of shift_bases_left."""
    a, b = divmod(s, BASES_PER_WORD)
    out = _word_shift_left(pk, a)
    if b == 0:
        return out
    hi = _word_shift_left(out, 1)
    return srl(out, 2 * b) | (hi << (32 - 2 * b))


def shift_bases_right_static(pk: torch.Tensor, s: int) -> torch.Tensor:
    a, b = divmod(s, BASES_PER_WORD)
    out = _word_shift_right(pk, a)
    if b == 0:
        return out
    lo = _word_shift_right(out, 1)
    return (out << (2 * b)) | srl(lo, 32 - 2 * b)


def extract_key_packed(pk: torch.Tensor, start: int) -> torch.Tensor:
    """16-base key at static base offset ``start`` from packed rows."""
    a, b = divmod(start, BASES_PER_WORD)
    lo = pk[..., a]
    if b == 0:
        return lo
    W = pk.shape[-1]
    hi = pk[..., a + 1] if a + 1 < W else torch.zeros_like(lo)
    return srl(lo, 2 * b) | (hi << (32 - 2 * b))
