"""Masked Hamming verify: plain PyTorch reference and the CUDA kernel.

Port of spring_tpu/ops/pallas_kernels.py::masked_hamming (the repo's one
Pallas TPU kernel). Given packed comparison frames and candidate rows,
count base mismatches over a per-element base range [lo, hi) — the inner
loop of SPRING's matching (``((ref^read)&mask).count()``,
src/reorder.h:292-301).

``masked_hamming`` keeps the JAX signature and its word-major (W, B, K)
layout; ``masked_hamming_rows`` takes the reorder round's row-major
(B, M, W) frames and gathered (B, M, W+1) rows (the length word is not
read). Both run the same kernel (csrc/masked_hamming.cu) on CUDA tensors
and ``masked_hamming_ref`` on CPU tensors; any other device raises. Every
kernel launch adds one to ``masked_hamming.launches``.
"""
from __future__ import annotations

import torch

from . import bits


def masked_hamming_ref(frames: torch.Tensor, rows: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch masked Hamming, word-major: frames/rows (W, *S) int32
    packed words, lo/hi (*S) int32 base ranges -> (*S) int32 counts."""
    acc = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
    for w in range(rows.shape[0]):
        d = frames[w] ^ rows[w]
        m = (d | bits.srl(d, 1)) & bits.ODD_MASK
        mw = bits.prefix_word(hi - 16 * w) & ~bits.prefix_word(lo - 16 * w)
        acc += bits.popcount32(m & mw)
    return acc


def _check(frames, rows, lo, hi) -> None:
    for name, t in (("frames", frames), ("rows", rows), ("lo", lo),
                    ("hi", hi)):
        if t.dtype != torch.int32:
            raise TypeError(f"masked_hamming: {name} must be int32 "
                            f"(uint32 bit patterns), got {t.dtype}")
        if t.device != lo.device:
            raise ValueError(f"masked_hamming: {name} is on {t.device}, "
                             f"lo on {lo.device}")
        if not t.is_contiguous():
            raise ValueError(f"masked_hamming: {name} must be contiguous")
    if hi.shape != lo.shape:
        raise ValueError(f"masked_hamming: lo {tuple(lo.shape)} vs hi "
                         f"{tuple(hi.shape)}")


def _launch(frames, rows, lo, hi, W: int, f_word: int, f_row: int,
            r_word: int, r_row: int) -> torch.Tensor:
    from . import _build
    lib = _build.load()
    out = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = lib.stpu_masked_hamming(
            frames.data_ptr(), rows.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), lo.numel(), W, f_word, f_row, r_word, r_row,
            stream)
    if err != 0:
        raise RuntimeError(f"masked_hamming kernel launch failed: "
                           f"cudaError {err}")
    masked_hamming.launches += 1
    return out


def _device_kind(lo: torch.Tensor) -> str:
    if lo.device.type not in ("cuda", "cpu"):
        raise ValueError(f"masked_hamming: unsupported device {lo.device}")
    return lo.device.type


def masked_hamming(frames: torch.Tensor, rows: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Masked Hamming, word-major layout (the JAX kernel's signature).

    frames/rows: (W, B, K) int32 packed words; lo/hi: (B, K) int32 base
    ranges. Returns (B, K) int32 mismatch counts."""
    _check(frames, rows, lo, hi)
    W = rows.shape[0]
    if frames.shape != rows.shape or tuple(rows.shape[1:]) != tuple(lo.shape):
        raise ValueError(f"masked_hamming: frames {tuple(frames.shape)}, "
                         f"rows {tuple(rows.shape)}, lo {tuple(lo.shape)}")
    if _device_kind(lo) == "cpu":
        return masked_hamming_ref(frames, rows, lo, hi)
    n = lo.numel()
    return _launch(frames, rows, lo, hi, W, n, 1, n, 1)


def masked_hamming_rows(frames: torch.Tensor, rows: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Masked Hamming, row-major layout of the reorder round.

    frames: (*S, W) int32; rows: (*S, Wr) int32 with Wr >= W (the round's
    rows carry a length word after the W data words); lo/hi: (*S) int32.
    Returns (*S) int32 mismatch counts over the first W words."""
    _check(frames, rows, lo, hi)
    W = frames.shape[-1]
    Wr = rows.shape[-1]
    if (tuple(frames.shape[:-1]) != tuple(lo.shape)
            or tuple(rows.shape[:-1]) != tuple(lo.shape) or Wr < W):
        raise ValueError(f"masked_hamming_rows: frames "
                         f"{tuple(frames.shape)}, rows {tuple(rows.shape)}, "
                         f"lo {tuple(lo.shape)}")
    if _device_kind(lo) == "cpu":
        return masked_hamming_ref(frames.movedim(-1, 0),
                                  rows[..., :W].movedim(-1, 0), lo, hi)
    return _launch(frames, rows, lo, hi, W, 1, W, 1, Wr)


masked_hamming.launches = 0
