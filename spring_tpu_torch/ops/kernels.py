"""Masked Hamming verify: plain PyTorch references and the CUDA kernels.

Port of spring_tpu/ops/pallas_kernels.py::masked_hamming (the repo's one
Pallas TPU kernel). Given packed comparison frames and candidate rows,
count base mismatches over a per-element base range [lo, hi) — the inner
loop of SPRING's matching (``((ref^read)&mask).count()``,
src/reorder.h:292-301).

``verify_rows`` is the reorder round's whole verify stage in one launch:
the candidate-row fetch from the row table, the claimed-bitmap test, the
range and offset of each slot, the masked Hamming and the accept test
(spring_tpu/reorder/engine.py, "verify: ONE (B, M) row gather + masked
popcounts", one XLA fusion there). ``masked_hamming`` keeps the JAX
signature and its word-major (W, B, K) layout; ``masked_hamming_rows``
takes row-major (B, M, W) frames and (B, M, W+1) rows (the length word is
not read). All three run csrc/masked_hamming.cu on CUDA tensors and their
plain version (``verify_rows_ref``, ``masked_hamming_ref``) on CPU tensors;
any other device raises, and nothing falls back on the card. Each wrapper
adds one to its own ``launches`` where it launches its kernel, through
``graphs.count``: a launch captured into a CUDA graph counts at each
replay of the graph, not at the capture. The
``*_device_ms`` functions time launches on the card with no host call
between them (a replayed CUDA graph of ``reps`` launches).
"""
from __future__ import annotations

import ctypes

import torch

from . import bits, graphs

_I32 = torch.int32


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


def verify_rows_ref(rows_tab: torch.Tensor, cand: torch.Tensor,
                    valid: torch.Tensor, claimed: torch.Tensor,
                    frames: torch.Tensor, k_frame: torch.Tensor,
                    shift_base: torch.Tensor, ref_len: torch.Tensor,
                    thresh: int):
    """Plain PyTorch verify stage of the reorder round (see verify_rows):
    (ok, t, clen, ham), each (B, M)."""
    Np, W = rows_tab.shape[0], rows_tab.shape[1] - 1
    B, M = cand.shape
    safe = cand.clamp(0, Np - 1)
    rows = rows_tab[safe]                             # (B, M, W+1)
    claimed_row = ((claimed[safe >> 5] >> (safe & 31)) & 1) == 1
    clen = rows[..., W] & 0x7FFFFFFF
    rl = ref_len[:, None]
    fwd = (k_frame & 1) == 0
    s = shift_base[:, None] + (k_frame >> 1)
    lo = torch.where(fwd, 0, s)
    hi = torch.where(fwd, torch.minimum(rl - s, clen),
                     torch.minimum(rl + s, clen))
    t = torch.where(fwd, s, rl + s - clen)
    frow = torch.gather(frames.reshape(B, -1, W), 1,
                        k_frame.to(torch.int64)[:, :, None].expand(B, M, W))
    ham = masked_hamming_ref(frow.movedim(-1, 0),
                             rows[..., :W].movedim(-1, 0), lo, hi)
    ok = valid & ~claimed_row & (ham <= thresh) & (t >= 0) & (hi > lo)
    return ok, t, clen, ham


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


def _raise_cuda(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _dev_index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def _ham_args(frames, rows, lo, hi, out, W, strides) -> tuple:
    dev = lo.device
    return (frames.data_ptr(), rows.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), out.data_ptr(), lo.numel(), W, *strides,
            _dev_index(dev), _stream(dev))


def _launch(frames, rows, lo, hi, W: int, strides: tuple) -> torch.Tensor:
    from . import _build
    lib = _build.load()
    out = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    _raise_cuda("masked_hamming", lib.stpu_masked_hamming(
        *_ham_args(frames, rows, lo, hi, out, W, strides)))
    return out


def _device_kind(lo: torch.Tensor) -> str:
    if lo.device.type not in ("cuda", "cpu"):
        raise ValueError(f"masked_hamming: unsupported device {lo.device}")
    return lo.device.type


def _word_major(frames, rows, lo, hi) -> tuple:
    """Checked (W, strides) of the word-major layout."""
    _check(frames, rows, lo, hi)
    if frames.shape != rows.shape or tuple(rows.shape[1:]) != tuple(lo.shape):
        raise ValueError(f"masked_hamming: frames {tuple(frames.shape)}, "
                         f"rows {tuple(rows.shape)}, lo {tuple(lo.shape)}")
    n = lo.numel()
    return rows.shape[0], (n, 1, n, 1)


def _row_major(frames, rows, lo, hi) -> tuple:
    """Checked (W, strides) of the row-major layout."""
    _check(frames, rows, lo, hi)
    W = frames.shape[-1]
    Wr = rows.shape[-1]
    if (tuple(frames.shape[:-1]) != tuple(lo.shape)
            or tuple(rows.shape[:-1]) != tuple(lo.shape) or Wr < W):
        raise ValueError(f"masked_hamming_rows: frames "
                         f"{tuple(frames.shape)}, rows {tuple(rows.shape)}, "
                         f"lo {tuple(lo.shape)}")
    return W, (1, W, 1, Wr)


def masked_hamming(frames: torch.Tensor, rows: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Masked Hamming, word-major layout (the JAX kernel's signature).

    frames/rows: (W, B, K) int32 packed words; lo/hi: (B, K) int32 base
    ranges. Returns (B, K) int32 mismatch counts."""
    W, strides = _word_major(frames, rows, lo, hi)
    if _device_kind(lo) == "cpu":
        return masked_hamming_ref(frames, rows, lo, hi)
    out = _launch(frames, rows, lo, hi, W, strides)
    graphs.count(masked_hamming)
    return out


def masked_hamming_rows(frames: torch.Tensor, rows: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Masked Hamming, row-major layout.

    frames: (*S, W) int32; rows: (*S, Wr) int32 with Wr >= W (rows may
    carry a length word after the W data words); lo/hi: (*S) int32.
    Returns (*S) int32 mismatch counts over the first W words."""
    W, strides = _row_major(frames, rows, lo, hi)
    if _device_kind(lo) == "cpu":
        return masked_hamming_ref(frames.movedim(-1, 0),
                                  rows[..., :W].movedim(-1, 0), lo, hi)
    out = _launch(frames, rows, lo, hi, W, strides)
    graphs.count(masked_hamming_rows)
    return out


def masked_hamming_device_ms(frames, rows, lo, hi, row_major: bool = False,
                             reps: int = 200) -> float:
    """Device milliseconds of one masked-Hamming launch: the library
    captures ``reps`` launches into a CUDA graph and takes CUDA events
    around one replay of it (no host call between the launches), after a
    warm-up replay. CUDA tensors only; the launches are not added to
    ``launches``."""
    W, strides = (_row_major if row_major else _word_major)(
        frames, rows, lo, hi)
    if lo.device.type != "cuda":
        raise ValueError("masked_hamming_device_ms: needs CUDA tensors, "
                         f"got {lo.device}")
    from . import _build
    lib = _build.load()
    out = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    ms = ctypes.c_float()
    _raise_cuda("masked_hamming (timed)", lib.stpu_masked_hamming_timed(
        *_ham_args(frames, rows, lo, hi, out, W, strides), reps,
        ctypes.byref(ms)))
    return float(ms.value)


def _verify_dims(rows_tab, cand, valid, claimed, frames, k_frame,
                 shift_base, ref_len) -> tuple:
    """(B, M, W, F, Np) of checked verify_rows inputs; raises TypeError on
    a wrong dtype and ValueError on a wrong device, shape or layout."""
    dev = rows_tab.device
    shape = cand.shape
    if (rows_tab.dtype == _I32 and cand.dtype == _I32
            and valid.dtype == torch.bool and claimed.dtype == _I32
            and frames.dtype == _I32 and k_frame.dtype == _I32
            and shift_base.dtype == _I32 and ref_len.dtype == _I32
            and cand.device == dev and valid.device == dev
            and claimed.device == dev and frames.device == dev
            and k_frame.device == dev and shift_base.device == dev
            and ref_len.device == dev
            and rows_tab.dim() == 2 and len(shape) == 2
            and valid.shape == shape and k_frame.shape == shape
            and claimed.dim() == 1 and frames.dim() in (3, 4)
            and frames.shape[0] == shape[0]
            and frames.shape[-1] == rows_tab.shape[1] - 1 >= 1
            and shift_base.shape == shape[:1] and ref_len.shape == shape[:1]
            and claimed.shape[0] * 32 >= rows_tab.shape[0] >= 1
            and rows_tab.is_contiguous() and cand.is_contiguous()
            and valid.is_contiguous() and claimed.is_contiguous()
            and frames.is_contiguous() and k_frame.is_contiguous()
            and shift_base.is_contiguous() and ref_len.is_contiguous()):
        W = frames.shape[-1]
        return (shape[0], shape[1], W, frames.numel() // (shape[0] * W)
                if shape[0] else 0, rows_tab.shape[0])
    # the slow path only names the fault
    named = dict(rows_tab=rows_tab, cand=cand, valid=valid, claimed=claimed,
                 frames=frames, k_frame=k_frame, shift_base=shift_base,
                 ref_len=ref_len)
    for name, t in named.items():
        want = torch.bool if name == "valid" else _I32
        if t.dtype != want:
            raise TypeError(f"verify_rows: {name} must be {want}, got "
                            f"{t.dtype}")
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"verify_rows: {name} is on {t.device}, "
                             f"rows_tab on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"verify_rows: {name} must be contiguous")
    raise ValueError(
        "verify_rows: want rows_tab (Np, W+1), cand/valid/k_frame (B, M), "
        "claimed (>= Np/32,), frames (B, 2*SC, W) or (B, SC, 2, W), "
        "shift_base/ref_len (B,); got "
        + ", ".join(f"{k} {tuple(t.shape)}" for k, t in named.items()))


def _verify_launch(fn, dims, thresh, tensors, extra=()):
    """Allocate the four outputs as one buffer, call the library entry
    ``fn``, and return (ok, t, clen, ham) as views of the buffer."""
    B, M, W, F, Np = dims
    dev = tensors[0].device
    n = B * M
    buf = torch.empty(13 * n, dtype=torch.uint8, device=dev)
    _raise_cuda("verify_rows", fn(
        *[t.data_ptr() for t in tensors], buf.data_ptr(), B, M, W, F, Np,
        int(thresh), _dev_index(dev), _stream(dev), *extra))
    i32 = buf[:12 * n].view(_I32).view(3, B, M)
    return buf[12 * n:].view(torch.bool).view(B, M), i32[1], i32[2], i32[0]


def verify_rows(rows_tab: torch.Tensor, cand: torch.Tensor,
                valid: torch.Tensor, claimed: torch.Tensor,
                frames: torch.Tensor, k_frame: torch.Tensor,
                shift_base: torch.Tensor, ref_len: torch.Tensor,
                thresh: int):
    """The reorder round's verify stage, fused: fetch each candidate's row
    and test it against its walker's frame.

    rows_tab: (Np, W+1) int32 row table (W packed words, then the length
    word: bit 31 marks a padding row, the low 31 bits are the read
    length); cand: (B, M) int32 candidate row ids, clamped to [0, Np-1]
    for every read they index; valid: (B, M) bool; claimed: int32 bitmap of
    at least Np bits; frames: (B, 2*SC, W) or (B, SC, 2, W) int32 packed
    consensus frames (even index forward, odd reverse-complement);
    k_frame: (B, M) int32 frame index of each slot in [0, 2*SC);
    shift_base, ref_len: (B,) int32. With o = k_frame & 1,
    s = shift_base + (k_frame >> 1), clen = the row's length:

        lo, hi, t = (0, min(ref_len - s, clen), s)              if o == 0
                    (s, min(ref_len + s, clen), ref_len + s - clen) else
        ham = masked Hamming of frames[b, k_frame] and the row over [lo, hi)
        ok  = valid & ~claimed[row] & (ham <= thresh) & (t >= 0) & (hi > lo)

    Returns (ok bool, t, clen, ham int32), each (B, M). CUDA tensors go
    through one launch of the hand-written kernel, CPU tensors through
    ``verify_rows_ref``."""
    tensors = (rows_tab, cand, valid, claimed, frames, k_frame, shift_base,
               ref_len)
    dims = _verify_dims(*tensors)
    kind = rows_tab.device.type
    if kind == "cpu":
        return verify_rows_ref(*tensors, thresh)
    if kind != "cuda":
        raise ValueError(f"verify_rows: unsupported device "
                         f"{rows_tab.device}")
    from . import _build
    out = _verify_launch(_build.load().stpu_verify_rows, dims, thresh,
                         tensors)
    graphs.count(verify_rows)
    return out


def verify_rows_device_ms(rows_tab, cand, valid, claimed, frames, k_frame,
                          shift_base, ref_len, thresh: int,
                          reps: int = 200):
    """(device milliseconds of one launch, outputs) of the fused kernel,
    timed as ``masked_hamming_device_ms`` times its kernel.
    CUDA tensors only; the launches are not added to ``launches``."""
    tensors = (rows_tab, cand, valid, claimed, frames, k_frame, shift_base,
               ref_len)
    dims = _verify_dims(*tensors)
    if rows_tab.device.type != "cuda":
        raise ValueError("verify_rows_device_ms: needs CUDA tensors, got "
                         f"{rows_tab.device}")
    from . import _build
    ms = ctypes.c_float()
    out = _verify_launch(
        _build.load().stpu_verify_rows_timed, dims, thresh, tensors,
        extra=(reps, ctypes.byref(ms)))
    return float(ms.value), out


def launch_floor_device_ms(device="cuda", reps: int = 200) -> float:
    """Device milliseconds of one launch of an empty kernel, timed as the
    ``*_device_ms`` functions time theirs: the floor of that timing."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"launch_floor_device_ms: needs a CUDA device, "
                         f"got {dev}")
    from . import _build
    ms = ctypes.c_float()
    _raise_cuda("empty (timed)", _build.load().stpu_empty_timed(
        _dev_index(dev), _stream(dev), reps, ctypes.byref(ms)))
    return float(ms.value)


masked_hamming.launches = 0
masked_hamming_rows.launches = 0
verify_rows.launches = 0
