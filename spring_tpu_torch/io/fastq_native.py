"""Copied from spring_tpu/io/fastq_native.py; only the imports differ.

Native (C++) FASTQ/FASTA loading into dense arrays.

Reference analog: the block reader src/util.cpp:31-54, but instead of
string vectors the whole file lands in fixed-shape arrays ready for the
device: codes (n, maxlen) uint8, lengths, quality matrix, id blob+lengths.
This is the short-read-mode fast path; the streaming Python reader
(io/fastq.py) remains for long mode where maxlen is unbounded.
"""
from __future__ import annotations

import ctypes
import gzip
import os
from dataclasses import dataclass

import numpy as np

from ..codecs import native


@dataclass
class FastqArrays:
    codes: np.ndarray      # (n, maxlen) uint8, 0..4
    lengths: np.ndarray    # (n,) int32
    quals: np.ndarray | None   # (n, maxlen) uint8 raw bytes, 0-padded
    idbuf: np.ndarray      # concatenated id bytes (uint8)
    idlens: np.ndarray     # (n,) uint32
    n: int
    maxlen: int

    def id_at(self, i: int) -> bytes:
        off = int(self.idlens[:i].sum())
        return self.idbuf[off:off + int(self.idlens[i])].tobytes()

    def ids_list(self) -> list[bytes]:
        offs = np.concatenate([[0], np.cumsum(self.idlens)]).astype(np.int64)
        buf = self.idbuf.tobytes()
        return [buf[offs[i]:offs[i + 1]] for i in range(self.n)]


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


@dataclass
class ScanInfo:
    """Result of the serial scan pass over one input buffer."""
    n: int
    maxlen: int
    idbytes: int
    ckpt_byte: np.ndarray
    ckpt_id: np.ndarray


def open_buf(path: str) -> np.ndarray:
    """Input bytes as a uint8 array backed by the page cache, not the heap:
    plain files are mmap'd; gzip inputs are stream-decompressed to an
    unlinked temp file and mmap'd (the reference streams gz through zlib
    the same block-wise way, src/util.h). Peak RSS stays O(output arrays)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"\x1f\x8b":
        if os.path.getsize(path) == 0:
            return np.empty(0, np.uint8)
        return np.memmap(path, dtype=np.uint8, mode="r")
    import tempfile
    try:
        tmp = tempfile.TemporaryFile(dir=os.path.dirname(path) or ".")
    except OSError:
        tmp = tempfile.TemporaryFile()
    with gzip.open(path, "rb") as g:
        while True:
            chunk = g.read(1 << 24)
            if not chunk:
                break
            tmp.write(chunk)
    tmp.flush()
    size = tmp.tell()
    if size == 0:
        return np.empty(0, np.uint8)
    buf = np.memmap(tmp, dtype=np.uint8, mode="r", shape=(size,))
    # the memmap holds its own reference to the fd; the unlinked temp file
    # disappears when the array is garbage collected
    return buf


def scan_buf(buf: np.ndarray, path: str, fasta: bool = False,
             require_quals: bool = True) -> ScanInfo:
    """Serial scan pass: counts + parallel-parse checkpoints."""
    lib = native.load()
    stride = lib.stpu_fastq_ckpt_stride()
    cap = len(buf) // (2 * stride) + 2
    ckpt_b = np.zeros(cap, np.int64)
    ckpt_i = np.zeros(cap, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = ctypes.c_int64()
    maxlen = ctypes.c_int64()
    idbytes = ctypes.c_int64()
    qmis = ctypes.c_int64()
    # the native scan is ONE sequential pass over the whole mapping, so
    # without intervention peak RSS ≈ file size (23.4 GB measured on a
    # 100M-read input). A watcher thread drops the file-backed pages
    # every couple of seconds while the scan runs; the scanner re-faults
    # only its current window from the page cache (minor faults).
    stop = None
    if getattr(buf, "_mmap", None) is not None and len(buf) >= (2 << 30):
        import threading
        stop = threading.Event()

        def _reap():
            while not stop.wait(2.0):
                _drop_pages(buf)

        threading.Thread(target=_reap, daemon=True).start()
    try:
        rc = lib.stpu_fastq_scan(_u8p(buf), len(buf), int(fasta),
                                 ctypes.byref(n), ctypes.byref(maxlen),
                                 ctypes.byref(idbytes), ctypes.byref(qmis),
                                 ckpt_b.ctypes.data_as(i64p),
                                 ckpt_i.ctypes.data_as(i64p))
    finally:
        if stop is not None:
            stop.set()
    if rc != 0:
        raise ValueError(f"{path}: truncated FASTQ record")
    if not fasta and require_quals and qmis.value:
        raise ValueError(f"{path}: quality length != read length "
                         "(FASTA input needs --fasta-input)")
    _drop_pages(buf)          # scan touched every page; parse re-faults
    return ScanInfo(n.value, maxlen.value, idbytes.value, ckpt_b, ckpt_i)


def _drop_pages(buf: np.ndarray, start: int = 0, end: int | None = None
                ) -> None:
    """madvise(MADV_DONTNEED) a byte range of a file-backed memmap: the
    pages leave this process's RSS but stay in the kernel page cache, so a
    later access is a minor fault, not disk I/O. Peak RSS would otherwise
    hold the whole input text alongside the output arrays. No-op for
    non-memmap buffers (anonymous DONTNEED would ZERO heap pages)."""
    # below ~1 GB the whole input comfortably fits beside the outputs and
    # the re-fault cost (~0.3-0.5 s/GB on this host) isn't worth paying
    mm = getattr(buf, "_mmap", None)
    if mm is None or len(buf) < (1 << 30):
        return
    import mmap as _mmap
    page = _mmap.PAGESIZE
    end = len(buf) if end is None else end
    a = -(-start // page) * page          # align start up
    b = (end // page) * page              # align end down
    if b > a:
        try:
            mm.madvise(_mmap.MADV_DONTNEED, a, b - a)
        except (AttributeError, OSError, ValueError):
            pass


# records per parse segment; after each segment its input pages are dropped
# from RSS (multiple of the checkpoint stride)
_SEG_RECORDS = 1 << 19


def ckpt_stride() -> int:
    return int(native.load().stpu_fastq_ckpt_stride())


def parse_packed_into(buf: np.ndarray, path: str, info: ScanInfo, ml: int,
                      packed: np.ndarray, lengths: np.ndarray,
                      quals: np.ndarray | None, idbuf: np.ndarray,
                      idlens: np.ndarray, fasta: bool = False,
                      num_threads: int = 0, qual_sink=None,
                      row_sink=None) -> np.ndarray:
    """Record-parallel parse straight into caller-owned array slices:
    packed (n, ceil(ml/16)) 2-bit rows (N packs as A), lengths, quality
    rows at stride ml, id blob. Returns the N-position (rid, pos) pairs
    (int32 (k, 2), unsorted). The byte codes matrix never exists, and
    input pages are released segment by segment (peak RSS = output arrays
    + one ~128 MB window, not input + outputs).

    With ``qual_sink``, quality rows never land in a file-sized matrix:
    each segment parses into a reused (seg, ml) staging buffer and
    ``qual_sink(r0, rows)`` consumes it before the next segment (rows is
    only valid during the call — copy or compress, don't keep). This is
    what bounds compress-side quality memory by O(segment), the analog of
    the reference's block-streamed preprocess (src/preprocess.cpp:141-285).
    """
    lib = native.load()
    stride = lib.stpu_fastq_ckpt_stride()
    assert _SEG_RECORDS % stride == 0
    n = info.n
    exc_parts = []
    staging = None
    if qual_sink is not None and n:
        staging = np.empty((min(_SEG_RECORDS, n), ml), np.uint8)
    for r0 in range(0, max(n, 1), _SEG_RECORDS):
        n_seg = min(_SEG_RECORDS, n - r0)
        if n_seg <= 0:
            break
        c0 = r0 // stride
        nck = -(-n_seg // stride)
        cki = np.ascontiguousarray(
            info.ckpt_id[c0:c0 + nck] - info.ckpt_id[c0])
        idbase = int(info.ckpt_id[c0])
        qdst = (staging[:n_seg] if staging is not None
                else quals[r0:r0 + n_seg] if quals is not None else None)
        exc = _parse_segment(
            lib, buf, path, fasta, ml, n_seg, packed[r0:r0 + n_seg],
            lengths[r0:r0 + n_seg], qdst,
            idbuf[idbase:], idlens[r0:r0 + n_seg],
            np.ascontiguousarray(info.ckpt_byte[c0:c0 + nck]), cki,
            num_threads)
        if staging is not None:
            qual_sink(r0, staging[:n_seg])
        if row_sink is not None:
            # overlap the packed-rows device transfer with the parse
            row_sink(r0, packed[r0:r0 + n_seg])
        if len(exc):
            exc[:, 0] += r0
            exc_parts.append(exc)
        seg_end = (int(info.ckpt_byte[c0 + nck])
                   if c0 + nck < len(info.ckpt_byte) and r0 + n_seg < n
                   else len(buf))
        _drop_pages(buf, int(info.ckpt_byte[c0]), seg_end)
    return (np.concatenate(exc_parts) if exc_parts
            else np.empty((0, 2), np.int32))


def _parse_segment(lib, buf, path, fasta, ml, n, packed, lengths, quals,
                   idbuf, idlens, ckpt_byte, ckpt_id,
                   num_threads) -> np.ndarray:
    i64p = ctypes.POINTER(ctypes.c_int64)
    cap = max(4096, n // 8)
    for _ in range(2):
        exc = np.empty((cap, 2), np.int32)
        exc_n = ctypes.c_int64()
        rc = lib.stpu_fastq_parse_packed(
            _u8p(buf), len(buf), int(fasta), n, ml,
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _u8p(quals) if quals is not None else
            _u8p(np.empty(1, np.uint8)),
            int(quals is not None), _u8p(idbuf),
            idlens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ckpt_byte.ctypes.data_as(i64p),
            ckpt_id.ctypes.data_as(i64p),
            exc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            ctypes.byref(exc_n), num_threads)
        if rc != 0:
            raise ValueError(
                f"{path}: read {-rc} contains a non-ACGTN character")
        if exc_n.value <= cap:
            return exc[: exc_n.value]
        cap = exc_n.value          # rare: N-heavy input; retry exact-size
    raise AssertionError("unreachable: exact-capacity retry overflowed")


def load_file(path: str, fasta: bool = False,
              want_quals: bool = True) -> FastqArrays:
    with open(path, "rb") as f:
        magic = f.read(2)
        f.seek(0)
        raw = f.read()
    if magic == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    buf = np.frombuffer(raw, dtype=np.uint8)
    lib = native.load()
    stride = lib.stpu_fastq_ckpt_stride()
    # generous checkpoint capacity: records <= size/2 lines
    cap = len(buf) // (2 * stride) + 2
    ckpt_b = np.zeros(cap, np.int64)
    ckpt_i = np.zeros(cap, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = ctypes.c_int64()
    maxlen = ctypes.c_int64()
    idbytes = ctypes.c_int64()
    qmis = ctypes.c_int64()
    rc = lib.stpu_fastq_scan(_u8p(buf), len(buf), int(fasta),
                             ctypes.byref(n), ctypes.byref(maxlen),
                             ctypes.byref(idbytes), ctypes.byref(qmis),
                             ckpt_b.ctypes.data_as(i64p),
                             ckpt_i.ctypes.data_as(i64p))
    if rc != 0:
        raise ValueError(f"{path}: truncated FASTQ record")
    if not fasta and qmis.value:
        raise ValueError(f"{path}: quality length != read length "
                         "(FASTA input needs --fasta-input)")
    n_v, ml = n.value, max(maxlen.value, 1)
    codes = np.empty((n_v, ml), np.uint8)
    lengths = np.empty(n_v, np.int32)
    quals = (np.empty((n_v, ml), np.uint8)
             if (want_quals and not fasta) else None)
    idbuf = np.empty(max(idbytes.value, 1), np.uint8)
    idlens = np.empty(max(n_v, 1), np.uint32)
    rc = lib.stpu_fastq_parse(
        _u8p(buf), len(buf), int(fasta), n_v, ml, _u8p(codes),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8p(quals) if quals is not None else _u8p(np.empty(1, np.uint8)),
        int(quals is not None), _u8p(idbuf),
        idlens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ckpt_b.ctypes.data_as(i64p), ckpt_i.ctypes.data_as(i64p), 0)
    if rc != 0:
        raise ValueError(
            f"{path}: read {-rc} contains a non-ACGTN character")
    return FastqArrays(codes=codes, lengths=lengths, quals=quals,
                       idbuf=idbuf, idlens=idlens, n=n_v, maxlen=maxlen.value)


def pack_2bit(codes: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """C-parallel equivalent of packing.pack_codes (same layout)."""
    n, L = codes.shape
    W = -(-L // 16)
    out = np.empty((n, W), np.uint32)
    codes = np.ascontiguousarray(codes)
    native.load().stpu_pack_2bit(
        _u8p(codes), n, L, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        num_threads)
    return out


def unpack_2bit(packed: np.ndarray, L: int,
                num_threads: int = 0) -> np.ndarray:
    """packed (n, W) uint32 -> codes (n, L) uint8 0-3 (inverse of pack_2bit
    for N-free rows; callers overlay N positions separately)."""
    n, W = packed.shape
    out = np.empty((n, L), np.uint8)
    packed = np.ascontiguousarray(packed)
    native.load().stpu_unpack_2bit(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n, W, L,
        _u8p(out), num_threads)
    return out


def pe_id_first_mismatch(idbuf: np.ndarray, idoffs: np.ndarray,
                         per_file: int, code: int) -> int:
    """Index of the first pair (id i, id per_file + i) that fails
    ids.check_id_pattern under ``code``, or ``per_file`` when every pair
    matches: one native pass over the id blob (id k is
    ``idbuf[idoffs[k]:idoffs[k + 1]]``), the interpreter lock released."""
    if code not in (1, 2, 3):
        raise ValueError(f"invalid paired id code {code}")
    offs = idoffs[:2 * per_file + 1]
    if (idbuf.dtype != np.uint8 or offs.dtype != np.int64
            or not idbuf.flags.c_contiguous or not offs.flags.c_contiguous):
        raise ValueError("idbuf must be contiguous uint8, idoffs int64")
    if (per_file < 0 or len(offs) != 2 * per_file + 1 or offs[0] < 0
            or offs[-1] > len(idbuf) or np.any(offs[1:] < offs[:-1])):
        raise ValueError("idoffs must be 2 * per_file + 1 nondecreasing "
                         "offsets into idbuf")
    return int(native.load().stpu_pe_id_check(
        _u8p(idbuf), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        per_file, code))


def format_records(chars: np.ndarray, lens: np.ndarray,
                   quals: np.ndarray | None, idbuf: np.ndarray,
                   idlens: np.ndarray) -> bytes:
    """Render FASTQ (4-line) or FASTA-style (2-line) records to bytes."""
    n, L = chars.shape
    bound = (int(idlens.sum()) + int(lens.sum()) * (2 if quals is not None
                                                    else 1)
             + n * (4 + (2 if quals is not None else 0)) + 16)
    dst = np.empty(bound, np.uint8)
    lib = native.load()
    w = lib.stpu_fastq_format(
        _u8p(np.ascontiguousarray(chars)),
        np.ascontiguousarray(lens.astype(np.int32)).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)),
        _u8p(np.ascontiguousarray(quals)) if quals is not None else None,
        _u8p(np.ascontiguousarray(idbuf)),
        np.ascontiguousarray(idlens.astype(np.uint32)).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)),
        n, L, _u8p(dst))
    return dst[:w].tobytes()
