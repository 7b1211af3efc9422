"""Copied from spring_tpu/encode/consensus.py; only the imports differ, and
the native layout kernel is always on (no environment switch).

Contig consensus construction and noise extraction (encoder heart).

Reference analog: buildcontig — majority vote over the reads of a contig
(src/encoder.cpp:32-74) — and writecontig which emits per-read pos / noise /
noisepos streams against the consensus (src/encoder.cpp:76-109).

Redesign: instead of walking each contig serially, all contigs are laid out
in one concatenated coordinate space (which is also the final `seq` stream
layout, src/encoder.cpp:111-156) and the consensus is one global scatter-add:
   counts[global_pos, base] += 1  for every base of every read
followed by argmax. Noise is a dense compare of every read against its
consensus window. Both are O(total_bases) vectorized passes (numpy host now;
the arrays are laid out so the same code can move to jnp scatter/gather).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ..codecs import native
from ..io import packing


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

_CHUNK = 1 << 17  # reads per vectorized pass (keeps temporaries cache/
                  # allocator-friendly — fresh large allocations fault at
                  # ~30 MB/s on this host)


@dataclass
class ContigLayout:
    """Concatenated-contig coordinates for the aligned (non-singleton) reads."""
    rids: np.ndarray       # (M,) int32 read ids, contig-major order
    gpos: np.ndarray       # (M,) int64 read start in concatenated seq coords
    rc: np.ndarray         # (M,) uint8
    seq_len: int           # total concatenated consensus length
    # optional per-contig segmentation (filled by layout_from_emissions;
    # needed by the stitching pass)
    cbase: np.ndarray | None = None    # (nc,) int64 contig start in seq
    clen: np.ndarray | None = None     # (nc,) int64 contig length
    ccount: np.ndarray | None = None   # (nc,) int64 reads per contig


def layout_contigs(contigs: list[dict], lengths: np.ndarray,
                   min_reads: int = 2) -> tuple[ContigLayout, np.ndarray]:
    """Assign global coordinates to every contig with >= min_reads reads.

    Returns (layout, singleton_rids). Singleton contigs do not pay for a
    consensus copy in `seq` — their reads go to the literal stream (the
    reference instead gives them a second-chance alignment,
    src/encoder.h:242-351 — planned addition).
    """
    rids_l, gpos_l, rc_l = [], [], []
    singles = []
    base = 0
    for c in contigs:
        if len(c["rids"]) < min_reads:
            singles.extend(c["rids"].tolist())
            continue
        ext = c["pos"] + lengths[c["rids"]].astype(np.int64)
        clen = int(ext.max())
        rids_l.append(c["rids"])
        gpos_l.append(c["pos"] + base)
        rc_l.append(c["rc"])
        base += clen
    if rids_l:
        layout = ContigLayout(np.concatenate(rids_l),
                              np.concatenate(gpos_l),
                              np.concatenate(rc_l), base)
    else:
        layout = ContigLayout(np.empty(0, np.int32), np.empty(0, np.int64),
                              np.empty(0, np.uint8), 0)
    return layout, np.array(singles, dtype=np.int32)


def _layout_native(arr: np.ndarray, lengths: np.ndarray, min_reads: int
                   ) -> "tuple[ContigLayout, np.ndarray] | None":
    """csrc/layout.cpp fast path: same outputs as the numpy body of
    layout_from_emissions (ties stable in timeline order)."""
    lib = native.load()
    if not hasattr(lib, "stpu_layout_from_emissions"):
        return None
    arr = np.ascontiguousarray(arr, np.int32)
    lens32 = np.ascontiguousarray(lengths, np.int32)
    n = len(arr)
    rid_out = np.empty(n, np.int32)
    gpos_out = np.empty(n, np.int64)
    rc_out = np.empty(n, np.uint8)
    cbase = np.empty(n, np.int64)
    clen = np.empty(n, np.int64)
    ccount = np.empty(n, np.int64)
    singles = np.empty(n, np.int32)
    counts = np.zeros(4, np.int64)
    rc = lib.stpu_layout_from_emissions(
        _i32p(arr), ctypes.c_int64(n), _i32p(lens32),
        ctypes.c_int64(min_reads), ctypes.c_int32(0),
        _i32p(rid_out), _i64p(gpos_out), _u8p(rc_out), _i64p(cbase),
        _i64p(clen), _i64p(ccount), _i32p(singles), _i64p(counts))
    if rc != 0:
        return None
    k, nc, ns, seq_len = (int(x) for x in counts)
    layout = ContigLayout(rids=rid_out[:k].copy(),
                          gpos=gpos_out[:k].copy(),
                          rc=rc_out[:k].copy(),
                          seq_len=seq_len,
                          cbase=cbase[:nc].copy(),
                          clen=clen[:nc].copy(),
                          ccount=ccount[:nc].copy())
    return layout, singles[:ns].copy()


def layout_from_emissions(emissions: np.ndarray, num_walkers: int,
                          lengths: np.ndarray, min_reads: int = 2,
                          slots: int = 1, ordered: bool = False
                          ) -> tuple[ContigLayout, np.ndarray]:
    """Vectorized emissions -> ContigLayout (replaces the per-walker Python
    loops of assemble_contigs + layout_contigs for the pipeline hot path).

    Semantics match assemble_contigs: walker-major timelines, flag 0 seeds
    a contig, flag 1 extends right (pos = cumsum of deltas), flag 2 is the
    left phase (folds to o = len(first) - q - len(read), rc flipped),
    reads position-sorted per contig.
    """
    if ordered:
        arr = emissions          # already filtered, walker-major
    else:
        R = emissions.shape[0] // (num_walkers * slots)
        em = emissions.reshape(R, num_walkers, slots, 4)
        arr = em.transpose(1, 0, 2, 3).reshape(-1, 4)  # walker-major stream
        arr = arr[arr[:, 0] >= 0]
    if not len(arr):
        return (ContigLayout(np.empty(0, np.int32), np.empty(0, np.int64),
                             np.empty(0, np.uint8), 0),
                np.empty(0, np.int32))
    if len(arr) >= 200_000 and arr[0, 1] == 0:
        # native kernel (csrc/layout.cpp): segmented scan + per-contig
        # parallel sort — the numpy form below costs ~15 s at 10M reads
        # on the 4-core host (semantics identical, asserted in tests)
        out = _layout_native(arr, lengths, min_reads)
        if out is not None:
            return out
    rid = arr[:, 0].astype(np.int32)
    flag = arr[:, 1]
    t = arr[:, 2].astype(np.int64)
    rc = arr[:, 3].astype(np.uint8)
    seg = np.cumsum(flag == 0) - 1                  # contig id per entry
    left = flag == 2
    # segmented cumsum of t over the right part (left entries excluded)
    tr = np.where(left, 0, t)
    cs = np.cumsum(tr)
    seg_first = np.searchsorted(seg, np.arange(seg[-1] + 1), side="left")
    base = cs[seg_first] - tr[seg_first]
    pos = cs - base[seg]
    # left part: segmented cumsum among left entries only
    tl = np.where(left, t, 0)
    csl = np.cumsum(tl)
    basel = csl[seg_first] - tl[seg_first]
    q = csl - basel[seg]
    l0 = lengths[rid[seg_first]].astype(np.int64)
    o = l0[seg] - q - lengths[rid].astype(np.int64)
    pos = np.where(left, o, pos)
    rc = np.where(left, 1 - rc, rc).astype(np.uint8)
    # per-contig min -> 0. Single combined-key introsort instead of
    # np.lexsort: ~3x faster at 10M entries (falls back when the key
    # would overflow int64)
    pmin = pos.min() if len(pos) else 0
    prange = int(pos.max()) - int(pmin) + 1 if len(pos) else 1
    nseg = int(seg[-1]) + 1
    if nseg * prange < (1 << 62):
        # stable: ties keep timeline order, matching the native kernel
        order0 = np.argsort(seg * prange + (pos - pmin), kind="stable")
    else:
        order0 = np.lexsort((pos, seg))
    seg_s, pos_s = seg[order0], pos[order0]
    first_idx = np.searchsorted(seg_s, np.arange(seg[-1] + 1), side="left")
    pos_s = pos_s - pos_s[first_idx][seg_s]
    rid_s, rc_s = rid[order0], rc[order0]
    # contig sizes / extents
    counts = np.bincount(seg_s, minlength=seg[-1] + 1)
    ext = pos_s + lengths[rid_s]
    clen = np.maximum.reduceat(ext, first_idx)
    keep = counts >= min_reads
    singles = rid_s[np.repeat(~keep, counts)]
    km = np.repeat(keep, counts)
    bases = np.concatenate([[0], np.cumsum(np.where(keep, clen, 0))[:-1]])
    gpos = pos_s + bases[seg_s]
    layout = ContigLayout(rids=rid_s[km].astype(np.int32),
                          gpos=gpos[km].astype(np.int64),
                          rc=rc_s[km],
                          seq_len=int(np.where(keep, clen, 0).sum()),
                          cbase=bases[keep].astype(np.int64),
                          clen=clen[keep].astype(np.int64),
                          ccount=counts[keep].astype(np.int64))
    return layout, singles.astype(np.int32)


@dataclass
class NOverlay:
    """Sparse N-position overlay for packed 2-bit rows (N packs as A).

    rows: sorted int32 rids that contain at least one N
    off:  (len(rows)+1,) int64 ragged offsets into pos
    pos:  int32 N positions, per-row ascending
    """
    rows: np.ndarray
    off: np.ndarray
    pos: np.ndarray

    @staticmethod
    def empty() -> "NOverlay":
        return NOverlay(np.empty(0, np.int32), np.zeros(1, np.int64),
                        np.empty(0, np.int32))

    @staticmethod
    def from_pairs(pairs: np.ndarray) -> "NOverlay":
        """(k, 2) int32 (rid, pos) pairs, any order (native parse output)."""
        if not len(pairs):
            return NOverlay.empty()
        order = np.lexsort((pairs[:, 1], pairs[:, 0]))
        p = pairs[order]
        rows, counts = np.unique(p[:, 0], return_counts=True)
        off = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        return NOverlay(rows.astype(np.int32), off,
                        np.ascontiguousarray(p[:, 1], np.int32))

    @staticmethod
    def from_codes(codes: np.ndarray) -> "NOverlay":
        r, c = np.nonzero(codes == packing.N)
        if not len(r):
            return NOverlay.empty()
        rows, counts = np.unique(r, return_counts=True)
        off = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        return NOverlay(rows.astype(np.int32), off, c.astype(np.int32))

    def has_n_mask(self, n: int) -> np.ndarray:
        m = np.zeros(n, bool)
        m[self.rows] = True
        return m

    def nmask_planes(self, rids: np.ndarray, lengths: np.ndarray, L: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Packed N-mask planes (lane value 1 where base is N) for the
        selected reads, forward and length-reversed (the reverse-complement
        row's mask) — the packed-domain feed for second-chance verify."""
        W = -(-L // 16)
        k = len(rids)
        nm_f = np.zeros((k, W), np.uint32)
        nm_r = np.zeros((k, W), np.uint32)
        if not len(self.rows) or not k:
            return nm_f, nm_r
        idx = np.searchsorted(self.rows, rids)
        idx = np.minimum(idx, len(self.rows) - 1)
        hit = self.rows[idx] == rids
        for j in np.nonzero(hit)[0]:        # N-containing reads only
            i = idx[j]
            pos = self.pos[self.off[i]:self.off[i + 1]].astype(np.int64)
            np.bitwise_or.at(nm_f[j], pos >> 4,
                             np.uint32(1) << (2 * (pos & 15)).astype(
                                 np.uint32))
            rp = int(lengths[j]) - 1 - pos
            np.bitwise_or.at(nm_r[j], rp >> 4,
                             np.uint32(1) << (2 * (rp & 15)).astype(
                                 np.uint32))
        return nm_f, nm_r


def unpack_rows(packed: np.ndarray, rids: np.ndarray, L: int,
                overlay: NOverlay | None = None,
                num_threads: int = 0) -> np.ndarray:
    """Gather + unpack selected packed rows to (len(rids), L) uint8 codes,
    restoring N positions from the overlay. The on-demand escape hatch for
    consumers that need byte codes (literal blobs, second-chance rows) —
    the pipeline's resident representation stays packed."""
    from ..io import fastq_native
    sel = np.ascontiguousarray(packed[rids])
    out = fastq_native.unpack_2bit(sel, L, num_threads)
    if overlay is not None and len(overlay.rows):
        idx = np.searchsorted(overlay.rows, rids)
        idx = np.minimum(idx, len(overlay.rows) - 1)
        hit = overlay.rows[idx] == rids
        for j in np.nonzero(hit)[0]:
            i = idx[j]
            out[j, overlay.pos[overlay.off[i]:overlay.off[i + 1]]] = packing.N
    return out


def build_consensus_packed(layout: ContigLayout, packed: np.ndarray,
                           lengths: np.ndarray,
                           num_threads: int = 0) -> np.ndarray:
    """build_consensus straight over packed 2-bit rows (native kernel; no
    codes matrix). Only N-free reads feed the consensus layout, so no
    overlay is needed (N packs as A but never appears here)."""
    lib = native.load()
    packed = np.ascontiguousarray(packed, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    rids = np.ascontiguousarray(layout.rids, np.int32)
    gpos = np.ascontiguousarray(layout.gpos, np.int64)
    rc = np.ascontiguousarray(layout.rc, np.uint8)
    out = np.zeros(layout.seq_len, np.uint8)
    lib.stpu_consensus_p(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        packed.shape[1], _i32p(lengths), _i32p(rids), _i64p(gpos), _u8p(rc),
        len(rids), layout.seq_len, _u8p(out), num_threads)
    return out


def extract_noise_packed(layout: ContigLayout, consensus: np.ndarray,
                         packed: np.ndarray, lengths: np.ndarray,
                         overlay: NOverlay | None = None,
                         num_threads: int = 0
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """extract_noise over packed rows + sparse N overlay (native kernels)."""
    lib = native.load()
    if overlay is None:
        overlay = NOverlay.empty()
    packed = np.ascontiguousarray(packed, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    exc_rows = np.ascontiguousarray(overlay.rows, np.int32)
    exc_off = np.ascontiguousarray(overlay.off, np.int64)
    exc_pos = np.ascontiguousarray(overlay.pos, np.int32)
    rids = np.ascontiguousarray(layout.rids, np.int32)
    gpos = np.ascontiguousarray(layout.gpos, np.int64)
    rc = np.ascontiguousarray(layout.rc, np.uint8)
    consensus = np.ascontiguousarray(consensus, np.uint8)
    M = len(rids)
    W = packed.shape[1]
    pptr = packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    nn = np.zeros(M, np.int32)
    lib.stpu_noise_count_p(pptr, W, _i32p(lengths), _i32p(exc_rows),
                           _i64p(exc_off), _i32p(exc_pos), len(exc_rows),
                           _i32p(rids), _i64p(gpos), _u8p(rc), M,
                           _u8p(consensus), len(consensus), _i32p(nn),
                           num_threads)
    off = np.zeros(M, np.int64)
    if M > 1:
        off[1:] = np.cumsum(nn[:-1], dtype=np.int64)
    K = int(nn.sum())
    npos = np.empty(max(K, 1), np.int32)
    nchar = np.empty(max(K, 1), np.uint8)
    lib.stpu_noise_fill_p(pptr, W, _i32p(lengths), _i32p(exc_rows),
                          _i64p(exc_off), _i32p(exc_pos), len(exc_rows),
                          _i32p(rids), _i64p(gpos), _u8p(rc), M,
                          _u8p(consensus), len(consensus), _i64p(off),
                          _i32p(npos), _u8p(nchar), num_threads)
    return nn, npos[:K], nchar[:K]


def _oriented_codes(codes: np.ndarray, lengths: np.ndarray,
                    rc: np.ndarray) -> np.ndarray:
    out = codes.copy()
    flip = rc.astype(bool)
    if flip.any():
        out[flip] = packing.revcomp_codes(codes[flip], lengths[flip])
    return out


def build_consensus(layout: ContigLayout, codes: np.ndarray,
                    lengths: np.ndarray,
                    num_threads: int = 0) -> np.ndarray:
    """Majority-vote consensus over the concatenated contig space
    (native span-owned counting kernel, csrc/encoder.cpp).

    codes: (N, L) uint8 code rows for ALL reads (indexed by rid).
    Returns (seq_len,) uint8 consensus codes.
    """
    lib = native.load()
    codes = np.ascontiguousarray(codes, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    rids = np.ascontiguousarray(layout.rids, np.int32)
    gpos = np.ascontiguousarray(layout.gpos, np.int64)
    rc = np.ascontiguousarray(layout.rc, np.uint8)
    out = np.zeros(layout.seq_len, np.uint8)
    lib.stpu_consensus(_u8p(codes), codes.shape[1], _i32p(lengths),
                       _i32p(rids), _i64p(gpos), _u8p(rc), len(rids),
                       layout.seq_len, _u8p(out), num_threads)
    return out


def build_consensus_np(layout: ContigLayout, codes: np.ndarray,
                       lengths: np.ndarray) -> np.ndarray:
    """numpy reference implementation of build_consensus (parity tests).

    layout.gpos is nondecreasing (contig-major, cumulative in-contig
    offsets), so each read chunk touches one contiguous window — the
    bincount temporaries stay chunk-sized instead of seq-sized (large fresh
    allocations fault at ~30 MB/s on this host).
    """
    L = codes.shape[1]
    total = layout.seq_len
    out = np.empty(total, dtype=np.uint8)
    M = len(layout.rids)
    carry = np.zeros((0, 4), np.int64)
    carry_lo = 0
    for s in range(0, M, _CHUNK):
        e = min(s + _CHUNK, M)
        rids = layout.rids[s:e]
        rl = lengths[rids]
        cur = _oriented_codes(codes[rids], rl, layout.rc[s:e])
        lo = min(int(layout.gpos[s]), carry_lo)
        hi = max(int((layout.gpos[s:e] + rl).max()),
                 carry_lo + len(carry))
        pos = (layout.gpos[s:e, None] - lo).astype(np.int32) \
            + np.arange(L, dtype=np.int32)[None, :]
        valid = np.arange(L)[None, :] < rl[:, None]
        idx = (pos * 4 + cur)[valid]
        counts = np.bincount(idx, minlength=(hi - lo) * 4).reshape(-1, 4)
        if len(carry):
            counts[carry_lo - lo: carry_lo - lo + len(carry)] += carry
        # positions below the next chunk's first read start are final
        fin = (int(layout.gpos[e]) if e < M else hi) - lo
        out[lo:lo + fin] = np.argmax(counts[:fin], axis=1)
        carry = counts[fin:]
        carry_lo = lo + fin
    if len(carry):
        out[carry_lo: carry_lo + len(carry)] = np.argmax(carry, axis=1)
    return out


def extract_noise(layout: ContigLayout, consensus: np.ndarray,
                  codes: np.ndarray, lengths: np.ndarray,
                  num_threads: int = 0
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-read substitution noise against the consensus (native two-pass
    kernel, csrc/encoder.cpp).

    Returns (nnoise, noisepos, noisechar):
      nnoise:    (M,) int32 mismatch count per aligned read
      noisepos:  (K,) int32 mismatch positions within the (oriented) read,
                 ascending per read, reads in layout order
      noisechar: (K,) uint8 the read's base code at each mismatch
    """
    lib = native.load()
    codes = np.ascontiguousarray(codes, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    rids = np.ascontiguousarray(layout.rids, np.int32)
    gpos = np.ascontiguousarray(layout.gpos, np.int64)
    rc = np.ascontiguousarray(layout.rc, np.uint8)
    consensus = np.ascontiguousarray(consensus, np.uint8)
    M = len(rids)
    nn = np.zeros(M, np.int32)
    L = codes.shape[1]
    lib.stpu_noise_count(_u8p(codes), L, _i32p(lengths), _i32p(rids),
                         _i64p(gpos), _u8p(rc), M, _u8p(consensus),
                         len(consensus), _i32p(nn), num_threads)
    off = np.zeros(M, np.int64)
    if M > 1:
        off[1:] = np.cumsum(nn[:-1], dtype=np.int64)
    K = int(nn.sum())
    npos = np.empty(max(K, 1), np.int32)
    nchar = np.empty(max(K, 1), np.uint8)
    lib.stpu_noise_fill(_u8p(codes), L, _i32p(lengths), _i32p(rids),
                        _i64p(gpos), _u8p(rc), M, _u8p(consensus),
                        len(consensus), _i64p(off), _i32p(npos),
                        _u8p(nchar), num_threads)
    return nn, npos[:K], nchar[:K]


def extract_noise_np(layout: ContigLayout, consensus: np.ndarray,
                     codes: np.ndarray, lengths: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy reference implementation of extract_noise (parity tests)."""
    L = codes.shape[1]
    nn_l, np_l, nc_l = [], [], []
    for s in range(0, len(layout.rids), _CHUNK):
        e = min(s + _CHUNK, len(layout.rids))
        rids = layout.rids[s:e]
        rl = lengths[rids]
        cur = _oriented_codes(codes[rids], rl, layout.rc[s:e])
        pos = layout.gpos[s:e, None] + np.arange(L)[None, :]
        valid = np.arange(L)[None, :] < rl[:, None]
        cons = consensus[np.clip(pos, 0, max(len(consensus) - 1, 0))]
        mm = (cur != cons) & valid
        nn_l.append(mm.sum(axis=1).astype(np.int32))
        rows, cols = np.nonzero(mm)
        np_l.append(cols.astype(np.int32))
        # noise char coded relative to the consensus base: rank among the
        # three bases != ref (N -> 3). Reference analog: the enc_noise
        # substitution table (src/encoder.h:517-537).
        rd = cur[rows, cols].astype(np.int32)
        rf = cons[rows, cols].astype(np.int32)
        rel = np.where(rd == 4, 3, rd - (rd > rf))
        nc_l.append(rel.astype(np.uint8))
    cat = lambda l, d: np.concatenate(l) if l else np.empty(0, d)
    return cat(nn_l, np.int32), cat(np_l, np.int32), cat(nc_l, np.uint8)


def reconstruct_reads(consensus: np.ndarray, gpos: np.ndarray,
                      lengths: np.ndarray, rc: np.ndarray,
                      nnoise: np.ndarray, noisepos: np.ndarray,
                      noisechar: np.ndarray,
                      num_threads: int = 0) -> np.ndarray:
    """Inverse of build/extract: code rows (M, L) for aligned reads
    (native kernel, csrc/encoder.cpp).

    Decoder analog of the read reconstruction hot loop
    (src/decompress.cpp:230-319): seq.substr(pos, len) + noise patch + RC.
    """
    lib = native.load()
    M = len(gpos)
    L = int(lengths.max()) if M else 0
    consensus = np.ascontiguousarray(consensus, np.uint8)
    gpos = np.ascontiguousarray(gpos, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int32)
    rc = np.ascontiguousarray(rc, np.uint8)
    nn = np.ascontiguousarray(nnoise, np.int32)
    npos = np.ascontiguousarray(noisepos, np.int32)
    nchar = np.ascontiguousarray(noisechar, np.uint8)
    off = np.zeros(M, np.int64)
    if M > 1:
        off[1:] = np.cumsum(nn[:-1], dtype=np.int64)
    if M and ((gpos < 0).any()
              or (gpos + lengths.astype(np.int64) > len(consensus)).any()):
        # the encoder guarantees in-range windows; out-of-range means the
        # archive is corrupt (numpy path raised IndexError here)
        raise IndexError("read position outside consensus (corrupt archive)")
    out = np.empty((M, L), np.uint8)
    if M and L:
        lib.stpu_reconstruct(_u8p(consensus), len(consensus), _i64p(gpos),
                             _i32p(lengths), _u8p(rc), _i32p(nn), _i64p(off),
                             _i32p(npos), _u8p(nchar), M, L, _u8p(out),
                             num_threads)
    return out


def reconstruct_reads_np(consensus: np.ndarray, gpos: np.ndarray,
                         lengths: np.ndarray, rc: np.ndarray,
                         nnoise: np.ndarray, noisepos: np.ndarray,
                         noisechar: np.ndarray) -> np.ndarray:
    """numpy reference implementation of reconstruct_reads (parity tests)."""
    M = len(gpos)
    L = int(lengths.max()) if M else 0
    out = np.zeros((M, L), dtype=np.uint8)
    arange_l = np.arange(L, dtype=np.int32)[None, :]
    step = 1 << 16      # keep temporaries cache-sized
    for s in range(0, M, step):
        e = min(s + step, M)
        pos = gpos[s:e, None].astype(np.int32) + arange_l
        valid = arange_l < lengths[s:e, None]
        # out-of-range pos would raise IndexError -> caught by the caller
        # as a corrupt archive; in-range is guaranteed by the encoder
        out[s:e] = consensus[np.where(valid, pos, 0)] * valid
    # patch noise (positions are within the oriented read; chars are coded
    # relative to the consensus base — invert the rank mapping)
    row = np.repeat(np.arange(M), nnoise)
    rf = out[row, noisepos].astype(np.int32)
    rel = noisechar.astype(np.int32)
    out[row, noisepos] = np.where(rel == 3, 4,
                                  rel + (rel >= rf)).astype(np.uint8)
    # un-orient: stored orientation is read-vs-consensus; reconstruct read
    flip = rc.astype(bool)
    if flip.any():
        out[flip] = packing.revcomp_codes(out[flip], lengths[flip])
    return out
