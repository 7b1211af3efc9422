"""The short-mode block streams of the port, written and read here only,
and the codec pool of a compress that writes them.

Members of block b (PE: pairs of file-1 read p and file-2 read p +
per_file; reference src/reorder_compress_streams.cpp:34-64,283-306):
  flag.b  SE: 1 aligned, 0 literal. PE: 0 both mates aligned less than
          32,767 bases apart (pospair.b: their int16 distance, rcpair.b: 1
          where their orientations agree), 1 both farther apart, 2
          neither, 3 read 1 only, 4 read 2 only.
  rlen.b (every read)  pos.b rc.b (aligned; PE: read 1s, then in pos2.b
  and rc.b read 2s of flags 1 and 4)  nn.b npos.b nchar.b (noise of
  aligned reads, PE read 1s then read 2s, positions delta-coded within
  each read, src/encoder.cpp:76-109)  literal.b (literal read bases, PE
  file 1's then file 2's)  id.b quality.b (as in long mode; PE: a pair
  block's file-1 rows then its file-2 rows, id.b file-1 rows alone under
  paired_id_match).
Global member: seq.0, the u64 consensus length and its 2-bit bases.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import params as P
from ..codecs import bsc, idcodec, qv
from ..encode import consensus as cons
from ..encode import streams as st
from ..io import packing
from ..io.container import ArchiveReader
from ..io.ids import modify_id
from ..utils import spans
from . import qualstream
from . import quality as qual_mod

SEQ = "seq.0"
# the families of the read members, seq included (api.py's size report)
READ_STREAMS = ("seq", "flag", "rlen", "pos", "pos2", "pospair", "rcpair",
                "rc", "nn", "npos", "nchar", "literal")


def block_heads(heads: np.ndarray, block: int) -> list[np.ndarray]:
    """The output order of SE reads, or of PE file-1 reads, in blocks."""
    return [heads[s:s + block] for s in range(0, len(heads), block)]


# ---------------- encode ----------------


class ReadTable:
    """What the block streams code of each read, by global read id:
    flag, place, noise (nn bases from noise_off in noisepos / noisechar),
    rank in layout order (-1: literal), and where literals' bases are."""

    def __init__(self, lengths: np.ndarray, ml: int):
        n = len(lengths)
        self.lengths, self.ml, self.placed = lengths, ml, 0
        # int32 metadata: place() keeps the noise offsets below 2^31
        self.flag = np.zeros(n, np.uint8)
        self.gpos = np.zeros(n, np.int32)
        self.rc = np.zeros(n, np.uint8)
        self.nn = np.zeros(n, np.int32)
        self.noise_off = np.zeros(n, np.int32)
        self.lay_rank = np.full(n, -1, np.int32)
        self.noisepos = np.empty(0, np.int32)
        self.noisechar = np.empty(0, np.uint8)
        self.packed = self.overlay = self.lit_rids = self.lit_chars = None

    def place(self, g, gpos, rc, nn, npos, nchar) -> None:
        """Reads ``g`` aligned at ``gpos`` / ``rc`` with their noise, ranked
        after the reads placed before them."""
        if len(self.noisepos) + len(npos) > 2**31 - 1:
            raise OverflowError("noise array exceeds int32 offsets")
        self.flag[g] = 1
        self.gpos[g] = gpos
        self.rc[g] = rc
        self.nn[g] = nn
        self.noise_off[g] = (len(self.noisepos) + np.concatenate(
            [[0], np.cumsum(nn.astype(np.int64))[:-1]])).astype(np.int32)
        self.noisepos = np.concatenate([self.noisepos, npos])
        self.noisechar = np.concatenate([self.noisechar, nchar])
        self.lay_rank[g] = self.placed + np.arange(len(g))
        self.placed += len(g)

    def take_literals(self, packed: np.ndarray, overlay: cons.NOverlay,
                      budget: int) -> bool:
        """Gather the literal reads' bases if they fit ``budget`` bytes and
        return True (``packed`` may go), else unpack them block by block."""
        self.overlay = overlay
        self.lit_rids = np.nonzero(self.flag == 0)[0].astype(np.int64)
        if self.lit_rids.size * self.ml <= budget:
            self.lit_chars = packing.CODE_TO_CHAR[
                cons.unpack_rows(packed, self.lit_rids, self.ml, overlay)]
            return True
        self.packed = packed
        return False

    def noise(self, al: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Ragged gather of noise for aligned reads ``al`` (block order),
        positions delta-coded within each read."""
        cnts = self.nn[al]
        starts = self.noise_off[al]
        tot = int(cnts.sum())
        if not tot:
            return np.empty(0, np.int32), np.empty(0, np.uint8)
        ends = np.cumsum(cnts)
        inner = np.arange(tot) - np.repeat(ends - cnts, cnts)
        take = np.repeat(starts, cnts) + inner
        npos_b, nchar_b = self.noisepos[take], self.noisechar[take]
        prev = np.concatenate([[0], npos_b[:-1]])
        return np.where(inner == 0, npos_b, npos_b - prev), nchar_b

    def literal_blob(self, lit: np.ndarray) -> bytes:
        if self.lit_chars is not None:
            lit_chars = self.lit_chars[np.searchsorted(self.lit_rids, lit)]
        else:
            lit_chars = packing.CODE_TO_CHAR[
                cons.unpack_rows(self.packed, lit, self.ml, self.overlay)]
        lit_valid = np.arange(self.ml)[None, :] < self.lengths[lit, None]
        return lit_chars[lit_valid].tobytes()


def se_block(t: ReadTable, b: int, sel: np.ndarray) -> dict[str, bytes]:
    """The read members of SE block ``b``, whose reads are ``sel``."""
    al = sel[t.flag[sel] == 1]
    npos_b, nchar_b = t.noise(al)
    return {
        f"flag.{b}": st.encode_u8(t.flag[sel]),
        f"rlen.{b}": st.encode_u16(t.lengths[sel]),
        f"pos.{b}": st.encode_deltas_u16(t.gpos[al]),
        f"rc.{b}": st.encode_u8(t.rc[al]),
        f"nn.{b}": st.encode_u16(t.nn[al]),
        f"npos.{b}": st.encode_u16(npos_b),
        f"nchar.{b}": st.encode_u8(nchar_b),
        f"literal.{b}": t.literal_blob(sel[t.flag[sel] == 0]),
    }


def pe_block(t: ReadTable, b: int, p1: np.ndarray,
             per_file: int) -> dict[str, bytes]:
    """The read members of pair block ``b``, whose file-1 reads are
    ``p1``."""
    p2 = p1 + per_file
    f1 = t.flag[p1] == 1
    f2 = t.flag[p2] == 1
    pdist = t.gpos[p2] - t.gpos[p1]
    near = np.abs(pdist) < 32767
    pflag = np.select(
        [f1 & f2 & near, f1 & f2, ~f1 & ~f2, f1 & ~f2],
        [0, 1, 2, 3], default=4).astype(np.uint8)
    pl0 = pflag == 0
    al1 = p1[f1]                      # flags 0,1,3 in pair order
    al2u = p2[f2 & ~pl0]              # flags 1,4 (unpaired r2)
    alr = np.concatenate([al1, p2[f2]])   # noise order: r1s, r2s
    npos_b, nchar_b = t.noise(alr)
    return {
        f"flag.{b}": st.encode_u8(pflag),
        f"rlen.{b}": st.encode_u16(
            np.stack([t.lengths[p1], t.lengths[p2]], 1).ravel()),
        f"pos.{b}": st.encode_deltas_u16(t.gpos[al1]),
        f"pos2.{b}": st.encode_deltas_u16(t.gpos[al2u]),
        f"pospair.{b}": st.encode_u16(
            pdist[pl0].astype(np.int16).view(np.uint16)),
        f"rcpair.{b}": st.encode_u8(
            (t.rc[p1[pl0]] == t.rc[p2[pl0]]).astype(np.uint8)),
        f"rc.{b}": st.encode_u8(np.concatenate([t.rc[al1], t.rc[al2u]])),
        f"nn.{b}": st.encode_u16(t.nn[alr]),
        f"npos.{b}": st.encode_u16(npos_b),
        f"nchar.{b}": st.encode_u8(nchar_b),
        f"literal.{b}": t.literal_blob(
            np.concatenate([p1[~f1], p2[~f2]])),
    }


def seq_member(seq_codes: np.ndarray) -> bytes:
    return (np.uint64(len(seq_codes)).tobytes()
            + packing.codes_to_bitstream_2bit(
                seq_codes[None, :], np.array([len(seq_codes)])))


def submit_read_streams(pool: CodecPool, t: ReadTable, heads: np.ndarray,
                        block: int, per_file: int | None = None) -> None:
    """Every block's read members, bsc-coded; ``per_file`` for PE."""
    for b, sel in enumerate(block_heads(heads, block)):
        members = (se_block(t, b, sel) if per_file is None
                   else pe_block(t, b, sel, per_file))
        for name, raw in members.items():
            pool.submit(name, pool.bsc, raw)


def _id_task(idbuf: np.ndarray, idoffs: np.ndarray, idlens: np.ndarray,
             sel: np.ndarray) -> bytes:
    """The ids of the reads in ``sel`` (a vectorized ragged gather), coded."""
    cnts = idlens[sel].astype(np.int64)
    starts = idoffs[sel]
    tot = int(cnts.sum())
    if not tot:
        return idcodec.compress_ids_raw(np.empty(0, np.uint8), idlens[sel])
    ends = np.cumsum(cnts)
    inner = np.arange(tot) - np.repeat(ends - cnts, cnts)
    return idcodec.compress_ids_raw(
        idbuf[np.repeat(starts, cnts) + inner], idlens[sel])


def submit_ids(pool: CodecPool, heads: np.ndarray, cp: P.CompressionParams,
               per_file: int, ids: tuple) -> None:
    """One id.b task a block; ``ids`` (idbuf, idoffs, idlens) ride as its
    arguments and the gather runs in the worker."""
    both = cp.paired_end and not cp.paired_id_match
    for b, p1 in enumerate(block_heads(heads, cp.num_reads_per_block)):
        sel = np.concatenate([p1, p1 + per_file]) if both else p1
        pool.submit(f"id.{b}", _id_task, *ids, sel)


def quality_sels(heads: np.ndarray, cp: P.CompressionParams,
                 per_file: int) -> list[tuple[str, np.ndarray]]:
    """(member name, global row indices) of each quality block."""
    return [(f"quality.{b}", np.concatenate([p1, p1 + per_file])
             if cp.paired_end else p1)
            for b, p1 in enumerate(block_heads(heads,
                                               cp.num_reads_per_block))]


class CodecPool:
    """One compress's codec tasks on ``num_threads - 1`` workers, each
    writing its member when done (the spooled writer is thread-safe and
    emits canonical order), and the thread submitting quality tasks."""

    def __init__(self, writer, num_threads: int,
                 spool: qualstream.QualSpool | None = None):
        self.workers = max(1, num_threads - 1)
        self._pool = ThreadPoolExecutor(max_workers=self.workers)
        self._writer = writer
        self._spool = spool
        self._futs = []
        self._quality = None
        self._errors = []
        # bsc tasks stay single-threaded while the device engine runs and
        # widen to 2 threads in the drain tail
        self.device_done = False
        self.stats = {"quality_shard_tasks": 0, "quality_bin_blocks": 0}

    def submit(self, name: str, fn, *args, **attrs) -> None:
        """A task writing member ``name`` unless ``fn`` returns None. Its
        span, under the submitting thread's stage, has the member's family,
        when it was submitted, the time in writer.add, the worker's CPU
        time and ``attrs``."""
        ctx, submit = spans.context(), time.time_ns()

        def run():
            t0, cpu0 = time.time_ns(), time.thread_time_ns()
            data = fn(*args)
            t1 = time.time_ns()
            if data is not None:
                self._writer.add(name, data)
            t2 = time.time_ns()
            spans.record("codec", "codecs", t0, t2, ctx,
                         family=name.rsplit(".", 1)[0], submit_ns=submit,
                         write_ns=t2 - t1,
                         cpu_ns=time.thread_time_ns() - cpu0, **attrs)
        self._futs.append(self._pool.submit(run))

    def bsc(self, raw: bytes) -> bytes:
        return bsc.compress(raw, num_threads=2 if self.device_done else 1)

    def start_quality(self, sels: list, lengths: np.ndarray,
                      cp: P.CompressionParams) -> None:
        """From a thread of its own: one quality task a qv shard, or under
        qvz (codebooks trained per bin) one a block of a spool-scanned bin."""
        if self._spool is None or not sels:
            return
        self._quality = threading.Thread(
            target=self._drive_quality, daemon=True,
            args=(spans.context(), sels, lengths, cp))
        self._quality.start()

    def _drive_quality(self, ctx, sels, lengths, cp) -> None:
        spans.adopt(ctx)        # its codec tasks: children of this stage
        try:
            if cp.quality_mode == "qvz":
                qualstream.drive_quality_bins(
                    self._spool, self.submit, sels, lengths, cp.qvz_ratio,
                    2 * self.workers)
                self.stats["quality_bin_blocks"] += len(sels)
            else:
                table = qual_mod.make_table(cp.quality_mode, cp.qvz_ratio,
                                            cp.bin_thresholds)
                self.stats["quality_shard_tasks"] += (
                    qualstream.drive_quality_shards(
                        self._spool, self.submit, sels, lengths, table))
        except Exception as e:      # raised by finish() in the caller
            self._errors.append(e)

    def join_quality(self) -> None:
        if self._quality is not None:
            self._quality.join()

    def finish(self) -> None:
        """Wait for every task and raise the first error; no task runs
        after it, and the spool is closed."""
        try:
            if self._errors:
                raise self._errors[0]
            for fut in self._futs:
                fut.result()        # propagate codec/writer errors
        finally:
            # no task may run once the spool is unmapped
            self._pool.shutdown(cancel_futures=True)
            if self._spool is not None:
                self._spool.close()


# ---------------- decode ----------------


def decode_seq(reader: ArchiveReader) -> np.ndarray:
    raw = bsc.decompress(reader.get(SEQ))
    seq_len = int(np.frombuffer(raw[:8], dtype=np.uint64)[0])
    return packing.bitstream_2bit_to_flat(raw[8:], seq_len)


def _undo_noise_delta(nn: np.ndarray, npos: np.ndarray) -> np.ndarray:
    """Undo per-read delta coding of noise positions (segmented cumsum)."""
    if not len(npos):
        return npos.astype(np.int32)
    cnts_d = nn.astype(np.int64)
    csum = np.cumsum(npos.astype(np.int64))
    starts_d = np.cumsum(cnts_d) - cnts_d
    base = np.where(starts_d > 0, csum[np.maximum(starts_d - 1, 0)], 0)
    return (csum - np.repeat(base, cnts_d)).astype(np.int32)


def _fill_rows(m, L, rlen, al, aligned_rows, lit):
    """Scatter aligned rows + literal bytes into an (m, L) char matrix.

    Row padding may be nonzero ('A' from code 0) — downstream only the
    first rlen[r] bytes of each row are read (native formatter)."""
    codes = np.zeros((m, L), np.uint8)
    if len(al):
        codes[al, : aligned_rows.shape[1]] = aligned_rows
    chars = packing.CODE_TO_CHAR[codes]
    li = np.setdiff1d(np.arange(m), al, assume_unique=False)
    if len(li):
        lvalid = np.arange(L)[None, :] < rlen[li, None]
        lrows = np.zeros((len(li), L), np.uint8)
        lrows[lvalid] = lit
        chars[li] = lrows
    return chars


def decode_block_pe(reader: ArchiveReader, cp: P.CompressionParams, b: int,
                    seq_codes: np.ndarray, per_file: int,
                    num_threads: int = 1):
    """Decode one PE pair-block into (file-1 half, file-2 half), each
    (idbuf, idlens, chars, rlen, qmat). Inverse of the pair-delta layout
    (reference src/decompress.cpp:277-318)."""
    block = cp.num_reads_per_block
    s = b * block
    m = min(block, per_file - s)
    pflag = st.decode_u8(bsc.decompress(reader.get_block("flag", b), num_threads))
    rlen_i = st.decode_u16(bsc.decompress(reader.get_block("rlen", b), num_threads))
    rlen1 = rlen_i[0::2].astype(np.int32)
    rlen2 = rlen_i[1::2].astype(np.int32)
    pos1 = st.decode_deltas_u16(bsc.decompress(reader.get_block("pos", b), num_threads))
    pos2u = st.decode_deltas_u16(bsc.decompress(reader.get_block("pos2", b), num_threads))
    # raw int16 pair distances (decode_u16 widens to int32 — view first)
    pospair = np.frombuffer(
        bsc.decompress(reader.get_block("pospair", b), num_threads),
        np.uint16).view(np.int16).astype(np.int64)
    rcpair = st.decode_u8(bsc.decompress(reader.get_block("rcpair", b), num_threads))
    rcs = st.decode_u8(bsc.decompress(reader.get_block("rc", b), num_threads))
    nn = st.decode_u16(bsc.decompress(reader.get_block("nn", b), num_threads))
    npos = _undo_noise_delta(
        nn, st.decode_u16(bsc.decompress(reader.get_block("npos", b), num_threads)))
    nchar = st.decode_u8(bsc.decompress(reader.get_block("nchar", b), num_threads))
    lit = np.frombuffer(bsc.decompress(reader.get_block("literal", b), num_threads),
                        np.uint8)

    f0 = pflag == 0
    al1m = f0 | (pflag == 1) | (pflag == 3)
    al2m = f0 | (pflag == 1) | (pflag == 4)
    al2um = (pflag == 1) | (pflag == 4)
    n_al1 = int(al1m.sum())
    gpos_r1 = np.zeros(m, np.int64)
    rc_r1 = np.zeros(m, np.uint8)
    gpos_r1[al1m] = pos1
    rc_r1[al1m] = rcs[:n_al1]
    gpos_r2 = np.zeros(m, np.int64)
    rc_r2 = np.zeros(m, np.uint8)
    gpos_r2[f0] = gpos_r1[f0] + pospair
    rc_r2[f0] = np.where(rcpair == 1, rc_r1[f0], 1 - rc_r1[f0])
    gpos_r2[al2um] = pos2u
    rc_r2[al2um] = rcs[n_al1:]

    gpos_al = np.concatenate([gpos_r1[al1m], gpos_r2[al2m]])
    rc_al = np.concatenate([rc_r1[al1m], rc_r2[al2m]])
    rlen_al = np.concatenate([rlen1[al1m], rlen2[al2m]])
    rows = cons.reconstruct_reads(seq_codes, gpos_al, rlen_al, rc_al,
                                  nn, npos, nchar,
                                  num_threads=num_threads) \
        if len(gpos_al) else np.zeros((0, 1), np.uint8)
    L = max(int(rlen_i.max()) if len(rlen_i) else 0, 1)
    # split aligned rows / literal bytes back into the two files
    lit1_len = int(rlen1[~al1m].sum())
    al1 = np.nonzero(al1m)[0]
    al2 = np.nonzero(al2m)[0]
    chars1 = _fill_rows(m, L, rlen1, al1, rows[:n_al1], lit[:lit1_len])
    chars2 = _fill_rows(m, L, rlen2, al2, rows[n_al1:], lit[lit1_len:])

    qmat1 = qmat2 = None
    if cp.preserve_quality and not cp.fasta_input:
        qmat, _q = qv.decompress_rows(reader.get_block("quality", b),
                                      max_len=L, num_threads=num_threads)
        qmat1, qmat2 = qmat[:m], qmat[m:]
    if cp.preserve_id:
        if cp.paired_id_match:
            ids1 = idcodec.decompress_ids(reader.get_block("id", b), m)
            ids2 = [modify_id(i, cp.paired_id_code) for i in ids1]
            id1buf, id1lens = _pack_ids(ids1)
            id2buf, id2lens = _pack_ids(ids2)
        else:
            buf2, lens2 = idcodec.decompress_ids_raw(
                reader.get_block("id", b), 2 * m)
            split = int(lens2[:m].sum())
            id1buf, id1lens = buf2[:split], lens2[:m]
            id2buf, id2lens = buf2[split:], lens2[m:]
    else:
        pre = ">" if cp.fasta_input else "@"
        id1buf, id1lens = _pack_ids(
            [f"{pre}{s + i + 1}/1".encode() for i in range(m)])
        id2buf, id2lens = _pack_ids(
            [f"{pre}{s + i + 1}/2".encode() for i in range(m)])
    return ((id1buf, id1lens, chars1, rlen1, qmat1),
            (id2buf, id2lens, chars2, rlen2, qmat2))


def decode_block(reader: ArchiveReader, cp: P.CompressionParams, b: int,
                 seq_codes: np.ndarray, num_threads: int = 1):
    """Decode one SE block into (idbuf, idlens, chars, rlen, qmat)."""
    block = cp.num_reads_per_block
    s = b * block
    flag = st.decode_u8(bsc.decompress(reader.get_block("flag", b), num_threads))
    rlen = st.decode_u16(bsc.decompress(reader.get_block("rlen", b), num_threads))
    gpos = st.decode_deltas_u16(bsc.decompress(reader.get_block("pos", b), num_threads))
    rc = st.decode_u8(bsc.decompress(reader.get_block("rc", b), num_threads))
    nn = st.decode_u16(bsc.decompress(reader.get_block("nn", b), num_threads))
    npos = st.decode_u16(bsc.decompress(reader.get_block("npos", b), num_threads))
    nchar = st.decode_u8(bsc.decompress(reader.get_block("nchar", b), num_threads))
    if len(npos):
        npos = _undo_noise_delta(nn, npos)
    lit = np.frombuffer(bsc.decompress(reader.get_block("literal", b), num_threads),
                        np.uint8)

    m = len(flag)
    L = max(int(rlen.max()) if m else 0, 1)
    al = np.nonzero(flag == 1)[0]
    # num_threads is this block's share of the core budget — blocks are the
    # outer parallelism; a full-width OMP team per block oversubscribes the
    # host with spinning barriers
    rows = (cons.reconstruct_reads(seq_codes, gpos, rlen[al], rc, nn, npos,
                                   nchar, num_threads=num_threads)
            if len(al) else None)
    chars = _fill_rows(m, L, rlen, al, rows, lit)

    qmat = None
    if cp.preserve_quality and not cp.fasta_input:
        qmat, _qlens = qv.decompress_rows(
            reader.get_block("quality", b), max_len=L,
            num_threads=num_threads)
    if cp.preserve_id:
        # array fast path: no per-id bytes objects
        idbuf, idlens = idcodec.decompress_ids_raw(
            reader.get_block("id", b), m)
    else:
        # fake ids: index + /1 (reference src/decompress.cpp:374-378);
        # FASTA headers must start with '>'
        pre = ">" if cp.fasta_input else "@"
        idbuf, idlens = _pack_ids(
            [f"{pre}{s + i + 1}/1".encode() for i in range(m)])
    return idbuf, idlens, chars, rlen.astype(np.int32), qmat


def _pack_ids(ids: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    return (np.frombuffer(b"".join(ids), np.uint8),
            np.fromiter((len(i) for i in ids), np.uint32, len(ids)))
