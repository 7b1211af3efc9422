"""Short-read mode on the port: compress on its device stages, decompress
on the host.

Copy of spring_tpu/pipeline/short_mode.py. The three device stages of
compress_short run on the port, on an explicit torch device: the reorder
engine (reorder/engine.py), contig stitching (encode/stitch.py) and the
second-chance pass (encode/second_chance.py). Parse, consensus, noise,
stream layout and codecs are the port's own copies of spring_tpu's host
code, so the archive is byte-identical to spring_tpu's. Inputs above
params.MAX_NUM_READS_SHORT reads become super-shard archives
(_compress_sharded). Decompress is host numpy and native code only: it
has no device stage and takes no device. The block streams and the codec
pool are pipeline/blocks.py's.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import params as P
from ..encode import consensus as cons
from ..encode import second_chance as sc
from ..encode import stitch as stch
from ..io import fastq, fastq_native
from ..io.container import ArchiveReader, ArchiveWriter
from ..io.ids import find_id_pattern
from ..ops import graphs
from ..reorder import dictionary as dct
from ..reorder import engine as eng
from ..utils import spans
from . import blocks
from . import qualstream

# inputs of this many reads and up (reads of 32 bases or more, single
# engine) prewarm the dictionary build while the host parses and, from one
# input file, stage their packed rows on the device segment by segment
# (spring_tpu's conditions, pipeline/short_mode.py)
STAGER_MIN_READS = 2_000_000


def _prewarm_dict_build(Np: int, W: int, maxlen: int, device) -> None:
    """The first dictionary build on zero rows of the engine's padded
    shape: on the card it makes the CUDA context, the allocator's first
    reservation and the build's kernel loads."""
    dev = torch.device(device)
    ws = dct.default_windows(maxlen)
    if not ws:
        return
    rows = torch.zeros((Np, W + 1), dtype=torch.int32, device=dev)
    dct._build_hash_dict_dev(rows, 0, ws[0].start, dct.table_buckets(Np))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prewarm(*args) -> float:
    """_prewarm_dict_build's seconds, in a thread of its own."""
    t = time.perf_counter()
    _prewarm_dict_build(*args)
    return round(time.perf_counter() - t, 3)


def check_quality_lengths(blk, path: str) -> None:
    """Reference guard src/preprocess.cpp:200-202: quality and read length
    must match per record (also catches FASTA fed without --fasta-input)."""
    for s, q in zip(blk.seqs, blk.quals):
        if len(s) != len(q):
            raise ValueError(
                f"{path}: quality length != read length "
                "(FASTA input needs --fasta-input)")


# stage wall seconds of the most recent compress_short run (one compress
# call per process: concurrent calls would interleave these stats)
LAST_STAGE_SECONDS: dict[str, float] = {}
# on a card, the device's peak allocated bytes so far
# (torch.cuda.max_memory_allocated) at the end of each stage of that run:
# the stage where it rises set the peak
LAST_STAGE_PEAK_BYTES: dict[str, int] = {}
# the same for the reserved bytes (torch.cuda.max_memory_reserved): the
# allocator's cache and the graph pools beside the tensors
LAST_STAGE_RESERVED_BYTES: dict[str, int] = {}
# the layer of each stage's span (utils/spans.py)
STAGE_LAYERS = {
    "scan": "io", "load+parse": "io", "quantize+idcheck": "io",
    "dict_build": "reorder", "reorder_run": "reorder",
    "assemble_contigs": "encode", "consensus": "encode", "stitch": "encode",
    "noise": "encode", "second_chance": "encode",
    "block_streams_submit": "codecs", "qbins_join": "codecs",
    "codec+write": "codecs"}


class _StageClock:
    """Ends a stage: its span from the previous call to now, its seconds
    added to LAST_STAGE_SECONDS[key or stage]."""

    def __init__(self, device):
        self._device = device
        self._card = torch.device(device).type == "cuda"
        self._t = time.time_ns()

    def __call__(self, stage: str, key: str | None = None, **attrs) -> None:
        now = time.time_ns()
        key = key or stage
        spans.close_stage(stage, STAGE_LAYERS[stage], self._t, now, **attrs)
        LAST_STAGE_SECONDS[key] = round(
            LAST_STAGE_SECONDS.get(key, 0.0) + (now - self._t) / 1e9, 3)
        if self._card:
            LAST_STAGE_PEAK_BYTES[key] = torch.cuda.max_memory_allocated(
                self._device)
            LAST_STAGE_RESERVED_BYTES[key] = (
                torch.cuda.max_memory_reserved(self._device))
        self._t = now


def compress_short(files: list[str], writer: ArchiveWriter,
                   cp: P.CompressionParams, num_threads: int = 8,
                   device="cuda", world=None,
                   engine: dict | None = None,
                   min_contig_reads: int = P.MIN_CONTIG_READS,
                   stitch: bool = True, stager: bool = True) -> None:
    """``world`` (a parallel.multihost.World) routes the reorder through
    the distributed engine. Every rank of it makes this same call on the
    same input; rank 0 goes on to write the archive, the other ranks
    return once the engine has run (nothing after it is collective).

    ``engine`` overrides fields of the single engine's ReorderConfig
    (num_walkers, shift_chunk, accept_slots, far_near, cap_per_round,
    rebuild_fraction, flush_rounds), as the JAX package's environment
    knobs do; on the distributed engine only rebuild_fraction and
    flush_rounds apply (DistConfig), as in the JAX package, and the
    others are ignored. Contigs of fewer than ``min_contig_reads`` reads
    join the leftover pool; ``stitch`` False skips contig stitching.
    ``stager`` False copies the rows of a large input to the device only
    when the engine starts, not while the parse runs."""
    LAST_STAGE_SECONDS.clear()
    LAST_STAGE_PEAK_BYTES.clear()
    LAST_STAGE_RESERVED_BYTES.clear()
    graphs.LOOP_STATS.clear()
    sc.SEGMENTS.clear()
    spans.begin_compress()
    mark = _StageClock(device)
    # streaming load: inputs are mmap'd, scanned, then parsed
    # record-parallel straight into packed 2-bit rows with a sparse N
    # overlay (reference: src/preprocess.cpp:141-285)
    bufs = [fastq_native.open_buf(f) for f in files]
    infos = [fastq_native.scan_buf(b, f, fasta=cp.fasta_input)
             for b, f in zip(bufs, files)]
    if len(files) == 2 and infos[0].n != infos[1].n:
        raise ValueError("paired files have different read counts")
    mark("scan")
    shard = functools.partial(
        _compress_shard, mark=mark, device=device, world=world,
        engine_cfg=dict(engine or {}), min_contig_reads=min_contig_reads,
        stitch=stitch, stager=stager)
    # per-shard read cap: device read ids are int32; larger inputs split
    # into independent super-shards inside one archive
    if sum(i.n for i in infos) > P.MAX_NUM_READS_SHORT:
        _compress_sharded(files, writer, cp, num_threads, bufs, infos,
                          P.MAX_NUM_READS_SHORT, shard)
    else:
        shard(files, writer, cp, num_threads, bufs, infos)


class _Reads:
    """A shard's reads parsed into one index space, file 1 then file 2;
    qualities spill to ``spool``. Parsing empties ``bufs``. A large input
    prewarms the dictionary build meanwhile and, from one file, stages its
    rows on the device (a second file's offsets would break the tail pad)."""

    def __init__(self, files, bufs: list, infos, cp, num_threads: int,
                 device, world, stager: bool, primary: bool):
        self.n = n = sum(i.n for i in infos)
        self.per_file = infos[0].n if cp.paired_end else n
        self.maxlen = maxlen = max((i.maxlen for i in infos), default=0)
        if maxlen > P.MAX_READ_LEN:
            raise ValueError(f"read length {maxlen} > {P.MAX_READ_LEN}; "
                             "use long mode (-l)")
        self.ml = ml = max(maxlen, 1)
        W = -(-ml // 16)
        big = n >= STAGER_MIN_READS and maxlen >= 32 and world is None
        prewarm = ThreadPoolExecutor(1) if big else None
        if big:
            warm = prewarm.submit(_prewarm, eng.padded_n(n), W, maxlen,
                                  device)
        n_pad = max(1 << max(n - 1, 1).bit_length(), 64)
        self.packed_buf = np.empty((n_pad, W), np.uint32)
        self.packed = packed = self.packed_buf[:n]
        self.lengths = lengths = np.empty(n, np.int32)
        idbuf = np.empty(sum(i.idbytes for i in infos), np.uint8)
        idlens = np.empty(n, np.uint32)
        self.spool = spool = (
            qualstream.QualSpool(n, ml, dir=os.path.dirname(files[0]) or ".")
            if cp.preserve_quality and not cp.fasta_input and primary
            else None)
        self.row_stager = row_stager = (
            eng.DeviceRowStager(n, W, fastq_native._SEG_RECORDS, device)
            if big and len(files) == 1 and stager else None)
        exc_parts = []
        off = ido = 0
        try:
            for buf, info, f in zip(bufs, infos, files):
                if info.n:
                    sink = None
                    if spool is not None:
                        sink = (lambda o: lambda r0, rows:
                                spool.write(o + r0, rows))(off)
                    exc = fastq_native.parse_packed_into(
                        buf, f, info, ml, packed[off:off + info.n],
                        lengths[off:off + info.n], None,
                        idbuf[ido:ido + info.idbytes],
                        idlens[off:off + info.n],
                        fasta=cp.fasta_input, num_threads=num_threads,
                        qual_sink=sink,
                        row_sink=(row_stager.feed if row_stager is not None
                                  else None))
                    if len(exc):
                        exc[:, 0] += off
                        exc_parts.append(exc)
                off += info.n
                ido += info.idbytes
        finally:
            if prewarm is not None:
                prewarm.shutdown()
        # the prewarm's failure is this call's
        self.prewarm_s = warm.result() if big else None
        bufs.clear()
        self.overlay = cons.NOverlay.from_pairs(
            np.concatenate(exc_parts) if exc_parts else
            np.empty((0, 2), np.int32))
        self.ids = (idbuf, np.concatenate(
            [[0], np.cumsum(idlens.astype(np.int64))]), idlens)


def _pe_id_check(reads: _Reads, cp) -> tuple[int, int]:
    """PE id pattern detection (reference src/preprocess.cpp:113-140): the
    first pair names the pattern; one native pass checks every pair.
    Returns the pattern's code and the pairs checked."""
    code = checked = 0
    ok = False
    pf = reads.per_file
    if cp.paired_end and cp.preserve_id and pf:
        idbuf, idoffs, _ = reads.ids
        code = find_id_pattern(idbuf[idoffs[0]:idoffs[1]].tobytes(),
                               idbuf[idoffs[pf]:idoffs[pf + 1]].tobytes())
        if code:
            first = fastq_native.pe_id_first_mismatch(idbuf, idoffs, pf,
                                                      code)
            ok = first == pf
            checked = pf if ok else first + 1
    cp.paired_id_match = bool(ok and code)
    cp.paired_id_code = code if cp.paired_id_match else 0
    return code, checked


class _IdsAndQualities:
    """A shard's id and quality tasks, submitted once the output order is
    known, the ids dropped. With the order kept that is before the reorder:
    ``in_order`` is the engine's progress callback (after the dict build)."""

    def __init__(self, pool: blocks.CodecPool, cp, reads: _Reads):
        self.pool, self.cp, self.reads, self.done = pool, cp, reads, False

    def submit(self, heads: np.ndarray) -> None:
        if self.done:
            return
        self.done = True
        cp, r = self.cp, self.reads
        ids, r.ids = r.ids, None
        if cp.preserve_id:
            blocks.submit_ids(self.pool, heads, cp, r.per_file, ids)
        self.pool.start_quality(blocks.quality_sels(heads, cp, r.per_file),
                                r.lengths, cp)

    def in_order(self, *_progress) -> None:
        if self.cp.preserve_order and self.reads.n:
            self.submit(np.arange(self.reads.per_file, dtype=np.int64))


def _engine(reads: _Reads, clean_rids, device, world, engine_cfg: dict):
    """The reorder engine over the reads without N."""
    if world is not None:
        from ..parallel import dist as dist_mod
        return dist_mod.DistReorderEngine(
            np.ascontiguousarray(reads.packed[clean_rids]),
            reads.lengths[clean_rids],
            dist_mod.DistConfig(
                max_readlen=reads.maxlen,
                **{k: v for k, v in engine_cfg.items()
                   if k in ("rebuild_fraction", "flush_rounds")}),
            world=world)
    # the clean-row gather happens on the device (engine `select`)
    return eng.ReorderEngine(
        reads.packed_buf, reads.lengths,
        eng.ReorderConfig(max_readlen=reads.maxlen, **engine_cfg),
        select=clean_rids, device=device,
        rows_dev=(reads.row_stager.rows() if reads.row_stager is not None
                  else None))


def _lay_out_contigs(engine, emissions, clean_rids, reads: _Reads,
                     t: blocks.ReadTable, pool: blocks.CodecPool, mark,
                     device, min_contig_reads: int, stitch: bool
                     ) -> np.ndarray:
    """Contigs from the engine's emissions (smaller ones than
    min_contig_reads join the leftover pool), their consensus, submitted
    as seq.0 once final and returned, and each contig read's place."""
    layout, _singles = cons.layout_from_emissions(
        emissions, engine.B, reads.lengths[clean_rids],
        min_reads=min_contig_reads, ordered=engine.ordered_emissions)
    engine.release()
    mark("assemble_contigs")
    if not layout.seq_len:
        return np.empty(0, np.uint8)
    glay = dataclasses.replace(
        layout, rids=clean_rids[layout.rids].astype(np.int32))
    seq_codes = cons.build_consensus_packed(glay, reads.packed, reads.lengths)
    mark("consensus")
    # stitch contigs whose heads re-align inside other contigs, then
    # re-vote the merged consensus
    if stitch:
        glay2, n_st = stch.stitch_layout(glay, seq_codes, reads.lengths,
                                         device=device)
        if n_st:
            glay = glay2
            seq_codes = cons.build_consensus_packed(glay, reads.packed,
                                                    reads.lengths)
        mark("stitch", key=f"stitch[{n_st}]", n=n_st)
    if len(seq_codes) > 2**31 - 1:
        raise OverflowError("consensus size exceeds int32 metadata "
                            f"({len(seq_codes)} bases)")
    pool.submit(blocks.SEQ, pool.bsc, blocks.seq_member(seq_codes))
    nn, npos, nchar = cons.extract_noise_packed(glay, seq_codes, reads.packed,
                                                reads.lengths)
    mark("noise")
    t.place(glay.rids, glay.gpos, glay.rc, nn, npos, nchar)
    return seq_codes


def _second_chance(seq_codes, reads: _Reads, t: blocks.ReadTable, mark,
                   device, n_with_n: int) -> tuple[int, int]:
    """Align N-reads and singleton-contig reads against the consensus
    (reference src/encoder.h:242-351); returns the reads tried, placed."""
    leftover = np.nonzero(t.flag == 0)[0]
    if not (len(leftover) and len(seq_codes) >= 16 and reads.maxlen >= 32):
        return 0, 0
    lens_l = reads.lengths[leftover]
    nm_f, nm_r = reads.overlay.nmask_planes(leftover, lens_l, reads.ml)
    g2pos, g2rc, placed = sc.align_leftovers_packed(
        seq_codes, np.ascontiguousarray(reads.packed[leftover]),
        nm_f, nm_r, lens_l, device=device)
    g2 = leftover[placed]
    if len(g2):
        order2 = np.argsort(g2pos[placed], kind="stable")
        g2 = g2[order2]
        lay2 = cons.ContigLayout(rids=g2.astype(np.int32),
                                 gpos=g2pos[placed][order2],
                                 rc=g2rc[placed][order2],
                                 seq_len=len(seq_codes))
        nn2, npos2, nchar2 = cons.extract_noise_packed(
            lay2, seq_codes, reads.packed, reads.lengths, reads.overlay)
        t.place(g2, lay2.gpos, lay2.rc, nn2, npos2, nchar2)
    mark("second_chance", n_reads=n_with_n, reads_in=len(leftover),
         placed=len(g2))
    return len(leftover), len(g2)


def _output_heads(t: blocks.ReadTable, cp, per_file: int) -> np.ndarray:
    """The output order of SE reads or of PE file-1 reads: -r re-blocks by
    the internal reorder (PE pairing implicit, src/pe_encode.cpp:41-69)."""
    if cp.preserve_order:
        return np.arange(per_file, dtype=np.int32)
    seq_rank = t.lay_rank.copy()
    rest = np.nonzero(seq_rank < 0)[0]
    seq_rank[rest] = t.placed + np.arange(len(rest), dtype=np.int32)
    return np.argsort(seq_rank[:per_file], kind="stable").astype(np.int32)


def _compress_shard(files, writer, cp, num_threads, bufs: list, infos, mark,
                    device, world, engine_cfg: dict, min_contig_reads: int,
                    stitch: bool, stager: bool) -> None:
    """compress_short's stages on at most MAX_NUM_READS_SHORT scanned
    reads, each closed by ``mark``."""
    primary = world is None or world.rank == 0
    reads = _Reads(files, bufs, infos, cp, num_threads, device, world, stager,
                   primary)
    n, maxlen = reads.n, reads.maxlen
    cp.num_reads, cp.max_readlen = n, maxlen
    cp.num_blocks = -(-reads.per_file // cp.num_reads_per_block)
    mark("load+parse")

    code, checked = _pe_id_check(reads, cp)
    pool = blocks.CodecPool(writer, num_threads, reads.spool)
    ids_and_qualities = _IdsAndQualities(pool, cp, reads)
    mark("quantize+idcheck", what="pe_id_check", pairs_checked=checked,
         code=code)

    clean_rids = np.nonzero(~reads.overlay.has_n_mask(n))[0].astype(np.int32)
    t = blocks.ReadTable(reads.lengths, reads.ml)
    seq_codes = np.empty(0, np.uint8)
    use_engine = len(clean_rids) > 0 and maxlen >= 32
    if use_engine:
        engine = _engine(reads, clean_rids, device, world, engine_cfg)
    if reads.row_stager is not None:
        # no engine reads the staged rows, or the engine holds the table
        # now and run() drops it once the padded row table is assembled
        reads.row_stager.release()
        reads.row_stager = None
    if use_engine:
        mark("dict_build")
        emissions = engine.run(
            progress=ids_and_qualities.in_order if primary else None)
        if reads.prewarm_s is not None:
            eng.LAST_RUN_STATS["dict_prewarm_s"] = reads.prewarm_s
    if not primary:
        pool.finish()
        return
    if use_engine:
        ids_and_qualities.in_order()    # zero-flush runs never call back
        mark("reorder_run")
        seq_codes = _lay_out_contigs(engine, emissions, clean_rids, reads, t,
                                     pool, mark, device, min_contig_reads,
                                     stitch)
        del engine, emissions
    ids_and_qualities.in_order()        # the engine may not have run

    sc_in, sc_placed = _second_chance(seq_codes, reads, t, mark, device,
                                      n - len(clean_rids))
    pool.device_done = True     # tail codec tasks may widen to 2 threads
    unmatched = int((t.flag == 0).sum())
    eng.LAST_RUN_STATS.update(
        unmatched_frac=round(unmatched / max(n, 1), 5), unmatched=unmatched,
        n_reads=n - len(clean_rids), second_chance_in=sc_in,
        second_chance_placed=sc_placed,
        consensus_segments=dict(sc.SEGMENTS))
    if not len(seq_codes):      # no contig: seq.0 holds an empty consensus
        pool.submit(blocks.SEQ, pool.bsc, blocks.seq_member(seq_codes))

    # free the packed row table before the stream codecs run: its only
    # remaining consumer is the literal stream, gathered into a small
    # side table first (skipped when literals are the bulk of the input)
    if t.take_literals(reads.packed, reads.overlay,
                       reads.packed_buf.nbytes // 2):
        reads.packed = reads.packed_buf = None
    heads = _output_heads(t, cp, reads.per_file)
    ids_and_qualities.submit(heads)
    blocks.submit_read_streams(pool, t, heads, cp.num_reads_per_block,
                               reads.per_file if cp.paired_end else None)
    mark("block_streams_submit")
    pool.join_quality()
    mark("qbins_join")
    pool.finish()
    eng.LAST_RUN_STATS.update(pool.stats)
    mark("codec+write")


# ---------------- super-shard container (> per-shard read cap) ----------
#
# Reference ceiling: 4.29e9 reads via uint32 ids (src/params.h:24). Here
# one compression shard holds <= 2^31-2 reads (int32 device rids); larger
# inputs become k independent sub-archives inside ONE container — shard
# j's members under "sh<j>/" with a per-shard manifest, the top manifest
# carrying shard_reads for routing. PE shards split at pair granularity
# so the pe_encode invariant holds per shard.


class _ShardWriter:
    """Routes writer.add under a shard prefix (writer API used by the
    compress body is add() only)."""

    def __init__(self, inner, prefix: str):
        self._inner = inner
        self._prefix = prefix

    def add(self, name: str, data: bytes) -> None:
        self._inner.add(self._prefix + name, data)


class _ShardReader:
    """Reader view of one shard: get/get_block under the prefix, params
    from the shard's own manifest."""

    def __init__(self, inner, prefix: str):
        self._inner = inner
        self._prefix = prefix
        self.params = P.CompressionParams.from_json(
            inner.get(prefix + "params.json").decode())

    def get(self, name: str) -> bytes:
        return self._inner.get(self._prefix + name)

    def get_block(self, stream: str, block: int) -> bytes:
        return self._inner.get(f"{self._prefix}{stream}.{block}")


def _slice_scan(info, a: int, b: int, stride: int):
    """ScanInfo view covering records [a, b) of a scanned buffer. `a`
    must sit on a checkpoint boundary; ckpt_byte offsets stay absolute
    (the shard parses the ORIGINAL buffer), ckpt_id rebases to the
    shard's first id byte (the parse writes ids relative to its slice)."""
    assert a % stride == 0
    c0 = a // stride
    if b % stride == 0 and b // stride < len(info.ckpt_id) and b < info.n:
        id_end = int(info.ckpt_id[b // stride])
    else:
        id_end = info.idbytes
    idb0 = int(info.ckpt_id[c0])
    return fastq_native.ScanInfo(
        n=b - a, maxlen=info.maxlen, idbytes=id_end - idb0,
        ckpt_byte=info.ckpt_byte[c0:],
        ckpt_id=info.ckpt_id[c0:] - idb0)


def _compress_sharded(files, writer, cp, num_threads, bufs, infos,
                      cap: int, shard) -> None:
    """Compress super-shards of at most ``cap`` reads each into one
    archive, each by ``shard`` (compress_short's _compress_shard)."""
    stride = fastq_native.ckpt_stride()
    nfiles = len(files)
    per_file = infos[0].n
    # consistency guard: shard slicing trusts the scan's checkpoint
    # table; a claimed read count the table cannot cover would send the
    # native parser past its buffers. Fail loudly instead.
    for i, f in zip(infos, files):
        if (i.n - 1) // stride + 1 > len(i.ckpt_byte):
            raise ValueError(
                f"{f}: inconsistent scan (checkpoint table covers fewer "
                f"records than the claimed {i.n})")
    lim = cap // nfiles
    per_shard = (lim // stride) * stride
    if per_shard <= 0:
        raise ValueError(
            f"shard cap {cap} is below the parser checkpoint stride "
            f"({stride} records)")
    ranges = [(x, min(x + per_shard, per_file))
              for x in range(0, per_file, per_shard)]
    shard_reads = []
    maxlen = 0
    for j, (a, b) in enumerate(ranges):
        cpj = dataclasses.replace(cp, num_reads=0, num_blocks=0,
                                  shard_reads=())
        sub = [_slice_scan(i, a, b, stride) for i in infos]
        pw = _ShardWriter(writer, f"sh{j}/")
        shard(files, pw, cpj, num_threads, list(bufs), sub)
        pw.add("params.json", cpj.to_json().encode())
        shard_reads.append(cpj.num_reads)
        maxlen = max(maxlen, cpj.max_readlen)
    cp.num_reads = nfiles * per_file
    cp.max_readlen = maxlen
    cp.num_blocks = 0
    cp.shard_reads = tuple(shard_reads)


def decompress_short_sharded(reader, out_paths: list[str], gzipped: bool,
                             num_threads: int = 8,
                             read_range: tuple[int, int] | None = None
                             ) -> None:
    """Decompress a super-shard archive: shards decode in order and
    append to the output(s). PE single-output needs two passes (all
    shards' file-1 halves, then file-2) to match the unsharded layout."""
    cp = reader.params
    paired = cp.paired_end
    nfiles = 2 if paired else 1
    shard_n = list(cp.shard_reads)
    pf = [s // nfiles for s in shard_n]          # per-file reads per shard
    base = np.concatenate([[0], np.cumsum(pf)]).astype(np.int64)
    pf_total = int(base[-1])
    lo, hi = ((0, cp.num_reads) if read_range is None else read_range)
    single_out = len(out_paths) == 1

    def segs(glo: int, ghi: int, half: int):
        """Shard-local [a, b) segments of global per-file range
        [glo, ghi), mapped into half `half` of each shard's local index
        space."""
        out = []
        for j in range(len(shard_n)):
            a = max(glo - int(base[j]), 0)
            b = min(ghi - int(base[j]), pf[j])
            if a < b:
                out.append((j, half * pf[j] + a, half * pf[j] + b))
        return out

    if paired:
        plan1 = segs(max(lo, 0), min(hi, pf_total), 0)
        plan2 = segs(max(lo - pf_total, 0), min(hi - pf_total, pf_total), 1)
        if single_out:
            plan = [(s, 0) for s in plan1] + [(s, 0) for s in plan2]
        else:
            # full-shard fast path: one call decodes both halves per shard
            if read_range is None:
                for j in range(len(shard_n)):
                    decompress_short(_ShardReader(reader, f"sh{j}/"),
                                     out_paths, gzipped, num_threads,
                                     None, append=j > 0)
                return
            plan = [(s, 0) for s in plan1] + [(s, 1) for s in plan2]
    else:
        plan = [(s, 0) for s in segs(lo, hi, 0)]

    started: set = set()
    for (j, a, b), w in plan:
        decompress_short(_ShardReader(reader, f"sh{j}/"),
                         [out_paths[w]], gzipped, num_threads, (a, b),
                         append=out_paths[w] in started)
        started.add(out_paths[w])
    # a range can select zero reads for some outputs — still create them
    for p in out_paths:
        if p not in started:
            open(p, "wb").close()


def _windowed(pool, tasks, window: int):
    """Submit (fn, *args) tasks keeping at most `window` in flight; yield
    results in submission order (bounds decoded-block memory: completed
    blocks can't pile up faster than the writer drains them)."""
    dq = deque()
    for t in tasks:
        dq.append(pool.submit(*t))
        if len(dq) >= window:
            yield dq.popleft().result()
    while dq:
        yield dq.popleft().result()


def decompress_short(reader: ArchiveReader, out_paths: list[str],
                     gzipped: bool, num_threads: int = 8,
                     read_range: tuple[int, int] | None = None,
                     append: bool = False) -> None:
    cp = reader.params
    block = cp.num_reads_per_block
    n = cp.num_reads
    paired = cp.paired_end
    nfiles = 2 if paired else 1
    per_file = n // nfiles
    single_out = len(out_paths) == 1
    lo, hi = (0, n) if read_range is None else read_range

    seq_codes = blocks.decode_seq(reader)

    pool = ThreadPoolExecutor(max_workers=num_threads)
    writers = [fastq.BlockWriter(p, gzipped=gzipped, fasta=cp.fasta_input,
                                 num_threads=num_threads, append=append)
               for p in out_paths]
    # per-block native thread budget: blocks are the outer parallelism, but
    # a short file (or the tail) has fewer blocks than threads — give the
    # sharded qv codec the leftover cores
    bt = max(1, num_threads // max(min(cp.num_blocks, num_threads), 1))

    # record formatting runs INSIDE the block workers (the ~0.5 s/block
    # serial format+write tail otherwise adds up after the last decode);
    # the main thread only appends ready blobs in block order
    try:
        if paired:
            # blocks hold read PAIRS; file j is half j of each block
            fl = [(max(lo, 0), min(hi, per_file)),
                  (max(lo - per_file, 0), max(min(hi - per_file, per_file),
                                              0))]
            if not single_out and fl[0] == fl[1] and fl[0][0] < fl[0][1]:
                flo, fhi = fl[0]
                b0, b1 = flo // block, (fhi - 1) // block
                res = _windowed(pool, ((_decode_fmt_pe, reader, cp, b,
                                        seq_codes, per_file, bt, flo, fhi,
                                        (0, 1))
                                       for b in range(b0, b1 + 1)),
                                2 * num_threads)
                for blobs in res:
                    for j in (0, 1):
                        writers[j].write_bytes(blobs[j])
            else:
                for j in range(2):
                    flo, fhi = fl[j]
                    if flo >= fhi:
                        continue
                    w = writers[0] if single_out else writers[j]
                    b0, b1 = flo // block, (fhi - 1) // block
                    res = _windowed(pool, ((_decode_fmt_pe, reader, cp, b,
                                            seq_codes, per_file, bt, flo,
                                            fhi, (j,))
                                           for b in range(b0, b1 + 1)),
                                    2 * num_threads)
                    for blobs in res:
                        w.write_bytes(blobs[0])
        else:
            w = writers[0]
            if lo < hi:
                b0, b1 = lo // block, (hi - 1) // block
                res = _windowed(pool, ((_decode_fmt, reader, cp, b,
                                        seq_codes, bt, lo, hi)
                                       for b in range(b0, b1 + 1)),
                                2 * num_threads)
                for blob in res:
                    w.write_bytes(blob)
    finally:
        pool.shutdown()
        for w in writers:
            w.close()


def _fmt_half(half, s: int, e: int) -> bytes:
    idbuf, idlens, chars, rlen, qmat = half
    idoffs = np.concatenate([[0], np.cumsum(idlens.astype(np.int64))])
    return fastq_native.format_records(
        chars[s:e], rlen[s:e], qmat[s:e] if qmat is not None else None,
        idbuf[idoffs[s]:idoffs[e]], idlens[s:e])


def _decode_fmt(reader, cp, b, seq_codes, bt, flo, fhi) -> bytes:
    half = blocks.decode_block(reader, cp, b, seq_codes, bt)
    block = cp.num_reads_per_block
    s = max(flo - b * block, 0)
    e = min(fhi - b * block, len(half[3]))
    return _fmt_half(half, s, e)


def _decode_fmt_pe(reader, cp, b, seq_codes, per_file, bt, flo, fhi,
                   which) -> list[bytes]:
    halves = blocks.decode_block_pe(reader, cp, b, seq_codes, per_file, bt)
    block = cp.num_reads_per_block
    s = max(flo - b * block, 0)
    e = min(fhi - b * block, len(halves[0][3]))
    return [_fmt_half(halves[j], s, e) for j in which]
