"""Short-read mode compress on the port's device stages.

Copy of spring_tpu/pipeline/short_mode.py::compress_short whose three
device stages run on the port, on an explicit torch device: the reorder
engine (reorder/engine.py), contig stitching (encode/stitch.py) and the
second-chance pass (encode/second_chance.py). Parse, consensus, noise,
stream layout and codecs are spring_tpu's host code, imported as they
are, so the archive is byte-identical to spring_tpu's. Decompress has no
device stage: it is spring_tpu.pipeline.short_mode.decompress_short.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from spring_tpu import params as P
from spring_tpu.codecs import bsc, idcodec
from spring_tpu.encode import consensus as cons
from spring_tpu.encode import streams as st
from spring_tpu.io import fastq_native, packing
from spring_tpu.io.container import ArchiveWriter
from spring_tpu.io.ids import check_id_pattern, find_id_pattern
from spring_tpu.pipeline import qualstream
from spring_tpu.pipeline import quality as qual_mod
from spring_tpu.pipeline.short_mode import _gather_ids

from ..encode import second_chance as sc
from ..encode import stitch as stch
from ..reorder import engine as eng

# stage wall seconds of the most recent compress_short run (one compress
# call per process: concurrent calls would interleave these stats)
LAST_STAGE_SECONDS: dict[str, float] = {}


def compress_short(files: list[str], writer: ArchiveWriter,
                   cp: P.CompressionParams, num_threads: int = 8,
                   device="cuda") -> None:
    LAST_STAGE_SECONDS.clear()
    _t = time.time()

    def mark(stage):
        nonlocal _t
        now = time.time()
        LAST_STAGE_SECONDS[stage] = round(
            LAST_STAGE_SECONDS.get(stage, 0.0) + (now - _t), 3)
        _t = now

    block = cp.num_reads_per_block
    want_q = cp.preserve_quality and not cp.fasta_input
    # streaming load: inputs are mmap'd, scanned, then parsed
    # record-parallel straight into packed 2-bit rows with a sparse N
    # overlay (reference: src/preprocess.cpp:141-285)
    bufs = [fastq_native.open_buf(f) for f in files]
    infos = [fastq_native.scan_buf(b, f, fasta=cp.fasta_input)
             for b, f in zip(bufs, files)]
    counts = [i.n for i in infos]
    if len(files) == 2 and counts[0] != counts[1]:
        raise ValueError("paired files have different read counts")
    mark("scan")
    n = sum(counts)
    if n > P.MAX_NUM_READS_SHORT:
        raise ValueError(
            f"{n} reads exceed the per-archive short-mode cap "
            f"({P.MAX_NUM_READS_SHORT}); super-shard archives are not "
            "ported yet — use spring_tpu for this input")
    cp.num_reads = n
    cp.num_blocks = -(-n // block) if n else 0
    maxlen = max((i.maxlen for i in infos), default=0)
    if maxlen > P.MAX_READ_LEN:
        raise ValueError(
            f"read length {maxlen} > {P.MAX_READ_LEN}; use long mode (-l)")
    cp.max_readlen = maxlen
    paired = cp.paired_end
    per_file = counts[0] if paired else n

    # one index space: file 1 then file 2, rows padded to the common maxlen
    ml = max(maxlen, 1)
    W = -(-ml // 16)
    n_pad = max(1 << max(n - 1, 1).bit_length(), 64)
    packed_buf = np.empty((n_pad, W), np.uint32)
    packed_all = packed_buf[:n]
    lengths = np.empty(n, np.int32)
    idbytes = sum(i.idbytes for i in infos)
    idbuf = np.empty(idbytes, np.uint8)
    idlens = np.empty(n, np.uint32)

    # quality rows spill to an unlinked spool during parse and are
    # gathered per output bin later (reference bin strategy,
    # src/reorder_compress_quality_id.cpp:64-68)
    table = (qual_mod.make_table(cp.quality_mode, cp.qvz_ratio,
                                 cp.bin_thresholds)
             if want_q and cp.quality_mode in ("ill_bin", "binary")
             else None)
    fine_pos = cp.quality_mode == "qvz"
    workers = max(1, num_threads - 1)
    pool = ThreadPoolExecutor(max_workers=workers)
    futs = []

    def _sink(name, fn, *args):
        """Submit a codec task that writes its member when it completes
        (the spooled writer is thread-safe and emits canonical order)."""
        def run():
            writer.add(name, fn(*args))
        futs.append(pool.submit(run))

    # codec tasks stay single-threaded while the device engine runs and
    # widen to 2 threads in the drain tail
    device_done = [False]

    def _bsc1(raw):
        return bsc.compress(raw, num_threads=2 if device_done[0] else 1)

    inflight_cap = 2 * workers
    spool = None
    if want_q:
        spool = qualstream.QualSpool(
            n, ml, dir=os.path.dirname(files[0]) or ".")

    exc_parts = []
    off = 0
    ido = 0
    for buf, info, f in zip(bufs, infos, files):
        if info.n:
            if spool is not None:
                sink = (lambda o: lambda r0, rows:
                        spool.write(o + r0, rows))(off)
            else:
                sink = None
            exc = fastq_native.parse_packed_into(
                buf, f, info, ml, packed_all[off:off + info.n],
                lengths[off:off + info.n], None,
                idbuf[ido:ido + info.idbytes],
                idlens[off:off + info.n],
                fasta=cp.fasta_input, num_threads=num_threads,
                qual_sink=sink)
            if len(exc):
                exc[:, 0] += off
                exc_parts.append(exc)
        off += info.n
        ido += info.idbytes
    del bufs, infos
    overlay = cons.NOverlay.from_pairs(
        np.concatenate(exc_parts) if exc_parts else
        np.empty((0, 2), np.int32))
    del exc_parts
    idoffs = np.concatenate([[0], np.cumsum(idlens.astype(np.int64))])
    mark("load+parse")

    # --- PE id pattern detection (reference src/preprocess.cpp:113-140)
    pattern_code = 0
    pattern_ok = False
    if paired and cp.preserve_id and per_file:
        def _id(i):
            return idbuf[idoffs[i]:idoffs[i + 1]].tobytes()
        pattern_code = find_id_pattern(_id(0), _id(per_file))
        if pattern_code:
            pattern_ok = all(
                check_id_pattern(_id(i), _id(per_file + i), pattern_code)
                for i in range(per_file))
    cp.paired_id_match = bool(pattern_ok and pattern_code)
    cp.paired_id_code = pattern_code if cp.paired_id_match else 0

    # per-block id gathers run inside the workers; the id arrays ride as
    # explicit task args so the main frame can drop its references
    def _id_task(ib, io_, il, sel):
        return idcodec.compress_ids_raw(*_gather_ids(ib, io_, il, sel))

    def _submit_ids_se(order):
        if not cp.preserve_id:
            return
        for b in range(cp.num_blocks):
            sel = order[b * block:(b + 1) * block]
            _sink(f"id.{b}", _id_task, idbuf, idoffs, idlens, sel)

    def _submit_ids_pe(pairs):
        if not cp.preserve_id:
            return
        nb = -(-per_file // block) if per_file else 0
        for b in range(nb):
            p1 = pairs[b * block:(b + 1) * block]
            idsel = (p1 if cp.paired_id_match
                     else np.concatenate([p1, p1 + per_file]))
            _sink(f"id.{b}", _id_task, idbuf, idoffs, idlens, idsel)

    def _quality_sels(order_or_pairs) -> list:
        """(member name, global row indices) per output quality block (PE:
        file-1 rows then file-2 rows of the same pair block)."""
        if paired:
            nb = -(-per_file // block) if per_file else 0
            out = []
            for b in range(nb):
                p1 = order_or_pairs[b * block:(b + 1) * block]
                out.append((f"quality.{b}",
                            np.concatenate([p1, p1 + per_file])))
            return out
        return [(f"quality.{b}",
                 order_or_pairs[b * block:(b + 1) * block])
                for b in range(cp.num_blocks)]

    bin_threads = []

    def _start_quality_bins(sels):
        """Spool-backed quality compression on its own thread."""
        if spool is None or not sels:
            return
        import threading
        t = threading.Thread(
            target=qualstream.drive_quality_bins,
            args=(spool, _sink, sels, lengths, cp.quality_mode,
                  table, cp.qvz_ratio, fine_pos, inflight_cap),
            daemon=True)
        t.start()
        bin_threads.append(t)

    # in order-preserving mode the output order is known before the
    # reorder runs: id and quality codec work is submitted from the
    # engine's first progress callback (after the dictionary build)
    deferred_submitted = False

    def _release_ids():
        nonlocal idbuf, idoffs, idlens
        idbuf = idoffs = idlens = None

    def _submit_deferred():
        nonlocal deferred_submitted
        if deferred_submitted or not (cp.preserve_order and n):
            return
        deferred_submitted = True
        if paired:
            cp.num_blocks = -(-per_file // block) if per_file else 0
            pairs = np.arange(per_file, dtype=np.int64)
            _submit_ids_pe(pairs)
            _start_quality_bins(_quality_sels(pairs))
        else:
            order = np.arange(n, dtype=np.int64)
            _submit_ids_se(order)
            _start_quality_bins(_quality_sels(order))
        _release_ids()

    def _progress(_claimed, _total):
        _submit_deferred()

    mark("quantize+idcheck")
    has_n = overlay.has_n_mask(n)
    clean_rids = np.nonzero(~has_n)[0].astype(np.int32)

    # per-read metadata in int32 (offsets are guarded < 2^31 below)
    flag = np.zeros(n, np.uint8)
    gpos = np.zeros(n, np.int32)
    rc = np.zeros(n, np.uint8)
    nn_by_read = np.zeros(n, np.int32)
    noise_off = np.zeros(n, np.int32)      # read -> offset into noise arrays
    lay_rank = np.full(n, -1, np.int32)    # read -> rank in layout order
    noisepos = np.empty(0, np.int32)
    noisechar = np.empty(0, np.uint8)
    seq_codes = np.empty(0, np.uint8)

    # seq stream: u64 length + 2-bit packed consensus, submitted the moment
    # the consensus is final (after stitch)
    seq_submitted = False

    def _submit_seq():
        nonlocal seq_submitted
        if seq_submitted:
            return
        seq_submitted = True
        _sink("seq.0", _bsc1,
              np.uint64(len(seq_codes)).tobytes()
              + packing.codes_to_bitstream_2bit(
                  seq_codes[None, :], np.array([len(seq_codes)])))

    if len(clean_rids) and maxlen >= 32:
        c_len = lengths[clean_rids]
        # the clean-row gather happens on the device (engine `select`)
        engine = eng.ReorderEngine(
            packed_buf, lengths, eng.ReorderConfig(max_readlen=maxlen),
            select=clean_rids, device=device)
        mark("dict_build")
        emissions = engine.run(progress=_progress)
        _submit_deferred()      # zero-flush runs never fire the callback
        mark("reorder_run")
        # contigs below MIN_CONTIG_READS join the leftover pool and
        # re-place in the second-chance pass
        layout, _singles = cons.layout_from_emissions(
            emissions, engine.B, c_len, min_reads=P.MIN_CONTIG_READS,
            ordered=engine.ordered_emissions)
        engine.release()
        engine = None
        mark("assemble_contigs")
        if layout.seq_len:
            g = clean_rids[layout.rids]          # layout order -> global rid
            glay = cons.ContigLayout(rids=g.astype(np.int32),
                                     gpos=layout.gpos, rc=layout.rc,
                                     seq_len=layout.seq_len,
                                     cbase=layout.cbase, clen=layout.clen,
                                     ccount=layout.ccount)
            seq_codes = cons.build_consensus_packed(glay, packed_all,
                                                    lengths)
            mark("consensus")
            # stitch contigs whose heads re-align inside other contigs,
            # then re-vote the merged consensus
            glay2, n_st = stch.stitch_layout(glay, seq_codes, lengths,
                                             device=device)
            if n_st:
                glay = glay2
                g = glay.rids
                seq_codes = cons.build_consensus_packed(
                    glay, packed_all, lengths)
            mark(f"stitch[{n_st}]")
            if len(seq_codes) <= 2**31 - 1:     # guard below still fires
                _submit_seq()
            nn, noisepos, noisechar = cons.extract_noise_packed(
                glay, seq_codes, packed_all, lengths)
            mark("noise")
            if len(seq_codes) > 2**31 - 1 or len(noisepos) > 2**31 - 1:
                raise OverflowError(
                    "consensus/noise size exceeds int32 metadata "
                    f"({len(seq_codes)} bases, {len(noisepos)} noise)")
            flag[g] = 1
            gpos[g] = glay.gpos
            rc[g] = glay.rc
            nn_by_read[g] = nn
            noise_off[g] = np.concatenate(
                [[0], np.cumsum(nn.astype(np.int64))[:-1]]).astype(np.int32)
            lay_rank[g] = np.arange(len(g), dtype=np.int32)

    _submit_deferred()      # the engine may not have run

    # second chance: align N-reads and singleton-contig reads against the
    # consensus (reference src/encoder.h:242-351)
    leftover = np.nonzero(flag == 0)[0]
    if len(leftover) and len(seq_codes) >= 16 and maxlen >= 32:
        lens_l = lengths[leftover]
        nm_f, nm_r = overlay.nmask_planes(leftover, lens_l, ml)
        g2pos, g2rc, placed = sc.align_leftovers_packed(
            seq_codes, np.ascontiguousarray(packed_all[leftover]),
            nm_f, nm_r, lens_l, device=device)
        g2 = leftover[placed]
        if len(g2):
            order2 = np.argsort(g2pos[placed], kind="stable")
            g2 = g2[order2]
            flag[g2] = 1
            gpos[g2] = g2pos[placed][order2]
            rc[g2] = g2rc[placed][order2]
            lay2 = cons.ContigLayout(rids=g2.astype(np.int32),
                                     gpos=gpos[g2], rc=rc[g2],
                                     seq_len=len(seq_codes))
            nn2, npos2, nchar2 = cons.extract_noise_packed(
                lay2, seq_codes, packed_all, lengths, overlay)
            nn_by_read[g2] = nn2
            if len(noisepos) + len(npos2) > 2**31 - 1:
                raise OverflowError("noise array exceeds int32 offsets")
            noise_off[g2] = (len(noisepos) + np.concatenate(
                [[0], np.cumsum(nn2.astype(np.int64))[:-1]])
            ).astype(np.int32)
            noisepos = np.concatenate([noisepos, npos2])
            noisechar = np.concatenate([noisechar, nchar2])
            lay_rank[g2] = int((lay_rank >= 0).sum()) + np.arange(len(g2))
        mark("second_chance")

    device_done[0] = True       # tail codec tasks may widen to 2 threads

    unmatched = int((flag == 0).sum())
    eng.LAST_RUN_STATS["unmatched_frac"] = round(unmatched / max(n, 1), 5)

    _submit_seq()       # edge paths reach here without the early submission

    # free the packed row table before the stream codecs run: its only
    # remaining consumer is the literal stream, gathered into a small
    # side table first (skipped when literals are the bulk of the input)
    lit_rids = np.nonzero(flag == 0)[0].astype(np.int64)
    lit_chars_all = None
    if lit_rids.size * ml <= packed_buf.nbytes // 2:
        lit_chars_all = packing.CODE_TO_CHAR[
            cons.unpack_rows(packed_all, lit_rids, ml, overlay)]
        packed_all = packed_buf = None

    # --- output order (-r): re-block by the internal reorder. PE keeps
    # pairing implicit by position (src/pe_encode.cpp:41-69)
    if cp.preserve_order:
        order_out = np.arange(n, dtype=np.int32)
    else:
        seq_rank = lay_rank.copy()
        rest = np.nonzero(seq_rank < 0)[0]
        n_aligned = int((lay_rank >= 0).sum())
        seq_rank[rest] = n_aligned + np.arange(len(rest), dtype=np.int32)
        if paired:
            rank1 = np.argsort(seq_rank[:per_file],
                               kind="stable").astype(np.int32)
            order_out = np.concatenate([rank1, rank1 + per_file])
        else:
            order_out = np.argsort(seq_rank, kind="stable").astype(np.int32)

    def _noise_for(al: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Ragged gather of noise for aligned reads ``al`` (block order),
        positions delta-coded within each read (src/encoder.cpp:76-109)."""
        cnts = nn_by_read[al]
        starts = noise_off[al]
        tot = int(cnts.sum())
        if not tot:
            return np.empty(0, np.int32), np.empty(0, np.uint8)
        ends = np.cumsum(cnts)
        inner = np.arange(tot) - np.repeat(ends - cnts, cnts)
        take = np.repeat(starts, cnts) + inner
        npos_b, nchar_b = noisepos[take], noisechar[take]
        prev = np.concatenate([[0], npos_b[:-1]])
        return np.where(inner == 0, npos_b, npos_b - prev), nchar_b

    def _literal_blob(lit: np.ndarray) -> bytes:
        if lit_chars_all is not None:
            lit_chars = lit_chars_all[np.searchsorted(lit_rids, lit)]
        else:
            lit_chars = packing.CODE_TO_CHAR[
                cons.unpack_rows(packed_all, lit, ml, overlay)]
        lit_valid = np.arange(ml)[None, :] < lengths[lit, None]
        return lit_chars[lit_valid].tobytes()

    if paired:
        # --- PE pair-delta layout (reference flags 0-4 + int16 pair
        # distance + relative-RC bit, src/reorder_compress_streams.cpp:
        # 34-64,283-306)
        cp.num_blocks = -(-per_file // block) if per_file else 0
        pairs_out = order_out[:per_file]
        if not deferred_submitted:
            _submit_ids_pe(pairs_out)
            _start_quality_bins(_quality_sels(pairs_out))
            _release_ids()
        for b in range(cp.num_blocks):
            p1 = pairs_out[b * block:(b + 1) * block]
            p2 = p1 + per_file
            f1 = flag[p1] == 1
            f2 = flag[p2] == 1
            pdist = gpos[p2] - gpos[p1]
            near = np.abs(pdist) < 32767
            pflag = np.select(
                [f1 & f2 & near, f1 & f2, ~f1 & ~f2, f1 & ~f2],
                [0, 1, 2, 3], default=4).astype(np.uint8)
            pl0 = pflag == 0
            al1 = p1[f1]                      # flags 0,1,3 in pair order
            al2u = p2[f2 & ~pl0]              # flags 1,4 (unpaired r2)
            alr = np.concatenate([al1, p2[f2]])   # noise order: r1s, r2s
            lit = np.concatenate([p1[~f1], p2[~f2]])
            npos_b, nchar_b = _noise_for(alr)
            members = {
                f"flag.{b}": st.encode_u8(pflag),
                f"rlen.{b}": st.encode_u16(
                    np.stack([lengths[p1], lengths[p2]], 1).ravel()),
                f"pos.{b}": st.encode_deltas_u16(gpos[al1]),
                f"pos2.{b}": st.encode_deltas_u16(gpos[al2u]),
                f"pospair.{b}": st.encode_u16(
                    pdist[pl0].astype(np.int16).view(np.uint16)),
                f"rcpair.{b}": st.encode_u8(
                    (rc[p1[pl0]] == rc[p2[pl0]]).astype(np.uint8)),
                f"rc.{b}": st.encode_u8(
                    np.concatenate([rc[al1], rc[al2u]])),
                f"nn.{b}": st.encode_u16(nn_by_read[alr]),
                f"npos.{b}": st.encode_u16(npos_b),
                f"nchar.{b}": st.encode_u8(nchar_b),
                f"literal.{b}": _literal_blob(lit),
            }
            for name, raw in members.items():
                _sink(name, _bsc1, raw)
    else:
        if not deferred_submitted:
            _submit_ids_se(order_out)
            _start_quality_bins(_quality_sels(order_out))
            _release_ids()
        for b in range(cp.num_blocks):
            s, e = b * block, min((b + 1) * block, n)
            sel = order_out[s:e]
            al = sel[flag[sel] == 1]
            lit = sel[flag[sel] == 0]
            npos_b, nchar_b = _noise_for(al)
            members = {
                f"flag.{b}": st.encode_u8(flag[sel]),
                f"rlen.{b}": st.encode_u16(lengths[sel]),
                f"pos.{b}": st.encode_deltas_u16(gpos[al]),
                f"rc.{b}": st.encode_u8(rc[al]),
                f"nn.{b}": st.encode_u16(nn_by_read[al]),
                f"npos.{b}": st.encode_u16(npos_b),
                f"nchar.{b}": st.encode_u8(nchar_b),
                f"literal.{b}": _literal_blob(lit),
            }
            for name, raw in members.items():
                _sink(name, _bsc1, raw)

    mark("block_streams_submit")
    for t in bin_threads:
        t.join()
    mark("qbins_join")
    for fut in futs:
        fut.result()        # propagate codec/writer errors
    pool.shutdown()
    if spool is not None:
        spool.close()
    mark("codec+write")
