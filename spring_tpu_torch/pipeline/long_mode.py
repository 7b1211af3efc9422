"""Copied from spring_tpu/pipeline/long_mode.py; only the imports differ.

Long-read mode: per-block native compression of raw streams.

Reference analog: the `-l` path — preprocess compresses reads/qualities/ids
per 10k-read block with BSC and skips reorder/encode entirely
(src/preprocess.cpp:251-283, guard src/spring.cpp:150); decompress_long
(src/decompress.cpp:438-613) restores blocks and supports random access.

Layout: per input file j in {1,2}: streams `read{j}.<b>`, `quality{j}.<b>`,
`id{j}.<b>` for block b. PE files are processed in lock-step so the paired
id pattern can be verified block-locally; when it holds for every pair,
file-2 ids are not stored (reference invariant, src/preprocess.cpp:287-292).
"""
from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import params as P
from ..codecs import bsc, idcodec, qv
from ..io import fastq
from ..io.container import ArchiveReader, ArchiveWriter
from ..io.ids import check_id_pattern, find_id_pattern, modify_id
from . import quality as qual_mod


def compress_long(files: list[str], writer: ArchiveWriter,
                  cp: P.CompressionParams, num_threads: int = 8) -> None:
    block = cp.num_reads_per_block_long
    table = qual_mod.make_table(cp.quality_mode, cp.qvz_ratio, cp.bin_thresholds)
    readers = [fastq.read_blocks(f, block, fasta=cp.fasta_input) for f in files]
    paired = len(files) == 2
    pattern_code = 0
    pattern_ok = paired
    first_pair = True
    counts = [0, 0]
    nblocks = [0, 0]
    pool = ThreadPoolExecutor(max_workers=num_threads)

    # adaptive mode race: once 8 consecutive read blocks picked the same
    # wire mode, later blocks encode only that way (the raw-vs-packed race
    # doubles the reads-compression CPU; files are homogeneous in practice,
    # and the per-block mode byte keeps decode oblivious). Appends are
    # GIL-atomic; a stale read just races one more block.
    modes_seen: list = []

    def _reads_task(seqs):
        force = None
        tail = modes_seen[-8:]
        if len(tail) == 8 and len(set(tail)) == 1:
            force = tail[0]
        z = bsc.compress_dna_str_array(seqs, _force=force, num_threads=1)
        modes_seen.append(z[0])
        return z

    pending_id2: list = []  # (bidx, future) of file-2 id blocks, held until
    # the pattern verdict is known (if the pattern holds they are dropped)
    # codec work stays in flight across blocks (waiting on each block's
    # futures before reading the next serialized the whole pipeline);
    # the deque bound caps parsed-but-uncompressed block memory
    from collections import deque
    inflight: deque = deque()

    def drain(limit: int) -> None:
        while len(inflight) > limit:
            stream, b_i, fut = inflight.popleft()
            writer.add_block(stream, b_i, fut.result())
    for bidx, blocks in enumerate(itertools.zip_longest(*readers)):
        if paired:
            if (blocks[0] is None) != (blocks[1] is None):
                raise ValueError("paired files have different read counts")
        for j, blk in enumerate(blocks):
            if blk is None:
                continue
            if not cp.fasta_input:
                from .short_mode import check_quality_lengths
                check_quality_lengths(blk, files[j])
            counts[j] += len(blk)
            nblocks[j] = bidx + 1
            quals = blk.quals
            if quals and table is not None:
                quals = qual_mod.quantize_block(quals, table)
            elif quals and cp.quality_mode == "qvz":
                from . import qvz
                quals = qvz.quantize_block(quals, cp.qvz_ratio)
            futs = {}
            futs["read"] = pool.submit(_reads_task, blk.seqs)
            if cp.preserve_quality and quals:
                futs["quality"] = pool.submit(qv.compress_str_array, quals,
                                              num_threads=1)
            if cp.preserve_id:
                futs["id"] = pool.submit(idcodec.compress_ids, blk.ids)
            for stream, fut in futs.items():
                if stream == "id" and j == 1:
                    pending_id2.append((bidx, fut))
                else:
                    inflight.append((f"{stream}{j + 1}", bidx, fut))
            drain(3 * num_threads)
        if paired and cp.preserve_id:
            b1, b2 = blocks
            if first_pair and len(b1):
                pattern_code = find_id_pattern(b1.ids[0], b2.ids[0])
                first_pair = False
            if pattern_ok and pattern_code:
                for i1, i2 in zip(b1.ids, b2.ids):
                    if not check_id_pattern(i1, i2, pattern_code):
                        pattern_ok = False
                        break
            else:
                pattern_ok = False
    drain(0)
    pool.shutdown()
    if paired and counts[0] != counts[1]:
        raise ValueError("paired files have different read counts")
    cp.paired_id_match = bool(paired and cp.preserve_id and pattern_ok
                              and pattern_code)
    cp.paired_id_code = pattern_code if cp.paired_id_match else 0
    if not cp.paired_id_match:
        for bidx, fut in pending_id2:
            writer.add_block("id2", bidx, fut.result())
    cp.num_reads = sum(counts)
    cp.num_blocks = max(nblocks)


def decompress_long(reader: ArchiveReader, out_paths: list[str],
                    gzipped: bool, num_threads: int = 8,
                    read_range: tuple[int, int] | None = None) -> None:
    cp = reader.params
    block = cp.num_reads_per_block_long
    paired = cp.paired_end
    nfiles = 2 if paired else 1
    per_file = cp.num_reads // nfiles
    single_out = len(out_paths) == 1

    # range semantics (reference src/spring.cpp:349-359): global indices over
    # [file-1 reads, file-2 reads], 1-based inclusive at CLI, here 0-based
    # half-open.
    lo, hi = (0, cp.num_reads) if read_range is None else read_range

    writers = [fastq.BlockWriter(p, gzipped=gzipped, fasta=cp.fasta_input,
                                 num_threads=num_threads)
               for p in out_paths]
    pool = ThreadPoolExecutor(max_workers=num_threads)
    try:
        for j in range(nfiles):
            w = writers[0] if single_out else writers[j]
            flo = max(lo - j * per_file, 0)
            fhi = min(hi - j * per_file, per_file)
            if flo >= fhi:
                continue
            b0, b1 = flo // block, (fhi - 1) // block
            futs = [pool.submit(_decode_block, reader, cp, j, b, per_file)
                    for b in range(b0, b1 + 1)]
            for b, fut in zip(range(b0, b1 + 1), futs):
                ids, seqs, quals = fut.result()
                s = max(flo - b * block, 0)
                e = min(fhi - b * block, len(seqs))
                w.write_block(ids[s:e], seqs[s:e],
                              quals[s:e] if quals else None)
    finally:
        pool.shutdown()
        for w in writers:
            w.close()


def _decode_block(reader: ArchiveReader, cp: P.CompressionParams, j: int,
                  b: int, per_file: int):
    read_blob = reader.get_block(f"read{j + 1}", b)
    if cp.version >= 3:   # v3: mode-byte DNA wire; v2 wrote the raw wire
        seqs = bsc.decompress_dna_str_array(read_blob, num_threads=1)
    else:
        seqs = bsc.decompress_str_array(read_blob, num_threads=1)
    quals = None
    if cp.preserve_quality and not cp.fasta_input:
        quals = qv.decompress_str_array(
            reader.get_block(f"quality{j + 1}", b))
    if cp.preserve_id:
        if j == 1 and cp.paired_id_match:
            ids1 = idcodec.decompress_ids(reader.get_block("id1", b), len(seqs))
            ids = [modify_id(i, cp.paired_id_code) for i in ids1]
        else:
            ids = idcodec.decompress_ids(reader.get_block(f"id{j + 1}", b),
                                         len(seqs))
    else:
        # fake ids (reference src/decompress.cpp:374-378)
        base = j * per_file + b * cp.num_reads_per_block_long
        ids = [f"@{base + i + 1}/{j + 1}".encode() for i in range(len(seqs))]
    return ids, seqs, quals
