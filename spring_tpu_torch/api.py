"""Top-level compress/decompress API of the port.

Copy of spring_tpu/api.py, plus an explicit torch ``device`` for
short-mode compress. Long mode (-l) and decompress are host code and
have no device stage.

Reference analog: spring::compress / spring::decompress
(src/spring.h:23-36, src/spring.cpp:41-377) — validates options, sequences
the pipeline stages with per-stage timing, and owns the archive lifecycle.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

from . import params as P
from .io.container import ArchiveReader, ArchiveWriter

__all__ = ["CompressOptions", "compress", "decompress"]


@dataclass
class CompressOptions:
    reorder: bool = False            # -r: do not preserve read order
    preserve_quality: bool = True
    preserve_id: bool = True
    long_mode: bool = False          # -l
    fasta_input: bool = False
    quality_mode: str = "lossless"   # lossless | qvz | ill_bin | binary
    qvz_ratio: float = 8.0
    bin_thresholds: tuple = ()
    num_threads: int = 8
    verbose: bool = True


def _log(opts, msg: str) -> None:
    if opts.verbose:
        print(msg, flush=True)


def validate_options(files: list[str], opts: CompressOptions) -> None:
    """Flag validation (reference src/spring.cpp:98-136)."""
    if len(files) not in (1, 2):
        raise ValueError("expected 1 (SE) or 2 (PE) input files")
    if opts.quality_mode not in P.QUALITY_MODES:
        raise ValueError(f"quality mode must be one of {P.QUALITY_MODES}")
    if opts.quality_mode == "binary" and len(opts.bin_thresholds) != 3:
        raise ValueError("binary quality mode needs (threshold, high, low)")
    if opts.fasta_input and opts.quality_mode != "lossless":
        raise ValueError("quality modes do not apply to FASTA input")
    for f in files:
        if not os.path.exists(f):
            raise FileNotFoundError(f)


def compress(files: list[str], output: str,
             opts: CompressOptions | None = None,
             device="cuda") -> P.CompressionParams:
    """Compress 1 (SE) or 2 (PE) FASTQ/FASTA files into ``output``; the
    short-mode device stages run on ``device``."""
    opts = opts or CompressOptions()
    validate_options(files, opts)
    cp = P.CompressionParams(
        paired_end=len(files) == 2,
        preserve_order=not opts.reorder,
        preserve_quality=opts.preserve_quality and not opts.fasta_input,
        preserve_id=opts.preserve_id,
        long_mode=opts.long_mode,
        fasta_input=opts.fasta_input,
        quality_mode=opts.quality_mode,
        qvz_ratio=opts.qvz_ratio,
        bin_thresholds=tuple(opts.bin_thresholds),
    )
    t0 = time.time()
    # short mode spools: codec workers write members as they complete
    # (bounded memory), tar emitted in canonical order at finish()
    with ArchiveWriter(output, spooled=not opts.long_mode) as writer:
        if opts.long_mode:
            from .pipeline import long_mode
            long_mode.compress_long(files, writer, cp, opts.num_threads)
        else:
            from .pipeline import short_mode
            short_mode.compress_short(files, writer, cp, opts.num_threads,
                                      device=device)
        writer.finish(cp)
    _log(opts, f"compressed {cp.num_reads} reads -> "
               f"{os.path.getsize(output)} bytes in {time.time()-t0:.2f}s")
    if opts.verbose:
        # per-stream compressed size report (reference src/spring.cpp:228-248)
        with ArchiveReader(output) as r:
            sizes = r.size_by_prefix()
        groups = {"reads": ("seq", "pos", "rc", "flag", "rlen", "nn", "npos",
                            "nchar", "literal", "read1", "read2"),
                  "quality": ("quality", "quality1", "quality2"),
                  "id": ("id", "id1", "id2")}
        for gname, members in groups.items():
            sz = sum(sizes.get(m, 0) for m in members)
            if sz:
                _log(opts, f"  {gname} stream: {sz} bytes")
        _log(opts, f"  total (incl. container): {sum(sizes.values())} bytes")
    return cp


def decompress(archive: str, outputs: list[str], gzipped: bool = False,
               num_threads: int = 8,
               read_range: tuple[int, int] | None = None,
               verbose: bool = True) -> P.CompressionParams:
    """Decompress ``archive`` into ``outputs`` (host code only);
    ``read_range`` is a 0-based half-open range."""
    t0 = time.time()
    with ArchiveReader(archive) as reader:
        cp = reader.params
        if read_range is not None:
            lo, hi = read_range
            if not (0 <= lo < hi <= cp.num_reads):
                raise ValueError(
                    f"invalid read range [{lo}, {hi}) for {cp.num_reads} reads")
        if cp.paired_end and len(outputs) not in (1, 2):
            raise ValueError("PE archive needs 1 or 2 output files")
        if not cp.paired_end and len(outputs) != 1:
            raise ValueError("SE archive needs exactly 1 output file")
        if cp.long_mode:
            from .pipeline import long_mode
            long_mode.decompress_long(reader, outputs, gzipped, num_threads,
                                      read_range)
        elif cp.shard_reads:
            from .pipeline import short_mode
            short_mode.decompress_short_sharded(reader, outputs, gzipped,
                                                num_threads, read_range)
        else:
            from .pipeline import short_mode
            short_mode.decompress_short(reader, outputs, gzipped, num_threads,
                                        read_range)
    if verbose:
        print(f"decompressed in {time.time()-t0:.2f}s", flush=True)
    return cp
