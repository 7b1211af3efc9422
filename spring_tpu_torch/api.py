"""Top-level compress/decompress API of the port.

Copy of spring_tpu/api.py, plus an explicit torch ``device`` for
short-mode compress, ``CompressOptions.dist`` for the distributed
reorder engine (parallel/dist.py), and ``CompressOptions.engine``,
``min_contig_reads`` and ``stitch``: the settings the JAX package reads
from its environment in short-mode compress. Long mode (-l) and
decompress are host code and have no device stage.

Reference analog: spring::compress / spring::decompress
(src/spring.h:23-36, src/spring.cpp:41-377) — validates options, sequences
the pipeline stages with per-stage timing, and owns the archive lifecycle.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from . import params as P
from .io.container import ArchiveReader, ArchiveWriter
from .ops.graphs import clear_program_cache

__all__ = ["CompressOptions", "clear_program_cache", "compress",
           "decompress"]

# the ReorderConfig fields that CompressOptions.engine may set
ENGINE_KEYS = ("num_walkers", "shift_chunk", "accept_slots", "far_near",
               "cap_per_round", "rebuild_fraction", "flush_rounds",
               "force_wide")


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
    # short mode: reorder on the distributed engine, over the ranks that
    # parallel.multihost.maybe_initialize finds (one rank without a
    # launcher); every rank makes the same call, rank 0 writes the archive
    dist: bool = False
    # short mode: overrides of the reorder engine's ReorderConfig fields
    # (ENGINE_KEYS); on the distributed engine only rebuild_fraction and
    # flush_rounds apply, as in the JAX package
    engine: dict = field(default_factory=dict)
    # short mode: contigs of fewer reads join the leftover pool
    min_contig_reads: int = P.MIN_CONTIG_READS
    stitch: bool = True              # stitch overlapping contigs
    # short mode, inputs of short_mode.STAGER_MIN_READS reads and up: copy
    # the parsed rows to the device while the parse runs
    stager: bool = True


class _DiscardWriter:
    """The archive writer of a rank other than 0: it keeps nothing."""

    def add(self, name: str, data: bytes) -> None:
        pass

    def finish(self, params) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


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
    unknown = sorted(set(getattr(opts, "engine", {})) - set(ENGINE_KEYS))
    if unknown:
        raise ValueError(f"unknown engine settings {unknown}; known: "
                         f"{list(ENGINE_KEYS)}")
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
    # an options object of spring_tpu's shape, without these fields, is
    # taken with their defaults
    short = dict(engine=getattr(opts, "engine", {}),
                 min_contig_reads=getattr(opts, "min_contig_reads",
                                          P.MIN_CONTIG_READS),
                 stitch=getattr(opts, "stitch", True),
                 stager=getattr(opts, "stager", True))
    world = None
    # an options object of spring_tpu's shape, without the field, is taken
    if getattr(opts, "dist", False) and not opts.long_mode:
        from .parallel import multihost
        world = multihost.maybe_initialize(device)
        device = world.device
    if world is not None and world.rank != 0:
        with _DiscardWriter() as writer:
            from .pipeline import short_mode
            short_mode.compress_short(files, writer, cp, opts.num_threads,
                                      device=device, world=world, **short)
        return cp
    # short mode spools: codec workers write members as they complete
    # (bounded memory), tar emitted in canonical order at finish()
    with ArchiveWriter(output, spooled=not opts.long_mode) as writer:
        if opts.long_mode:
            from .pipeline import long_mode
            long_mode.compress_long(files, writer, cp, opts.num_threads)
        else:
            from .pipeline import short_mode
            short_mode.compress_short(files, writer, cp, opts.num_threads,
                                      device=device, world=world, **short)
        writer.finish(cp)
    _log(opts, f"compressed {cp.num_reads} reads -> "
               f"{os.path.getsize(output)} bytes in {time.time()-t0:.2f}s")
    if opts.verbose:
        # per-stream compressed size report (reference src/spring.cpp:228-248)
        from .pipeline import blocks
        with ArchiveReader(output) as r:
            sizes = r.size_by_prefix()
        groups = {"reads": blocks.READ_STREAMS + ("read1", "read2"),
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
