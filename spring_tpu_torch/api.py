"""Top-level compress/decompress API of the port.

Same contract as spring_tpu.api, plus an explicit torch ``device`` for
short-mode compress. Long mode (-l) is host code and goes to
spring_tpu.pipeline.long_mode; decompress has no device stage and is
spring_tpu.api.decompress.
"""
from __future__ import annotations

import os
import subprocess
import time

import spring_tpu
from spring_tpu import api as _tpu_api
from spring_tpu import params as P
from spring_tpu.api import CompressOptions, validate_options
from spring_tpu.codecs import native
from spring_tpu.io.container import ArchiveReader, ArchiveWriter

__all__ = ["CompressOptions", "compress", "decompress"]


def _log(opts, msg: str) -> None:
    if opts.verbose:
        print(msg, flush=True)


def load_host_library() -> None:
    """Build (at first use) and load spring_tpu's native host library.

    spring_tpu builds it with ``make`` and the environment's CXX; where
    that compiler cannot link OpenMP (no libgomp.spec), build it once
    more with the g++ on PATH."""
    try:
        native.load()
    except subprocess.CalledProcessError:
        csrc = os.path.join(os.path.dirname(spring_tpu.__file__), "csrc")
        res = subprocess.run(["make", "-s", "-C", csrc, "libspringtpu.so",
                              "CXX=g++"], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {csrc}/libspringtpu.so failed:\n"
                               f"{res.stderr[-4000:]}") from None
        native.load()


def compress(files: list[str], output: str,
             opts: CompressOptions | None = None,
             device="cuda") -> P.CompressionParams:
    """Compress 1 (SE) or 2 (PE) FASTQ/FASTA files into ``output``; the
    short-mode device stages run on ``device``."""
    opts = opts or CompressOptions()
    validate_options(files, opts)
    load_host_library()
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
    with ArchiveWriter(output, spooled=not opts.long_mode) as writer:
        if opts.long_mode:
            from spring_tpu.pipeline import long_mode
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
    """spring_tpu.api.decompress (host code only: decompress has no device
    stage), after making sure the native host library is built."""
    load_host_library()
    return _tpu_api.decompress(archive, outputs, gzipped=gzipped,
                               num_threads=num_threads,
                               read_range=read_range, verbose=verbose)
