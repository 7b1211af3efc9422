"""Copied from spring_tpu/io/fastq.py; only the imports differ.

FASTQ/FASTA block reader and writer, with transparent gzip.

Reference analog: read_fastq_block (src/util.cpp:31-54) and
write_fastq_block (src/util.cpp:56-111). The reference reads 4 lines per
FASTQ record into string arrays in blocks; its writer gzips per-thread
sub-ranges in RAM and concatenates them in order (gzip members are
concatenable). We keep the block abstraction (it is the unit of
data-parallelism and of random access) but do the parsing with buffered
byte I/O; the parallel-gzip trick is reproduced with concurrent.futures.
"""
from __future__ import annotations

import gzip
import io
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator, Optional

# one gzip member per ~this many bytes when writing .gz in parallel
_GZ_CHUNK_RECORDS = 65536


@dataclass
class ReadBlock:
    """One block of records. quals is empty for FASTA."""
    ids: list[bytes] = field(default_factory=list)
    seqs: list[bytes] = field(default_factory=list)
    quals: list[bytes] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.seqs)


def _open_maybe_gz(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else b""
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=1 << 20)
    return io.BufferedReader(f, buffer_size=1 << 20)


def is_gzipped(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def sniff_fasta(path: str) -> bool:
    with _open_maybe_gz(path) as f:
        first = f.read(1)
    return first == b">"


def read_blocks(path: str, block_size: int, fasta: bool = False) -> Iterator[ReadBlock]:
    """Yield ReadBlocks of up to block_size records.

    FASTQ: strict 4-line records (id, seq, +, qual), like the reference
    (src/util.cpp:38-49). FASTA: '>'-headed records, multi-line sequence
    allowed (superset of the reference's single-line reader).
    """
    with _open_maybe_gz(path) as f:
        if fasta:
            yield from _read_fasta_blocks(f, block_size)
            return
        block = ReadBlock()
        while True:
            idline = f.readline()
            if not idline:
                break
            seq = f.readline()
            plus = f.readline()
            qual = f.readline()
            if not qual:
                raise ValueError(f"{path}: truncated FASTQ record")
            # Id lines are stored VERBATIM including the leading '@' (the
            # reference does the same, src/util.cpp:38-49) — the CI fixture
            # contains empty id lines and empty reads that must round-trip.
            block.ids.append(idline.rstrip(b"\r\n"))
            block.seqs.append(seq.rstrip(b"\r\n"))
            block.quals.append(qual.rstrip(b"\r\n"))
            if len(block) == block_size:
                yield block
                block = ReadBlock()
        if len(block):
            yield block


def _read_fasta_blocks(f, block_size: int) -> Iterator[ReadBlock]:
    # Strict 2-line records with verbatim header lines — the reference's
    # FASTA mode (src/util.cpp:38-54 with fasta flag) reads exactly one
    # header + one sequence line per record and does not interpret the
    # header sigil (its own fixtures use '@' headers).
    block = ReadBlock()
    while True:
        idline = f.readline()
        if not idline:
            break
        seq = f.readline()
        block.ids.append(idline.rstrip(b"\r\n"))
        block.seqs.append(seq.rstrip(b"\r\n"))
        if len(block) == block_size:
            yield block
            block = ReadBlock()
    if len(block):
        yield block


def count_reads(path: str, fasta: bool = False) -> int:
    n = 0
    for b in read_blocks(path, 1 << 20, fasta=fasta):
        n += len(b)
    return n


class BlockWriter:
    """Ordered FASTQ/FASTA writer with optional parallel gzip.

    Parallel gzip mirrors the reference's trick (src/util.cpp:72-106):
    compress independent chunks to RAM concurrently, then write the gzip
    members back-to-back — the result is a valid multi-member gzip file.
    """

    def __init__(self, path: str, gzipped: bool = False, fasta: bool = False,
                 num_threads: int = 8, append: bool = False):
        # append: continue an output started by an earlier call (the
        # super-shard decompress loop); gzip stays valid because members
        # are concatenable
        self.path = path
        self.gzipped = gzipped
        self.fasta = fasta
        self._f = open(path, "ab" if append else "wb")
        self._pool = ThreadPoolExecutor(max_workers=num_threads) if gzipped else None

    def write_block(self, ids: list[bytes], seqs: list[bytes],
                    quals: Optional[list[bytes]] = None) -> None:
        texts = []
        for start in range(0, len(seqs), _GZ_CHUNK_RECORDS):
            end = min(start + _GZ_CHUNK_RECORDS, len(seqs))
            buf = bytearray()
            if self.fasta or quals is None:
                # FASTA, or quality discarded: 2-line records, like the
                # reference writer with preserve_quality=false
                # (src/util.cpp:62-68). Ids are verbatim lines.
                for i in range(start, end):
                    buf += ids[i] + b"\n" + seqs[i] + b"\n"
            else:
                for i in range(start, end):
                    buf += (ids[i] + b"\n" + seqs[i] + b"\n+\n"
                            + quals[i] + b"\n")
            texts.append(bytes(buf))
        if self.gzipped:
            for chunk in self._pool.map(_gzip_member, texts):
                self._f.write(chunk)
        else:
            for t in texts:
                self._f.write(t)

    def write_bytes(self, blob: bytes) -> None:
        """Write pre-formatted record text (from the native formatter),
        gzipping in parallel chunks when requested."""
        if not self.gzipped:
            self._f.write(blob)
            return
        chunk = 4 << 20
        pieces = [blob[i:i + chunk] for i in range(0, len(blob), chunk)]
        for out in self._pool.map(_gzip_member, pieces):
            self._f.write(out)

    def close(self) -> None:
        if self._pool:
            self._pool.shutdown()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _gzip_member(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    return co.compress(data) + co.flush()
