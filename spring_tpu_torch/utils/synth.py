"""Copied from spring_tpu/utils/synth.py; only the imports differ, and
make_se_fast (make_se's file, made faster) is the port's own.

Synthetic FASTQ dataset generator for benchmarks and A/B tests.

Models an SRR554369-class dataset (the reference's baseline log of
SRR554369, 8_29_18): a small genome sampled at
high coverage, 1% substitution noise, both strands, Illumina-like
position-correlated quality values. Supports single-end and paired-end
(two files, mates drawn from the same fragment with a normal insert
size, mate 2 reverse-complemented, as real Illumina PE data is).

Robustness-grid axes (VERDICT r2 #4) — the reference's benchmark
datasets are human-scale and variable-profile; with no network access
the grid must be synthesized. Beyond the base profile the generator can
vary: read length (uniform in [lo, hi], exercising variable-length
paths), quality alphabet (8-level Illumina bins or 40-level raw Phred
with error-correlated dips), N bases (rate of ambiguous calls, quality
forced to '#'), and id style ("affine" = strictly incrementing
SRA-style, "sra_perm" = SRA tokens with a permuted, non-monotonic read
index, "illumina" = tile/x/y coordinate ids).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

QLEVELS = b"#,7<BFIJ"  # Illumina 8-level-like bins
CHUNK_READS = 2_000_000  # make_se's reads a chunk of draws


def _quals(rng: np.random.Generator, n: int, read_len: int,
           levels: int = 8, err_mask: np.ndarray | None = None) -> np.ndarray:
    if levels <= 8:
        qlevels = np.frombuffer(QLEVELS, dtype=np.uint8)
        qidx = np.clip(
            rng.normal(6.0 - np.arange(read_len) / 40.0, 1.2,
                       size=(n, read_len)).astype(np.int32), 0, 7)
        q = qlevels[qidx]
    else:
        # 40-level raw Phred ('!'..'I'): high plateau decaying along the
        # read with noise, the shape real unbinned Illumina data has
        qidx = np.clip(
            rng.normal(38.0 - np.arange(read_len) / 8.0, 3.0,
                       size=(n, read_len)).astype(np.int32), 2, 40)
        q = (qidx + 33).astype(np.uint8)
    if err_mask is not None:
        # sequencing errors carry depressed quality (correlated streams)
        q[err_mask] = np.minimum(
            q[err_mask],
            (rng.integers(2, 12, size=int(err_mask.sum())) + 33
             ).astype(np.uint8))
    return q


def _ids(rng: np.random.Generator, n: int, read_len: int,
         style: str = "affine", mate: int = 0,
         base: int = 0) -> "list[str]":
    suffix = f"/{mate}" if mate else ""
    if style == "affine":
        if mate:
            return [f"@SYN.{base + i + 1}{suffix}" for i in range(n)]
        return [f"@SYN.{base + i + 1} {base + i + 1} length={read_len}"
                for i in range(n)]
    if style == "sra_perm":
        # SRA accession with a permuted spot index: breaks every
        # delta/affine assumption an id model might lean on
        perm = rng.permutation(n) + 1
        return [f"@SRR9876543.{perm[i]} {perm[i]} length={read_len}{suffix}"
                for i in range(n)]
    if style == "illumina":
        tile = rng.integers(1101, 2316, size=n)
        x = rng.integers(1000, 30000, size=n)
        y = rng.integers(1000, 30000, size=n)
        return [f"@M00321:42:000000000-A1B2C:1:{tile[i]}:{x[i]}:{y[i]}"
                f"{suffix}" for i in range(n)]
    raise ValueError(f"unknown id style {style!r}")


def _write_fastq(path: str, chars: np.ndarray, quals: np.ndarray,
                 ids: "list[str]", lens: np.ndarray | None = None,
                 mode: str = "wb") -> None:
    n = chars.shape[0]
    with open(path, mode) as f:
        block = 100_000
        for s in range(0, n, block):
            e = min(s + block, n)
            body = bytearray()
            for i in range(s, e):
                L = int(lens[i]) if lens is not None else chars.shape[1]
                body += ids[i].encode() + b"\n"
                body += chars[i, :L].tobytes() + b"\n+\n"
                body += quals[i, :L].tobytes() + b"\n"
            f.write(bytes(body))


def _apply_n(rng: np.random.Generator, chars: np.ndarray,
             quals: np.ndarray, n_rate: float) -> None:
    """Overwrite ~n_rate of all bases with 'N' (quality dropped to '#',
    as real basecallers emit for no-calls)."""
    if n_rate <= 0:
        return
    k = int(n_rate * chars.size)
    if k == 0:
        return
    r = rng.integers(0, chars.shape[0], size=k)
    c = rng.integers(0, chars.shape[1], size=k)
    chars[r, c] = ord("N")
    quals[r, c] = ord("#")


def make_se(path: str, n_reads: int, read_len: int = 100,
            genome_size: int = 2_000_000, err_rate: float = 0.01,
            seed: int = 42, len_range: "tuple[int, int] | None" = None,
            qual_levels: int = 8, n_rate: float = 0.0,
            id_style: str = "affine") -> None:
    """Single-end dataset: n_reads reads over a random genome.

    len_range=(lo, hi) draws per-read lengths uniformly (reads truncate
    from read_len = hi); qual_levels selects the 8-level bins or 40-level
    raw Phred; n_rate injects ambiguous bases; id_style picks the header
    scheme (see _ids).
    """
    rng = np.random.default_rng(seed)
    if len_range is not None:
        read_len = int(len_range[1])
    genome = rng.integers(0, 4, size=genome_size, dtype=np.int8)
    # permuted-id styles draw the id list whole (needs a global
    # permutation); sequential styles stream it per chunk
    ids_all = (_ids(rng, n_reads, read_len, id_style)
               if id_style != "affine" else None)
    # chunked generation: the float64 normals behind the quality model
    # are 8 bytes/base — one whole-dataset draw at 100M x 100 bp is
    # ~80 GB of transient; 2M-read chunks keep it ~1.6 GB
    chunk = CHUNK_READS
    mode = "wb"
    for c0 in range(0, n_reads, chunk):
        nc = min(chunk, n_reads - c0)
        starts = rng.integers(0, genome_size - read_len, size=nc)
        reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
        nerr = int(err_rate * nc * read_len)
        er = rng.integers(0, nc, size=nerr)
        ec = rng.integers(0, read_len, size=nerr)
        reads[er, ec] = (reads[er, ec] + rng.integers(1, 4, size=nerr)) % 4
        rc = rng.random(nc) < 0.5
        reads[rc] = 3 - reads[rc][:, ::-1]
        chars = np.frombuffer(b"ACGT", dtype=np.uint8)[reads]
        err_mask = None
        if qual_levels > 8:
            err_mask = np.zeros(reads.shape, bool)
            err_mask[er, ec] = True
            # reflect strand flips so depressed quality stays on the error
            err_mask[rc] = err_mask[rc][:, ::-1]
        quals = _quals(rng, nc, read_len, qual_levels, err_mask)
        _apply_n(rng, chars, quals, n_rate)
        lens = (rng.integers(len_range[0], len_range[1] + 1, size=nc)
                .astype(np.int32) if len_range is not None else None)
        ids = (ids_all[c0:c0 + nc] if ids_all is not None else
               _ids(rng, nc, read_len, id_style, base=c0))
        _write_fastq(path, chars, quals, ids, lens, mode=mode)
        mode = "ab"


def make_pe(path1: str, path2: str, n_pairs: int, read_len: int = 100,
            genome_size: int = 2_000_000, err_rate: float = 0.01,
            insert_mean: float = 300.0, insert_sd: float = 30.0,
            seed: int = 42, len_range: "tuple[int, int] | None" = None,
            qual_levels: int = 8, n_rate: float = 0.0,
            id_style: str = "affine") -> None:
    """Paired-end dataset: mate 1 forward, mate 2 reverse-complemented from
    the far end of the same fragment (standard Illumina FR orientation).
    Grid axes as in make_se; per-mate lengths are drawn independently."""
    rng = np.random.default_rng(seed)
    if len_range is not None:
        read_len = int(len_range[1])
    genome = rng.integers(0, 4, size=genome_size, dtype=np.int8)
    insert = np.clip(rng.normal(insert_mean, insert_sd, size=n_pairs),
                     read_len + 10, genome_size - 1).astype(np.int64)
    starts = rng.integers(0, genome_size - insert.max() - 1, size=n_pairs)
    r1 = genome[starts[:, None] + np.arange(read_len)[None, :]]
    s2 = starts + insert - read_len
    r2 = genome[s2[:, None] + np.arange(read_len)[None, :]]
    r2 = 3 - r2[:, ::-1]  # mate 2 is on the reverse strand
    err_masks = []
    for reads in (r1, r2):
        nerr = int(err_rate * n_pairs * read_len)
        er = rng.integers(0, n_pairs, size=nerr)
        ec = rng.integers(0, read_len, size=nerr)
        reads[er, ec] = (reads[er, ec] + rng.integers(1, 4, size=nerr)) % 4
        m = np.zeros(reads.shape, bool)
        m[er, ec] = True
        err_masks.append(m)
    # half the pairs flipped to the other strand (swap + RC both mates)
    flip = rng.random(n_pairs) < 0.5
    r1f = r1.copy()
    r1[flip] = 3 - r2[flip][:, ::-1]
    r2[flip] = 3 - r1f[flip][:, ::-1]
    m1f = err_masks[0].copy()
    err_masks[0][flip] = err_masks[1][flip][:, ::-1]
    err_masks[1][flip] = m1f[flip][:, ::-1]
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    ids1 = _ids(rng, n_pairs, read_len, id_style, mate=1)
    ids2 = _ids(rng, n_pairs, read_len, id_style, mate=2)
    if id_style != "affine":
        # mates must share the token body for PE id-pattern detection
        ids2 = [i[:-2] + "/2" for i in ids1]
    for pth, reads, ids, m in ((path1, r1, ids1, err_masks[0]),
                               (path2, r2, ids2, err_masks[1])):
        chars = base[reads]
        quals = _quals(rng, n_pairs, read_len,
                       qual_levels, m if qual_levels > 8 else None)
        _apply_n(rng, chars, quals, n_rate)
        lens = (rng.integers(len_range[0], len_range[1] + 1, size=n_pairs)
                .astype(np.int32) if len_range is not None else None)
        _write_fastq(pth, chars, quals, ids, lens)


def _affine_records(first: int, chars: np.ndarray,
                    quals: np.ndarray) -> bytes:
    """_write_fastq's bytes for fixed-length reads with affine single-end
    ids numbered from ``first``, laid out as whole arrays (one row a
    record, one block of rows a count of digits)."""
    n, L = chars.shape
    tail = np.frombuffer(f" length={L}\n".encode(), np.uint8)
    mid = np.frombuffer(b"\n+\n", np.uint8)
    g = np.arange(first, first + n, dtype=np.int64)
    out = []
    i = 0
    while i < n:
        d = len(str(int(g[i])))
        j = int(np.searchsorted(g, 10 ** d))
        num = np.empty((j - i, d), np.uint8)
        rest = g[i:j].copy()
        for k in range(d - 1, -1, -1):
            num[:, k] = rest % 10 + 48
            rest //= 10
        cols = [np.broadcast_to(np.frombuffer(b"@SYN.", np.uint8),
                                (j - i, 5)), num,
                np.full((j - i, 1), 32, np.uint8), num,
                np.broadcast_to(tail, (j - i, len(tail))), chars[i:j],
                np.broadcast_to(mid, (j - i, 3)), quals[i:j],
                np.full((j - i, 1), 10, np.uint8)]
        out.append(np.concatenate(cols, axis=1).tobytes())
        i = j
    return b"".join(out)


def _affine_bytes(first: int, n: int, read_len: int) -> int:
    """Bytes of n such records numbered from ``first``."""
    fixed = 5 + 1 + len(f" length={read_len}\n") + 2 * read_len + 4
    total = n * fixed
    d = 1
    while 10 ** (d - 1) < first + n:
        lo, hi = max(first, 10 ** (d - 1)), min(first + n, 10 ** d)
        total += 2 * d * max(0, hi - lo)
        d += 1
    return total


def make_se_fast(path: str, n_reads: int, read_len: int = 100,
                 genome_size: int = 2_000_000, seed: int = 42,
                 workers: int = 4) -> None:
    """make_se's file for its default profile (fixed-length reads, 1%
    substitutions, 8 quality levels, no N, affine ids), byte for byte,
    made faster: this thread draws the random numbers in make_se's order
    and ``workers`` threads build and write each 2M-read chunk's records
    at its offset, which the read count alone fixes."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_size, dtype=np.int8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    qlevels = np.frombuffer(QLEVELS, dtype=np.uint8)
    loc = 6.0 - np.arange(read_len) / 40.0
    chunk = CHUNK_READS
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)

    def build(c0, off, starts, er, ec, errs, rc, q):
        reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
        reads[er, ec] = (reads[er, ec] + errs) % 4
        reads[rc] = 3 - reads[rc][:, ::-1]
        # make_se truncates to int32, then clips to [0, 7]: clipping the
        # float first gives the same levels
        np.clip(q, 0, 7, out=q)
        buf = memoryview(_affine_records(c0 + 1, acgt[reads],
                                         qlevels[q.astype(np.uint8)]))
        while len(buf):
            k = os.pwrite(fd, buf, off)
            buf, off = buf[k:], off + k

    try:
        with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            futs = []
            off = 0
            for c0 in range(0, n_reads, chunk):
                nc = min(chunk, n_reads - c0)
                starts = rng.integers(0, genome_size - read_len, size=nc)
                nerr = int(0.01 * nc * read_len)
                er = rng.integers(0, nc, size=nerr)
                ec = rng.integers(0, read_len, size=nerr)
                errs = rng.integers(1, 4, size=nerr)
                rc = rng.random(nc) < 0.5
                q = rng.normal(loc, 1.2, size=(nc, read_len))
                futs.append(ex.submit(build, c0, off, starts, er, ec, errs,
                                      rc, q))
                del q
                off += _affine_bytes(c0 + 1, nc, read_len)
                # at most one chunk a worker, and the next, in flight
                while len(futs) > max(1, workers):
                    futs.pop(0).result()
            for f in futs:
                f.result()
        os.ftruncate(fd, off)
    finally:
        os.close(fd)
