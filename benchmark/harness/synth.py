"""The benchmark's generator of synthetic FASTQ inputs.

A frozen copy of spring_tpu_torch/utils/synth.py's make_pe (with _quals
and _apply_n) as of commit b2b9e62, for the profiles the benchmark's
traffic files can ask for: paired-end, fixed-length reads, affine ids,
8 or 40 quality levels, any substitution and N rate. It writes the same
bytes for the same arguments, made faster: this thread draws the random
numbers in the original's order, and worker threads turn the draws into
quality levels and build and write the records at offsets that the read
count alone fixes. numpy only; it imports nothing of the program.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

QLEVELS = b"#,7<BFIJ"  # Illumina 8-level-like bins
ROWS = 1 << 18           # records a worker's task
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
NUM = None               # the read number's place in an id's pieces


def generate(traffic: dict, seed: int, paths: list, workers: int = 4) -> None:
    """Write a traffic file's records for ``seed`` into ``paths`` (one
    file a mate)."""
    kw = dict(read_len=traffic["read_len"],
              genome_size=traffic["genome_size"],
              err_rate=traffic["err_rate"], seed=seed,
              qual_levels=traffic["qual_levels"],
              n_rate=traffic.get("n_rate", 0.0), workers=workers)
    if traffic.get("id_style", "affine") != "affine" or traffic["mates"] != 2:
        raise ValueError("the generator writes paired-end reads with "
                         "affine ids only")
    make_pe(paths[0], paths[1], traffic["pairs"],
            insert_mean=traffic["insert_mean"],
            insert_sd=traffic["insert_sd"], **kw)


def _levels(q: np.ndarray, qual_levels: int) -> np.ndarray:
    """_quals' float draws -> quality characters."""
    if qual_levels <= 8:
        qidx = np.clip(q.astype(np.int32), 0, 7)
        return np.frombuffer(QLEVELS, dtype=np.uint8)[qidx]
    qidx = np.clip(q.astype(np.int32), 2, 40)
    return (qidx + 33).astype(np.uint8)


def _quals(rng, ex, n: int, read_len: int, levels: int,
           err_mask: np.ndarray | None) -> np.ndarray:
    """_quals' array: the normals drawn in blocks of rows (the same
    stream as one draw), each block's levels taken in a worker."""
    if levels <= 8:
        loc, sd = 6.0 - np.arange(read_len) / 40.0, 1.2
    else:
        loc, sd = 38.0 - np.arange(read_len) / 8.0, 3.0
    out = np.empty((n, read_len), np.uint8)

    def conv(r0, q):
        q *= sd
        q += loc
        out[r0:r0 + len(q)] = _levels(q, levels)

    futs = []
    for r0 in range(0, n, ROWS):
        # rng.normal(loc, sd, size) is loc + sd * z of these z, in this
        # order, which the worker applies: the same floats
        q = rng.standard_normal(size=(min(ROWS, n - r0), read_len))
        futs.append(ex.submit(conv, r0, q))
        del q
        while len(futs) > 2:
            futs.pop(0).result()
    for f in futs:
        f.result()
    if err_mask is not None:
        # sequencing errors carry depressed quality (correlated streams)
        out[err_mask] = np.minimum(
            out[err_mask],
            (rng.integers(2, 12, size=int(err_mask.sum())) + 33
             ).astype(np.uint8))
    return out


def _apply_n(rng, chars: np.ndarray, quals: np.ndarray,
             n_rate: float) -> None:
    """Overwrite ~n_rate of all bases with 'N' (quality dropped to '#')."""
    if n_rate <= 0:
        return
    k = int(n_rate * chars.size)
    if k == 0:
        return
    r = rng.integers(0, chars.shape[0], size=k)
    c = rng.integers(0, chars.shape[1], size=k)
    chars[r, c] = ord("N")
    quals[r, c] = ord("#")


def _gather(genome: np.ndarray, starts: np.ndarray, read_len: int):
    """genome[starts[:, None] + arange(read_len)], in blocks of rows."""
    out = np.empty((len(starts), read_len), genome.dtype)
    span = np.arange(read_len)[None, :]
    for r0 in range(0, len(starts), ROWS):
        out[r0:r0 + ROWS] = genome[starts[r0:r0 + ROWS, None] + span]
    return out


def _records(first: int, pieces: tuple, chars: np.ndarray,
             quals: np.ndarray) -> bytes:
    """The original's _write_fastq bytes for fixed-length reads whose ids
    are ``pieces`` with the read number (from ``first``) at each NUM,
    laid out as whole arrays (one row a record, one block of rows a
    count of digits)."""
    n, L = chars.shape
    g = np.arange(first, first + n, dtype=np.int64)
    mid = np.frombuffer(b"\n+\n", np.uint8)
    nl = np.full((n, 1), 10, np.uint8)
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
        cols = [num if p is NUM else
                np.broadcast_to(np.frombuffer(p, np.uint8), (j - i, len(p)))
                for p in pieces]
        cols += [nl[i:j], chars[i:j], np.broadcast_to(mid, (j - i, 3)),
                 quals[i:j], nl[i:j]]
        out.append(np.concatenate(cols, axis=1).tobytes())
        i = j
    return b"".join(out)


def _record_bytes(first: int, n: int, pieces: tuple, read_len: int) -> int:
    """Bytes of n such records numbered from ``first``."""
    nums = sum(p is NUM for p in pieces)
    total = n * (sum(len(p) for p in pieces if p is not NUM)
                 + 2 * read_len + 5)
    d = 1
    while 10 ** (d - 1) < first + n:
        lo, hi = max(first, 10 ** (d - 1)), min(first + n, 10 ** d)
        total += nums * d * max(0, hi - lo)
        d += 1
    return total


def _write(ex, fd: int, off: int, first: int, pieces: tuple,
           chars: np.ndarray, quals: np.ndarray) -> list:
    """Submit the records of chars/quals (numbered from ``first``) to be
    written at ``off``, a task a ROWS rows; returns the futures."""
    def task(r0, at):
        buf = memoryview(_records(first + r0, pieces, chars[r0:r0 + ROWS],
                                  quals[r0:r0 + ROWS]))
        while len(buf):
            k = os.pwrite(fd, buf, at)
            buf, at = buf[k:], at + k

    futs = []
    L = chars.shape[1]
    for r0 in range(0, len(chars), ROWS):
        futs.append(ex.submit(task, r0, off))
        off += _record_bytes(first + r0, min(ROWS, len(chars) - r0),
                             pieces, L)
    return futs


def _open(path: str) -> int:
    return os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)


def make_pe(path1: str, path2: str, n_pairs: int, read_len: int = 100,
            genome_size: int = 2_000_000, err_rate: float = 0.01,
            insert_mean: float = 300.0, insert_sd: float = 30.0,
            seed: int = 42, qual_levels: int = 8, n_rate: float = 0.0,
            workers: int = 4) -> None:
    """The original make_pe's files (affine ids, fixed lengths): mate 1
    forward, mate 2 reverse-complemented from the far end of the same
    fragment, half the pairs flipped to the other strand."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_size, dtype=np.int8)
    insert = np.clip(rng.normal(insert_mean, insert_sd, size=n_pairs),
                     read_len + 10, genome_size - 1).astype(np.int64)
    starts = rng.integers(0, genome_size - insert.max() - 1, size=n_pairs)
    r1 = _gather(genome, starts, read_len)
    r2 = _gather(genome, starts + insert - read_len, read_len)
    del genome, starts, insert
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
    flip = rng.random(n_pairs) < 0.5
    r1f = r1.copy()
    r1[flip] = 3 - r2[flip][:, ::-1]
    r2[flip] = 3 - r1f[flip][:, ::-1]
    del r1f
    m1f = err_masks[0].copy()
    err_masks[0][flip] = err_masks[1][flip][:, ::-1]
    err_masks[1][flip] = m1f[flip][:, ::-1]
    del m1f
    fds = [_open(path1), _open(path2)]
    try:
        with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            futs = []
            for mate, (fd, reads, m) in enumerate(
                    zip(fds, (r1, r2), err_masks), 1):
                chars = ACGT[reads]
                quals = _quals(rng, ex, n_pairs, read_len, qual_levels,
                               m if qual_levels > 8 else None)
                _apply_n(rng, chars, quals, n_rate)
                pieces = (b"@SYN.", NUM, f"/{mate}".encode())
                futs += _write(ex, fd, 0, 1, pieces, chars, quals)
            for f in futs:
                f.result()
    finally:
        for fd in fds:
            os.close(fd)
