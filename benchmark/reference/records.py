"""The benchmark's plain reference: what a SPRING archive must give back.

SPRING's guarantees are stated on records, so the reference of a
compress followed by a decompress is the input itself, held to the
configuration's guarantee:

- order, ids and qualities kept (the default flags): every file comes
  back byte for byte; the counts below say which records and fields
  differ where one does not;
- order not kept (``-r``): the multiset of records (of mate tuples when
  paired) comes back, over the fields that are kept: sequences always,
  qualities and ids where the flags keep them.

It also reads the archive's manifest (a tar member ``params.json``) with
the standard library and checks that the archive states the flags it was
asked for. numpy and the standard library only: it imports nothing of the
program and takes nothing the program derived; it reads the program's
outputs (the archive and the decompressed files) only to judge them.
"""
from __future__ import annotations

import json
import tarfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROWS = 1 << 16          # records a block of the comparison
THREADS = 8
FIELDS = {"id": 0, "seq": 1, "qual": 3}


class Fastq:
    """A FASTQ file's bytes and the start and end of each line."""

    def __init__(self, path: str):
        self.buf = np.fromfile(path, np.uint8)
        nl = np.flatnonzero(self.buf == 10)
        if len(self.buf) and (len(nl) == 0 or nl[-1] != len(self.buf) - 1):
            nl = np.append(nl, len(self.buf))     # no final newline
        self.n = len(nl) // 4                     # whole records only
        self.ends = nl[:4 * self.n]
        self.starts = np.concatenate([[0], nl[:4 * self.n - 1] + 1])
        self.width = int((self.ends - self.starts).max()) if self.n else 1
        # each line's bytes as a row of a view: a gather copies whole rows
        self._win = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([self.buf, np.zeros(self.width, np.uint8)]),
            self.width)

    def field(self, name: str, recs: np.ndarray):
        """(starts, lengths) of a field's lines for records ``recs``."""
        line = 4 * recs + FIELDS[name]
        s = self.starts[line]
        return s, self.ends[line] - s


def _rows(fq: Fastq, s: np.ndarray, ln: np.ndarray,
          width: int) -> np.ndarray:
    """(len(s), width) bytes of each line, zero past its end."""
    w = min(width, fq.width)
    rows = np.zeros((len(s), width), np.uint8)
    rows[:, :w] = fq._win[s, :w]
    short = ln < width
    if short.any():
        rows[short] *= np.arange(width)[None, :] < ln[short, None]
    return rows


def _key_rows(fq: Fastq, fields: tuple, recs: np.ndarray,
              width: int) -> np.ndarray:
    """Each record's kept fields, padded to ``width``, with their
    lengths: rows that are equal where the fields are."""
    parts = []
    for f in fields:
        s, ln = fq.field(f, recs)
        parts += [_rows(fq, s, ln, width),
                  ln.astype("<u4").view(np.uint8).reshape(-1, 4)]
    return np.concatenate(parts, axis=1)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser, element-wise (uint64 wraps)."""
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _hash_rows(rows: np.ndarray) -> np.ndarray:
    """(n, 2) uint64: two independent 64-bit hashes of each row."""
    pad = (-rows.shape[1]) % 8
    words = np.pad(rows, ((0, 0), (0, pad))).view("<u8")
    out = np.empty((len(rows), 2), np.uint64)
    for j, seed in enumerate((0x9E3779B97F4A7C15, 0xD1B54A32D192ED03)):
        h = np.full(len(rows), seed, np.uint64)
        for c in range(words.shape[1]):
            h = _mix(h ^ words[:, c])
        out[:, j] = h
    return out


def _width(files: list, fields: tuple) -> int:
    w = 1
    for fq in files:
        for f in fields:
            if fq.n:
                s, ln = fq.field(f, np.arange(fq.n))
                w = max(w, int(ln.max()))
    return w


def _blocks(fn, n: int) -> list:
    """fn(recs) for each block of ROWS records, in threads (numpy lets go
    of the interpreter lock in the gathers and arithmetic)."""
    with ThreadPoolExecutor(max_workers=THREADS) as ex:
        return list(ex.map(fn, (np.arange(r0, min(n, r0 + ROWS))
                                for r0 in range(0, n, ROWS))))


def _tuple_keys(mates: list, fields: tuple, n: int, width: int):
    """(n, 2) hashes of each record tuple (one record of each mate)."""
    def keys(recs):
        return _hash_rows(np.concatenate(
            [_key_rows(fq, fields, recs, width) for fq in mates], axis=1))

    parts = _blocks(keys, n)
    return np.concatenate(parts) if parts else np.empty((0, 2), np.uint64)


def _sorted_keys(keys: np.ndarray):
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    return keys[order], order


def multiset_missing(ins: list, outs: list, fields: tuple) -> tuple:
    """(missing, extra): record tuples of the input that the output lacks,
    and of the output that the input lacks, as multisets over
    ``fields``. Equal hashes are then checked row by row, so the answer
    is exact."""
    n_in = min(fq.n for fq in ins)
    n_out = min(fq.n for fq in outs) if outs else 0
    width = _width(ins + outs, fields)
    ka, oa = _sorted_keys(_tuple_keys(ins, fields, n_in, width))
    kb, ob = _sorted_keys(_tuple_keys(outs, fields, n_out, width))
    allk = np.concatenate([ka, kb])
    side = np.concatenate([np.zeros(len(ka), np.int8),
                           np.ones(len(kb), np.int8)])
    o = np.lexsort((side, allk[:, 1], allk[:, 0]))
    k = allk[o]
    new = np.ones(len(k), bool)
    new[1:] = (k[1:] != k[:-1]).any(axis=1)
    grp = np.cumsum(new) - 1
    cnt_a = np.bincount(grp, weights=(side[o] == 0), minlength=grp[-1] + 1
                        if len(grp) else 0)
    cnt_b = np.bincount(grp, weights=(side[o] == 1), minlength=grp[-1] + 1
                        if len(grp) else 0)
    matched = int(np.minimum(cnt_a, cnt_b).sum())
    missing, extra = n_in - matched, n_out - matched
    if missing == 0 and extra == 0 and n_in:
        # same multiset of hashes: compare the rows themselves in that
        # order (rows with equal hashes are equal, or this finds them)
        def differ(blk):
            a = np.concatenate([_key_rows(fq, fields, oa[blk], width)
                                for fq in ins], axis=1)
            b = np.concatenate([_key_rows(fq, fields, ob[blk], width)
                                for fq in outs], axis=1)
            return int((a != b).any(axis=1).sum())

        missing = extra = sum(_blocks(differ, n_in))
    return missing, extra


def ordered_wrong(fin: Fastq, fout: Fastq, field: str) -> int:
    """Records (of the first min(n_in, n_out)) whose ``field`` differs."""
    def differ(recs):
        sa, la = fin.field(field, recs)
        sb, lb = fout.field(field, recs)
        w = int(max(la.max(), lb.max(), 1))
        return int(((la != lb)
                    | (_rows(fin, sa, la, w) != _rows(fout, sb, lb, w))
                    .any(axis=1)).sum())

    return sum(_blocks(differ, min(fin.n, fout.n)))


def files_differ(a: str, b: str) -> int:
    x, y = np.fromfile(a, np.uint8), np.fromfile(b, np.uint8)
    return int(len(x) != len(y) or not np.array_equal(x, y))


def compare(inputs: list, outputs: list, guarantee: dict) -> dict:
    """The numbers that decide ``correct``, each of which must be 0, for
    decompressed ``outputs`` against ``inputs`` under ``guarantee``
    (``order``, ``ids`` and ``qualities``: true where the flags keep
    them)."""
    if len(outputs) != len(inputs):
        raise ValueError("one output file a mate")
    fields = ("seq",) + (("qual",) if guarantee["qualities"] else ()) \
        + (("id",) if guarantee["ids"] else ())
    whole = guarantee["order"] and guarantee["ids"] and guarantee["qualities"]
    names = (["records_missing", "records_extra"]
             + [f"{f}_wrong" for f in fields] + ["files_differ"])
    if whole and not sum(files_differ(a, b)
                         for a, b in zip(inputs, outputs)):
        # the whole guarantee is equal files, which have no record or
        # field that differs
        return dict.fromkeys(names, 0)
    ins = [Fastq(p) for p in inputs]
    outs = [Fastq(p) for p in outputs]
    if guarantee["order"]:
        res = {"records_missing": sum(max(0, a.n - b.n)
                                      for a, b in zip(ins, outs)),
               "records_extra": sum(max(0, b.n - a.n)
                                    for a, b in zip(ins, outs))}
        for f in fields:
            res[f"{f}_wrong"] = sum(ordered_wrong(a, b, f)
                                    for a, b in zip(ins, outs))
        if whole:
            res["files_differ"] = sum(files_differ(a, b)
                                      for a, b in zip(inputs, outputs))
        return res
    missing, extra = multiset_missing(ins, outs, fields)
    return {"records_missing": missing, "records_extra": extra}


def manifest_wrong(archive: str, expect: dict) -> int:
    """Entries of ``expect`` that the archive's params.json states
    otherwise (all of them if it has none)."""
    try:
        with tarfile.open(archive) as tar:
            params = json.load(tar.extractfile("params.json"))
    except (OSError, KeyError, tarfile.TarError, ValueError):
        return len(expect)
    return sum(params.get(k) != v for k, v in expect.items())
