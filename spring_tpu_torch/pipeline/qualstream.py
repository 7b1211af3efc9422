"""Copied from spring_tpu/pipeline/qualstream.py; the imports differ,
the environment-switched trace prints are gone, the shard path
(``drive_quality_shards``) is the port's own, and the bin path codes qvz
alone.

Quality-stream memory management for short mode.

Reference analog: the reference never holds all qualities in RAM — the
preprocess stage streams them block by block (src/preprocess.cpp:141-285)
and the reorder-compress stage re-reads the flat quality file once per
RAM bin of numreads/4 rows (src/reorder_compress_quality_id.cpp:64-68).
Quality memory stays bounded in every mode: raw rows spill to an
unlinked temp file (``QualSpool``) during parse, and are coded once the
output order is known.

Qualities whose transform works row by row (lossless, ill_bin, binary)
are coded one qv shard to a codec task (``drive_quality_shards``): each
task gathers its rows straight from the spool, mapped read-only after
the parse, applies the mode's table and codes them in one native call
that releases the GIL; the block's last shard to finish frames the
member. A block of S shards (qv.shard_plan: S up to 16 by the block's
chars, never by threads) so runs S-wide on the pool, and only the rows of
running shards are resident. QVZ trains its codebooks on each bin of
rows, so it keeps ``drive_quality_bins``: rows gathered per bin of ~n/8
output rows with ONE sequential spool scan each, per-block codec tasks
throttled so two bins at most are resident (the reference's n/4 budget).
A round-3 variant compressed order-preserving blocks DURING parse
instead; it was removed because the parser then ran throttled behind the
quality codec (~9 s of the 13 s 10M parse stage) while the host sat idle
during the device engine phase — the spool defers exactly that work into
the idle window.

Wire format is identical to the resident-matrix path: the same rows in
the same block layout reach the same codec.
"""
from __future__ import annotations

import mmap
import os
import tempfile
import threading

import numpy as np

from ..codecs import qv
from . import qvz


class _Throttle:
    """Bound in-flight codec tasks so staged block copies can't outrun
    the pool (an unbounded queue re-grows quality memory to O(n)).
    ``sink(name, fn, *args)`` is the pipeline's submit-and-write hook."""

    def __init__(self, window: int):
        self._sem = threading.Semaphore(window)

    def submit(self, sink, name, fn, *args):
        self._sem.acquire()

        def run(*a):
            try:
                return fn(*a)
            finally:
                self._sem.release()

        sink(name, run, *args)


class QualSpool:
    """Raw quality rows in an unlinked temp file, written sequentially
    during parse and gathered per bin, or mapped for the shard tasks,
    afterwards."""

    def __init__(self, n: int, ml: int, dir: str | None = None):
        self.n, self.ml = n, ml
        self._mm = None
        self.address = 0
        try:
            self._f = tempfile.TemporaryFile(dir=dir) if dir else \
                tempfile.TemporaryFile()
        except OSError:
            self._f = tempfile.TemporaryFile()

    def map(self) -> None:
        """Map the written rows read-only; ``address`` is their base
        until close(). Call once the parse has written every row.

        The shard tasks read rows one by one in output order, which under
        reorder is random over the spool: rows the page cache has dropped
        would fault in one at a time, so the kernel is asked to read the
        spool back ahead, in one sequential pass."""
        if self._mm is None:
            self._mm = mmap.mmap(self._f.fileno(), self.n * self.ml,
                                 access=mmap.ACCESS_READ)
            self._mm.madvise(mmap.MADV_WILLNEED)
            view = np.frombuffer(self._mm, np.uint8)
            self.address = view.ctypes.data
            del view        # no export left, so close() can unmap

    def write(self, r0: int, rows: np.ndarray) -> None:
        os.pwrite(self._f.fileno(), np.ascontiguousarray(rows),
                  r0 * self.ml)

    def gather(self, sel: np.ndarray) -> np.ndarray:
        """Rows at indices ``sel`` (any order) via one sequential scan;
        chunks holding no selected row are skipped entirely."""
        ml = self.ml
        out = np.empty((len(sel), ml), np.uint8)
        order = np.argsort(sel, kind="stable")
        ssort = np.asarray(sel)[order]
        chunk = max(1, (256 << 20) // max(ml, 1))
        fd = self._f.fileno()
        j = 0
        a = 0
        while a < self.n and j < len(ssort):
            a = (int(ssort[j]) // chunk) * chunk       # skip empty chunks
            b = min(a + chunk, self.n)
            k = j + int(np.searchsorted(ssort[j:], b, side="left"))
            idx = ssort[j:k]
            if len(idx):
                data = os.pread(fd, (b - a) * ml, a * ml)
                arr = np.frombuffer(data, np.uint8).reshape(-1, ml)
                out[order[j:k]] = arr[idx - a]
            j = k
            a = b
        return out

    def close(self) -> None:
        """Unmap and drop the rows; no shard task may be running."""
        if self._mm is not None:
            self.address = 0
            self._mm.close()
            self._mm = None
        self._f.close()


class _BlockShards:
    """The payloads of one block's shards; the last to arrive frames the
    block's member."""

    def __init__(self, shards: int):
        self._parts = [None] * shards
        self._left = shards
        self._lock = threading.Lock()

    def put(self, s: int, payload: bytes) -> bytes | None:
        with self._lock:
            self._parts[s] = payload
            self._left -= 1
            if self._left:
                return None
        return qv.frame_shards(self._parts)


def _code_shard(spool: QualSpool, block: _BlockShards, s: int,
                rows: np.ndarray, lens: np.ndarray,
                table: np.ndarray | None) -> bytes | None:
    """Shard ``s`` of ``block``: its member once every shard is coded,
    else None (the task writes nothing)."""
    return block.put(s, qv.compress_shard(spool.address, spool.n, spool.ml,
                                          rows, lens, table))


def drive_quality_shards(spool: QualSpool, sink,
                         block_sels: list[tuple[str, np.ndarray]],
                         lengths: np.ndarray,
                         table: np.ndarray | None) -> int:
    """Submit one codec task a qv shard of every output block (block_sels:
    (member name, global row indices)); each member comes out as
    ``qv.compress_rows`` of the block's rows through ``table``. ``sink(name,
    fn, *args, **span_attrs)`` writes what a task returns unless it is
    None. Returns the tasks submitted."""
    if not block_sels:
        return 0
    spool.map()
    tasks = 0
    for name, sel in block_sels:
        lens = lengths[sel]
        r0 = qv.shard_plan(lens)
        shards = len(r0) - 1
        block = _BlockShards(shards)
        for s in range(shards):
            a, b = int(r0[s]), int(r0[s + 1])
            sink(name, _code_shard, spool, block, s, sel[a:b], lens[a:b],
                 table, shard=s, shards=shards, rows=b - a,
                 chars=int(lens[a:b].sum(dtype=np.int64)))
        tasks += shards
    return tasks


def drive_quality_bins(spool: QualSpool, sink,
                       block_sels: list[tuple[str, np.ndarray]],
                       lengths: np.ndarray, qvz_ratio: float,
                       max_inflight: int,
                       bin_rows: int | None = None) -> None:
    """Gather, qvz-quantize and compress quality blocks in bins (reference
    bin strategy, src/reorder_compress_quality_id.cpp:64-68).

    block_sels: (member name, global row indices) per output block.
    Groups consecutive blocks into bins of >= bin_rows rows; each bin is
    ONE spool scan; per-block codec tasks are throttled so at most ~two
    bins are resident (bin_rows defaults to n/8 -> n/4 peak, the
    reference's budget). QVZ trains its codebooks per bin — statistically
    the same at >= millions of rows per bin, and identical on inputs that
    fit one bin.
    """
    if not block_sels:
        return
    if bin_rows is None:
        bin_rows = max(len(block_sels[0][1]), spool.n // 8)
    throttle = _Throttle(max_inflight)
    i = 0
    while i < len(block_sels):
        jn = i
        rows = 0
        while jn < len(block_sels) and (rows < bin_rows or jn == i):
            rows += len(block_sels[jn][1])
            jn += 1
        sel = np.concatenate([s for _, s in block_sels[i:jn]])
        lens = lengths[sel]
        mat = qvz.quantize_matrix(spool.gather(sel), lens, qvz_ratio)
        off = 0
        for name, s in block_sels[i:jn]:
            sl = slice(off, off + len(s))
            # quantizer output: fine position contexts
            throttle.submit(sink, name, qv.compress_rows,
                            mat[sl], lens[sl], 1, True)
            off += len(s)
        i = jn
