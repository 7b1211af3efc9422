"""CUDA graphs whose counted events count again at every replay, the
process's cache of flush programs, and loops of one shape run as a graph.

The kernel wrappers count their launches (ops/kernels.py) and a
``multihost.World`` its collectives through ``count``. Outside a capture
that adds one at once. While ``Graph`` captures a body, the event goes to
the graph's tally instead, and each replay of the graph adds its tally:
a count stays what the card ran, however the work was issued.

The program cache is the counterpart of the JAX package's module-level
``lru_cache`` on its flush programs plus jit's own cache: an engine keeps
its flush runner (reorder/engine.py::FlushRunner, its static buffers and,
on the card, its captured graphs) here under the key of every static
thing the runner's steps read, and the next engine of that key binds its
inputs into the same buffers and replays the same graphs. A slot (one a
device and rank) holds one program: a different key frees the old
program, its buffers and its graph pool, before the new one is built.

``ShapeLoop`` runs a loop that calls one function many times within one
call on arguments of one shape (second chance's matcher over its row
chunks) as one captured graph, replayed for every iteration after the
first. It lives only for that loop: nothing of it is cached.
"""
from __future__ import annotations

import time

import torch

_tally: list | None = None      # the events of the capture in progress


def count(obj, attr: str = "launches") -> None:
    """Add one to ``obj.attr``, or to the tally of the capture in
    progress."""
    if _tally is not None:
        _tally.append((obj, attr))
    else:
        setattr(obj, attr, getattr(obj, attr) + 1)


def capturing() -> bool:
    """Whether a ``Graph`` is capturing in this process."""
    return _tally is not None


def enabled(device) -> bool:
    """Whether flushes on ``device`` are captured into CUDA graphs (on a
    card; the CPU calls the steps)."""
    return torch.device(device).type == "cuda"


_capture_streams: dict = {}     # device -> the side stream captures use


class Graph:
    """``body()`` captured once into a CUDA graph on ``device``, on a side
    stream, in the global capture mode (as torch.cuda.graph captures, but
    without its device synchronize and its emptying of the device and
    pinned-host allocator caches: a caller that wants them makes them).
    What ``body`` returns are the graph's static outputs: every replay
    rewrites them. Graphs given one ``pool`` share their temporaries, and
    must then be replayed one after the other on one stream. A capture
    that fails raises."""

    def __init__(self, body, device, pool=None):
        global _tally
        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stream = _capture_streams.get(dev)
        if stream is None:
            stream = _capture_streams[dev] = torch.cuda.Stream(dev)
        self.graph = torch.cuda.CUDAGraph()
        tally = []
        _tally = tally
        try:
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                self.graph.capture_begin(*(() if pool is None else (pool,)))
                try:
                    self.outputs = body()
                finally:
                    self.graph.capture_end()
        finally:
            _tally = None
        self.tally = tally
        self.replays = 0

    @property
    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()
        for obj, attr in self.tally:
            setattr(obj, attr, getattr(obj, attr) + 1)
        self.replays += 1

    def recount(self, old, new) -> None:
        """Counts this graph adds to ``old`` go to ``new`` from now on."""
        self.tally = [(new if o is old else o, a) for o, a in self.tally]

    def reset(self) -> None:
        """Free the graph and its outputs."""
        self.graph.reset()
        self.outputs = None


# ---------------- the program cache ----------------

_programs: dict = {}    # slot (device, rank) -> (key, program)


def _slot(device, rank: int) -> tuple:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev, rank


def cached_program(device, rank: int, key: tuple):
    """The program cached for ``key`` on this device and rank, or None.
    On a miss the slot's old program, if any, is freed first, so that a
    new build does not sit beside it."""
    slot = _slot(device, rank)
    entry = _programs.get(slot)
    if entry is not None and entry[0] == key:
        return entry[1]
    _free(slot)
    return None


def cache_program(device, rank: int, key: tuple, program) -> None:
    """Keep ``program`` (it has ``free()`` and ``nbytes()``) for ``key``
    in the slot of this device and rank, in place of what was there."""
    slot = _slot(device, rank)
    _free(slot)
    _programs[slot] = (key, program)


def cached_program_bytes(device) -> int:
    """The bytes the cached programs on ``device`` hold: buffers and
    graph pools."""
    dev = _slot(device, 0)[0]
    return sum(p.nbytes() for (d, _), (_, p) in _programs.items()
               if d == dev)


def clear_program_cache() -> None:
    """Free every cached flush program: its buffers, graphs and graph
    pool. The next engine of any shape builds (and on a card captures)
    its program anew. An API user calls this to give the card's memory
    back between compress calls; ``multihost.shutdown`` calls it, since a
    distributed program's graphs hold the group's collectives."""
    for slot in list(_programs):
        _free(slot)


def _free(slot: tuple) -> None:
    entry = _programs.pop(slot, None)
    if entry is None:
        return
    entry[1].free()
    dev = slot[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


# ---------------- loops of one shape ----------------

# per loop name, since the last clear (compress_short clears it): loops
# run, their iterations, the loops captured, the iterations replayed, the
# capture seconds and the largest graph pool's bytes
LOOP_STATS: dict = {}


class ShapeLoop:
    """``fn(*var)`` for a loop that calls it ``n`` times, each time on
    tensors ``var`` of one shape and dtype: the counterpart of a jitted
    JAX function that one loop calls again and again. On a card, with
    n > 1, the first iteration calls ``fn`` (its kernels load) and then
    captures it over copies of that iteration's ``var``; each later
    iteration copies its ``var`` into them and replays, and gets the
    graph's static outputs, which the next iteration rewrites. The
    tensors ``fn`` closes over are read in place: they must stay alive
    and unchanged until ``close()``. One iteration, or the CPU, calls
    ``fn`` every time: a graph replayed no time would only add its
    capture. A capture that fails raises."""

    def __init__(self, name: str, fn, n: int, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graphed = enabled(self.device) and n > 1
        self._graph = None
        self._var = ()
        self.stats = LOOP_STATS.setdefault(name, dict(
            loops=0, iterations=0, captures=0, replays=0, capture_s=0.0,
            pool_bytes=0))
        self.stats["loops"] += 1

    def __call__(self, *var: torch.Tensor):
        st = self.stats
        st["iterations"] += 1
        if not self.graphed:
            return self.fn(*var)
        if self._graph is None:
            out = self.fn(*var)
            self._capture(var)
            return out
        for buf, v in zip(self._var, var):
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(f"loop of one shape: an argument of "
                                 f"{v.dtype}{tuple(v.shape)} for a buffer "
                                 f"of {buf.dtype}{tuple(buf.shape)}")
            buf.copy_(v)
        self._graph.replay()
        st["replays"] += 1
        return self._graph.outputs

    def _capture(self, var: tuple) -> None:
        """Capture ``fn`` over copies of ``var``; capture_s is its host
        time, instantiation included, and pool_bytes what the device's
        reserved memory grew by (the graph's private pool takes new
        segments; the allocator's cache is left as it is, for the stages
        after this one)."""
        dev = self.device
        cuda = dev.type == "cuda"
        self._var = tuple(v.clone() for v in var)
        reserved = torch.cuda.memory_reserved(dev) if cuda else 0
        t = time.perf_counter()
        with torch.profiler.record_function("stpu::capture"):
            self._graph = Graph(lambda: self.fn(*self._var), dev)
        if cuda:
            torch.cuda.synchronize(dev)
        st = self.stats
        st["captures"] += 1
        st["capture_s"] += time.perf_counter() - t
        if cuda:
            st["pool_bytes"] = max(st["pool_bytes"],
                                   torch.cuda.memory_reserved(dev) - reserved)

    def close(self) -> None:
        """Free the graph, its pool and the buffers."""
        if self._graph is not None:
            self._graph.reset()
            self._graph = None
        self._var = ()
