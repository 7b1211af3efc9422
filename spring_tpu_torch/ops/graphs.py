"""CUDA graphs whose counted events count again at every replay, and the
process's cache of flush programs.

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
"""
from __future__ import annotations

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


class Graph:
    """``body()`` captured once into a CUDA graph on ``device``
    (torch.cuda.graph, default capture mode). What ``body`` returns are
    the graph's static outputs: every replay rewrites them. Graphs given
    one ``pool`` share their temporaries, and must then be replayed one
    after the other on one stream. A capture that fails raises."""

    def __init__(self, body, device, pool=None):
        global _tally
        self.graph = torch.cuda.CUDAGraph()
        tally = []
        _tally = tally
        try:
            with torch.cuda.device(device), \
                    torch.cuda.graph(self.graph, pool=pool):
                self.outputs = body()
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
