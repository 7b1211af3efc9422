"""CUDA graphs whose counted events count again at every replay.

The kernel wrappers count their launches (ops/kernels.py) and a
``multihost.World`` its collectives through ``count``. Outside a capture
that adds one at once. While ``Graph`` captures a body, the event goes to
the graph's tally instead, and each replay of the graph adds its tally:
a count stays what the card ran, however the work was issued.
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
