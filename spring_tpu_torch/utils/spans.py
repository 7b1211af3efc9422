"""Spans of the port's compress, on the profiler's clock.

A span is ``Span(id, parent, compress, name, layer, thread, start_ns,
end_ns, attrs)``. Its times are ``time.time_ns()``, the clock of the
``start_ns()`` that torch.profiler gives its host ranges and, through
CUPTI, its device operations: a span lines up with a trace as it is.
``compress`` numbers the outer ``compress_short`` calls of the process
(0 outside one), and every span of one compress carries its number.
``parent`` is the id of the span that caused this one: the stage that
submitted a codec task, ``reorder_run`` for the engine's flushes, None
for a stage.

Each thread has a context, the compress it works for and the id of its
stage in progress: ``begin_compress`` sets it, ``close_stage`` records
that stage and opens the next, ``adopt`` hands a context to a thread
another one started, and ``record`` files a span under it. The newest
MAXLEN spans stay in memory (a compress makes a few hundred), appended
under a lock; ``spans()`` returns a copy of them, oldest first.
"""
from __future__ import annotations

import collections
import itertools
import threading

MAXLEN = 65536

Span = collections.namedtuple(
    "Span", "id parent compress name layer thread start_ns end_ns attrs")

_buf: collections.deque = collections.deque(maxlen=MAXLEN)
_lock = threading.Lock()
_ids = itertools.count(1)
_compresses = itertools.count(1)


class _Context(threading.local):
    compress = 0
    stage = None        # id of the calling thread's stage in progress


_ctx = _Context()


def spans() -> list:
    """A copy of the recorded spans, oldest first."""
    with _lock:
        return list(_buf)


def begin_compress() -> None:
    """A new compress on the calling thread, its first stage open."""
    with _lock:
        _ctx.compress = next(_compresses)
        _ctx.stage = next(_ids)


def context() -> tuple:
    """(compress, id of the stage in progress) of the calling thread."""
    return _ctx.compress, _ctx.stage


def adopt(ctx: tuple) -> None:
    """Make ``ctx`` (from ``context()``) the calling thread's."""
    _ctx.compress, _ctx.stage = ctx


def close_stage(name: str, layer: str, start_ns: int, end_ns: int,
                **attrs) -> None:
    """Record the calling thread's stage in progress as ``name`` and open
    the next one."""
    thread = threading.current_thread().name
    with _lock:
        _buf.append(Span(_ctx.stage, None, _ctx.compress, name, layer,
                         thread, start_ns, end_ns, attrs))
        _ctx.stage = next(_ids)


def record(name: str, layer: str, start_ns: int, end_ns: int,
           ctx: tuple | None = None, **attrs) -> None:
    """A span under ``ctx``'s stage in progress (by default the calling
    thread's)."""
    compress, parent = ctx if ctx is not None else context()
    thread = threading.current_thread().name
    with _lock:
        _buf.append(Span(next(_ids), parent, compress, name, layer, thread,
                         start_ns, end_ns, attrs))
