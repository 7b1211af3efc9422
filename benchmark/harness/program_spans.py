"""The program's own spans (spring_tpu_torch.utils.spans) in a traced
run's window.

The program stamps its spans with time.time_ns(), the clock of the
profiler's events, so a span belongs to the window where it lies inside
one of the trace's ``bench::compress`` ranges (microseconds): this
leaves out the warm-up compress, which ran before the profiler started.
"""
from __future__ import annotations


def window(run) -> dict | None:
    """{compress number: its spans} of the compresses of the traced
    window, or None where the run is untraced or the program records no
    spans."""
    tr = run.trace
    if tr is None or not tr.compresses:
        return None
    try:
        from spring_tpu_torch.utils import spans
    except ImportError:
        return None
    out: dict = {}
    for s in spans.spans():
        a, b = s.start_ns / 1e3, s.end_ns / 1e3
        if any(c0 <= a and b <= c1 for c0, c1 in tr.compresses):
            out.setdefault(s.compress, []).append(s)
    return out or None


def stage(spans: list, name: str):
    """The compress's stage span ``name`` (the first), or None."""
    return next((s for s in spans if s.parent is None and s.name == name),
                None)


def codec_tasks(spans: list) -> list:
    return [s for s in spans if s.name == "codec"]


def mean(values: list) -> float | None:
    return sum(values) / len(values) if values else None
