"""The readers of the program's spans on a synthetic run: the warm-up
compress's spans left out, None where a run has nothing to read (the
CPU, an untraced run, a program without spans)."""
import sys

import pytest

from harness import spec
from harness.cell import Run
from harness.trace import Trace
from spring_tpu_torch.utils import spans as program

MS = 1_000_000          # ns
SPANS_READ = ("reorder.device_busy_pct", "codecs.busy_s",
              "codecs.queue_wait_ms", "codecs.engine_overlap_s")


def _read(name, run):
    return spec.reader(name).read(run)


def _span(sid, parent, compress, name, start_ms, end_ms, **attrs):
    return program.Span(sid, parent, compress, name, "x", "t",
                        start_ms * MS, end_ms * MS, attrs)


def _compress(c, t0, lap_ms, wait_ms=(1, 3)):
    """Spans of compress ``c`` from t0 ms: a reorder_run stage of 100 ms
    at t0 + 10, then codec tasks of 20 and 30 ms that start ``lap_ms``
    before it ends, queued ``wait_ms`` ms."""
    run_, end = 100 * c, t0 + 110
    out = [_span(run_ - 1, None, c, "dict_build", t0, t0 + 10),
           _span(run_, None, c, "reorder_run", t0 + 10, end),
           _span(run_ + 1, run_, c, "flush", t0 + 20, t0 + 60)]
    for i, (d, w) in enumerate(zip((20, 30), wait_ms)):
        s = end - lap_ms
        out.append(_span(run_ + 2 + i, run_, c, "codec", s, s + d,
                         family="quality", submit_ns=(s - w) * MS))
    return out


def _run(compresses, ranges_ms, ops_ms=()):
    run = Run(workload={}, config={}, traffic={}, reads=1, bases=1)
    run.trace = Trace(ops=[("k", s * 1000, e * 1000) for s, e in ops_ms],
                      compresses=[(a * 1000, b * 1000) for a, b in ranges_ms])
    got = [s for c in compresses for s in c]
    return run, got


@pytest.fixture
def two_compresses(monkeypatch):
    """A warm-up compress at 0 ms, before the traced window, and two in
    its ranges at 1000 and 2000 ms; device busy 50 of the first's and 25
    of the second's 100 ms of reorder_run."""
    run, got = _run([_compress(1, 0, 15), _compress(2, 1000, 15),
                     _compress(3, 2000, 5, wait_ms=(5, 7))],
                    [(990, 1200), (1990, 2200)],
                    ops_ms=[(1010, 1040), (1090, 1110), (1500, 1600),
                            (2050, 2075), (5, 100)])
    monkeypatch.setattr(program, "spans", lambda: got)
    return run


def test_readers_keep_the_window_and_average_a_compress(two_compresses):
    run = two_compresses
    # 50% then 25% (the ops outside both reorder_runs count nowhere)
    assert _read("reorder.device_busy_pct", run) == pytest.approx(37.5)
    assert _read("codecs.busy_s", run) == pytest.approx(0.05)
    assert _read("codecs.queue_wait_ms", run) == pytest.approx((2 + 6) / 2)
    # inside reorder_run: 15 ms of each task of the first, 5 of the second
    assert _read("codecs.engine_overlap_s", run) == pytest.approx(
        (0.015 + 0.015 + 0.005 + 0.005) / 2)


def test_overlap_reads_zero_where_no_codec_ran_in_the_engine(monkeypatch):
    run, got = _run([_compress(2, 1000, 0), _compress(3, 2000, -40)],
                    [(990, 1300), (1990, 2300)])
    monkeypatch.setattr(program, "spans", lambda: got)
    assert _read("codecs.engine_overlap_s", run) == 0.0
    assert _read("codecs.busy_s", run) == pytest.approx(0.05)


def test_span_readers_are_silent_without_a_window(two_compresses):
    run = two_compresses
    ops = run.trace.ops
    run.trace.ops = []                 # a CPU trace: no device operation
    assert _read("reorder.device_busy_pct", run) is None
    assert _read("codecs.busy_s", run) is not None
    run.trace.ops = ops
    run.trace.compresses = [(0, 1)]    # no span of the window
    assert all(_read(n, run) is None for n in SPANS_READ)
    run.trace = None                   # an untraced run
    assert all(_read(n, run) is None for n in SPANS_READ)


def test_span_readers_are_silent_where_the_program_has_no_spans(
        two_compresses, monkeypatch):
    import spring_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "spring_tpu_torch.utils.spans", None)
    assert all(_read(n, two_compresses) is None for n in SPANS_READ)

