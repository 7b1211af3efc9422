"""Layer encode: the share of each window compress's ``second_chance``
stage span (the program's own, utils/spans.py) in which a device
operation of the profiler's trace ran, in %, the window's mean: the
N-masked matcher's device use against the host work around it (the
leftover rows' assembly, the noise of the reads it placed)."""
from harness import program_spans
from harness.trace import busy_us


def read(run):
    win = program_spans.window(run)
    if win is None or not run.trace.ops:
        return None
    pct = []
    for spans in win.values():
        st = program_spans.stage(spans, "second_chance")
        if st is None or st.end_ns <= st.start_ns:
            continue
        lo, hi = st.start_ns / 1e3, st.end_ns / 1e3
        busy = busy_us((max(s, lo), min(e, hi)) for _, s, e in run.trace.ops
                       if e > lo and s < hi)
        pct.append(100 * busy / (hi - lo))
    return program_spans.mean(pct)
