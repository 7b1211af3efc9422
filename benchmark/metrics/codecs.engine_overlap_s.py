"""Layer codecs: the thread-seconds of a compress's codec tasks that fall
inside its ``reorder_run`` stage span (utils/spans.py), the window's
mean: the codec work that shares the host's cores with the engine loop.
0.0 where none ran there."""
from harness import program_spans


def read(run):
    win = program_spans.window(run)
    if win is None:
        return None
    per = []
    for spans in win.values():
        st = program_spans.stage(spans, "reorder_run")
        lap = 0
        if st is not None:
            for s in program_spans.codec_tasks(spans):
                lap += max(0, min(s.end_ns, st.end_ns)
                           - max(s.start_ns, st.start_ns))
        per.append(lap / 1e9)
    return program_spans.mean(per)
