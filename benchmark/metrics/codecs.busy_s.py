"""Layer codecs: the thread-seconds of a compress's codec tasks (the
program's ``codec`` spans, utils/spans.py: one a task of the codec pool,
from its start on a worker to its member written), the window's mean."""
from harness import program_spans


def read(run):
    win = program_spans.window(run)
    if win is None:
        return None
    return program_spans.mean([
        sum(s.end_ns - s.start_ns for s in program_spans.codec_tasks(sp))
        / 1e9 for sp in win.values()])
