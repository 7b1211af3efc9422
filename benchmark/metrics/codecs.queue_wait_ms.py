"""Layer codecs: how long a codec task waits for a worker of the pool,
in ms: a compress's mean of start less submission over its ``codec``
spans (utils/spans.py), the window's mean."""
from harness import program_spans


def read(run):
    win = program_spans.window(run)
    if win is None:
        return None
    per = []
    for spans in win.values():
        waits = [(s.start_ns - s.attrs["submit_ns"]) / 1e6
                 for s in program_spans.codec_tasks(spans)]
        if waits:
            per.append(sum(waits) / len(waits))
    return program_spans.mean(per)
