"""Compress rate: the reads of every compress started in the window over
the time from the window's start to the last one's end (host clock,
ending in a device synchronize)."""


def read(run):
    if not run.compresses or run.window_s <= 0:
        return None
    return len(run.compresses) * run.reads / run.window_s
