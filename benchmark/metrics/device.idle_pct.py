"""Layer device: the share of the traced window in which no device
operation ran, in %: 100 x (1 - the union of the profiler's kernel,
copy and set spans over the window's length)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.compresses or tr.window_s <= 0 or not tr.busy_s:
        return None
    return 100 * (1 - tr.busy_s / tr.window_s)
