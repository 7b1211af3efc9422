"""Device memory the process holds to compress the input once:
torch.cuda.max_memory_reserved (graph pools included) over the window's
first compress, in GB. Each further compress in one process adds to
what the allocator holds (PERF.md), so a peak over the whole window
would follow the number of compresses that fit in it."""


def read(run):
    if run.peak_reserved_bytes is None:
        return None
    return run.peak_reserved_bytes / 1e9
