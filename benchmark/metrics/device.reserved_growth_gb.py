"""Layer device: what each compress after the window's first adds to
the device memory that the process holds, in GB a compress:
torch.cuda.memory_reserved after the last compress less after the
first, over the compresses between them. A user who compresses many
files in one process holds ``peak_device_gb`` and this much more for
each further file. None where the window ran fewer than two."""


def read(run):
    got = [c["reserved"] for c in run.compresses]
    if len(got) < 2 or None in got:
        return None
    return (got[-1] - got[0]) / (len(got) - 1) / 1e9
