"""Archive size: bits of the window's archives, a compress's mean, over
the input's bases."""


def read(run):
    if not run.compresses:
        return None
    mean = sum(c["archive_bytes"] for c in run.compresses) / len(
        run.compresses)
    return mean * 8 / run.bases
