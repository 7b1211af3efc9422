"""Decompress rate: the reads of every archive that the window wrote
over the host clock around their decompresses, one at a time after the
window."""


def read(run):
    if not run.decompressed or run.decompress_s <= 0:
        return None
    return run.decompressed * run.reads / run.decompress_s
