"""Layer reorder: the share of reads that no contig took, in % (the
engine's counter ``unmatched_frac``), the window's mean."""


def read(run):
    got = run.engine("unmatched_frac")
    if not got:
        return None
    return 100 * sum(got) / len(got)
