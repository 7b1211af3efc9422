"""The multi-segment consensus match: spring_tpu_torch's
align_leftovers_packed against spring_tpu's (JAX on CPU) on a consensus
past the single dictionary's 2^25 bases, so that both packages build one
dictionary a 2^24-base segment (three here) and min-fold the segments'
matches, as second chance and stitch do at 100M reads. (gpos, rc, placed)
must be equal, without ``exclude`` (second chance) and with it (stitch)."""
import numpy as np
import pytest

pytest.importorskip("jax")

from spring_tpu.encode import second_chance as jsc  # noqa: E402
from spring_tpu.io import packing  # noqa: E402
from spring_tpu_torch.encode import second_chance as tsc  # noqa: E402
from test_torch_second_chance import _packed_inputs  # noqa: E402

TOTAL = (1 << 25) + (1 << 20)      # three 2^24-base segments
N_READS, L = 20_000, 100


def _case():
    """Leftover reads of a random consensus with a 4,000-base stretch of
    segment 0 repeated in segment 2 (reads there verify in two segments:
    the fold keeps the lower position), reads across the segment
    boundaries, both orientations, 1-3 substitutions in a third of the
    reads, 30 over the threshold, N runs in 1 in 20, and shorter reads.
    Returns (consensus codes, read codes, lengths, true starts)."""
    rng = np.random.default_rng(29)
    seq = rng.integers(0, 4, TOTAL).astype(np.uint8)
    rep0, rep2 = 1_000_000, (2 << 24) + 500_000
    seq[rep2:rep2 + 4000] = seq[rep0:rep0 + 4000]
    pos = rng.integers(0, TOTAL - L, N_READS)
    edges = np.array([1 << 24, 1 << 25])
    pos[:200] = np.repeat(edges, 100) - rng.integers(1, L, 200)
    pos[200:400] = rep0 + rng.integers(0, 4000 - L, 200)
    codes = seq[pos[:, None] + np.arange(L)[None, :]].copy()
    lens = np.full(N_READS, L, np.int32)
    rows = np.arange(N_READS)
    sub = rows[rows % 3 == 1]
    for k in range(3):
        pick = sub[rng.random(len(sub)) < 0.6]
        col = rng.integers(0, L, len(pick))
        codes[pick, col] = (codes[pick, col] + rng.integers(
            1, 4, len(pick))) % 4
    far = rows[400:430]
    cols = rng.integers(0, L, (len(far), 40))
    codes[far[:, None], cols] = (codes[far[:, None], cols] + 1) % 4
    nrow = rows[rows % 20 == 7]
    start = rng.integers(0, L - 8, len(nrow))
    for j in range(6):
        codes[nrow, start + j] = packing.N
    short = rows[rows % 50 == 11]
    lens[short] = rng.integers(40, L, len(short))
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0)
    rc = rng.random(N_READS) < 0.5
    codes[rc] = packing.revcomp_codes(codes[rc], lens[rc])
    return seq, codes.astype(np.uint8), lens, pos


@pytest.mark.parametrize("stitch", [False, True])
def test_multi_segment_match_equal(stitch):
    seq, codes, lens, pos = _case()
    pk, nm_f, nm_r = _packed_inputs(codes, lens)
    kw = {}
    if stitch:
        # stitch's self-placement veto: a third of the reads may not take
        # their own start, the repeat's reads among them
        ex = np.where(np.arange(N_READS) % 3 == 0, pos, -1)
        ex[200:400] = pos[200:400]
        kw = dict(exclude=ex.astype(np.int32))
    want = jsc.align_leftovers_packed(seq, pk, nm_f, nm_r, lens, **kw)
    got = tsc.align_leftovers_packed(seq, pk, nm_f, nm_r, lens,
                                     device="cpu", **kw)
    name = "stitch_match" if stitch else "second_chance_match"
    assert tsc.SEGMENTS[name] == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    gpos, _rc, placed = want
    free = kw["exclude"] < 0 if stitch else np.ones(N_READS, bool)
    assert placed[free].mean() > 0.8
    # the fold's cases are there: placements in every segment, across
    # the boundaries, and the repeat's reads in segment 0 (or, vetoed
    # there, in segment 2)
    seg = gpos[placed] >> 24
    assert set(np.unique(seg)) == {0, 1, 2}
    assert placed[:200][free[:200]].mean() > 0.8
    rep = gpos[200:400][placed[200:400]]
    if stitch:
        assert (rep >= 2 << 24).sum() > 100
    else:
        assert (rep < 1 << 24).all()
