"""Second chance and stitch: spring_tpu_torch.encode against
spring_tpu.encode (JAX on CPU), on the inputs of tests/test_second_chance.py
and tests/test_stitch.py. (gpos, rc, placed) and stitched layouts must be
equal."""
import numpy as np
import pytest

pytest.importorskip("jax")

from spring_tpu.encode import consensus as cons  # noqa: E402
from spring_tpu.encode import second_chance as jsc  # noqa: E402
from spring_tpu.encode import stitch as jstitch  # noqa: E402
from spring_tpu.io import packing  # noqa: E402
from spring_tpu_torch.encode import second_chance as tsc  # noqa: E402
from spring_tpu_torch.encode import stitch as tstitch  # noqa: E402


def _packed_inputs(codes, lengths):
    """pk and forward/length-reversed N-mask planes, as
    spring_tpu.encode.second_chance.align_leftovers builds them."""
    pk = packing.pack_codes(codes)
    ind = (codes == packing.N).astype(np.uint8)
    nm_f = packing.pack_codes(ind)
    L = codes.shape[1]
    src = lengths[:, None].astype(np.int64) - 1 - np.arange(L)
    ind_r = np.where(src >= 0, np.take_along_axis(
        ind, np.clip(src, 0, L - 1), axis=1), 0).astype(np.uint8)
    return pk, nm_f, packing.pack_codes(ind_r)


def _case(name):
    """Leftover reads against a random consensus. "mixed" holds, in one
    call, exact and rc reads, errors inside the first two windows, reads
    over the threshold, N bases and variable lengths (each JAX call builds
    a 2^24-position dict, so cases share calls); "long" has 151-base reads
    (three 8-word consensus rows per candidate)."""
    rng = np.random.default_rng(0 if name == "mixed" else 1)
    total, n, L = (5000, 160, 100) if name == "mixed" else (3000, 64, 151)
    seq = rng.integers(0, 4, total).astype(np.uint8)
    pos = rng.integers(0, total - L, n)
    codes = seq[pos[:, None] + np.arange(L)[None, :]].copy()
    lens = np.full(n, L, np.int32)
    rc = rng.random(n) < 0.5
    codes[rc] = packing.revcomp_codes(codes[rc], lens[rc])
    if name == "mixed":
        g = np.arange(n) % 5
        codes[g == 1, 5] = (codes[g == 1, 5] + 1) % 4
        codes[g == 1, 20] = (codes[g == 1, 20] + 1) % 4
        bad = rng.choice(L, 40, replace=False)
        sel = np.nonzero(g == 2)[0][:, None]
        codes[sel, bad] = (codes[sel, bad] + 1) % 4
        codes[g == 3, 40:45] = packing.N
        codes[np.nonzero(g == 3)[0][::2], 50:80] = packing.N
        lens[g == 4] = rng.integers(20, L, int((g == 4).sum()))
        codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0)
    return seq, codes.astype(np.uint8), lens


@pytest.mark.parametrize("name", ["mixed", "long"])
def test_align_leftovers_packed_equal(name):
    seq, codes, lens = _case(name)
    pk, nm_f, nm_r = _packed_inputs(codes, lens)
    want = jsc.align_leftovers_packed(seq, pk, nm_f, nm_r, lens)
    got = tsc.align_leftovers_packed(seq, pk, nm_f, nm_r, lens,
                                     device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[2].sum() >= len(lens) // 2
    assert not want[2].all() or name == "long"


def test_align_leftovers_exclude_and_thresh():
    seq, codes, lens = _case("mixed")
    pk, nm_f, nm_r = _packed_inputs(codes, lens)
    ex = np.where(np.arange(len(lens)) % 2 == 0, 0, -1).astype(np.int32)
    want = jsc.align_leftovers_packed(seq, pk, nm_f, nm_r, lens, thresh=4,
                                      exclude=ex)
    got = tsc.align_leftovers_packed(seq, pk, nm_f, nm_r, lens, thresh=4,
                                     exclude=ex, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


L = 100


def _make_layout(genome, contig_specs, rng):
    """Contigs of reads every 20 bases over (window_start, window_len,
    orient) genome windows, as in tests/test_stitch.py."""
    read_mat, gpos, rc = [], [], []
    cbase, clen, ccount = [], [], []
    base = 0
    for w, wl, orient in contig_specs:
        starts = list(range(w, w + wl - L + 1, 20))
        ccount.append(len(starts))
        for s in starts:
            r_rc = int(rng.integers(0, 2))
            r = genome[s:s + L]
            read_mat.append(r if r_rc == 0 else (3 - r[::-1]).astype(np.uint8))
            if orient == 0:
                gpos.append(base + (s - w))
                rc.append(r_rc)
            else:
                gpos.append(base + (w + wl) - s - L)
                rc.append(1 - r_rc)
        cbase.append(base)
        clen.append(wl)
        base += wl
    n = len(read_mat)
    lay = cons.ContigLayout(
        rids=np.arange(n, dtype=np.int32),
        gpos=np.array(gpos, np.int64), rc=np.array(rc, np.uint8),
        seq_len=base, cbase=np.array(cbase, np.int64),
        clen=np.array(clen, np.int64), ccount=np.array(ccount, np.int64))
    return lay, packing.pack_codes(np.stack(read_mat)), np.full(n, L,
                                                                 np.int32)


@pytest.mark.parametrize("seed", [0, 9])
def test_stitch_layout_equal(seed):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    if seed == 9:   # boundary crossers (tests/test_stitch.py)
        specs = [(0, 140, 0), (600, 400, 0), (100, 400, 0)]
    else:
        specs = [(int(rng.integers(0, 2700)), 300, int(rng.integers(0, 2)))
                 for _ in range(25)]
    lay, packed, lengths = _make_layout(genome, specs, rng)
    seq = cons.build_consensus_packed(lay, packed, lengths)
    jlay, jn = jstitch.stitch_layout(lay, seq, lengths)
    tlay, tn = tstitch.stitch_layout(lay, seq, lengths, device="cpu")
    assert tn == jn
    if seed != 9:
        assert jn > 0
    for f in ("rids", "gpos", "rc", "cbase", "clen", "ccount"):
        np.testing.assert_array_equal(getattr(tlay, f), getattr(jlay, f),
                                      err_msg=f)
    assert tlay.seq_len == jlay.seq_len
