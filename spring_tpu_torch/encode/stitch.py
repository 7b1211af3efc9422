"""Contig stitching: fold contigs whose consensus heads re-align inside
other contigs, so overlapping coverage pays for ONE consensus copy.

Copy of spring_tpu/encode/stitch.py whose head matching runs on the
port's second-chance matcher, on the caller's device.

The reference has no analog — its contigs fragment the same way (199,725
unmatched reads on SRR554369, logs/8_29_18/SRR554369.log:563) and every
fragment's head duplicates the tail of some other contig in the seq
stream. Here each contig's first <=96 consensus bases are matched against
the full concatenated consensus with the second-chance matcher (both
orientations, self-placement vetoed), and verified placements merge the
contigs through an orientation-aware union-find. Reads keep their
(pos, rc) up to the affine map pos' = o + pos (forward) or
pos' = o - pos - len (reverse-complement stitch); the merged consensus is
re-voted from the reads, so overlap regions gain votes and noise shrinks.

Losslessness is unaffected by a wrong merge (reads are always coded as
noise against whatever consensus wins the vote); a bad stitch only costs
ratio, and the Hamming verification over >=32 bases makes that rare.
"""
from __future__ import annotations

import numpy as np

from ..codecs import native
from ..io import packing
from . import consensus as cons
from . import second_chance as sc

HEAD_BASES = 96          # head window length (multiple of 16, <= 6 words)
STITCH_THRESH = 4        # max mismatches head-vs-consensus (reorder-grade)


def _compose(f2, o2, f1, o1):
    """Interval-map composition: m2(m1(p, l), l). Maps are
    m(p, l) = o + p (f=0) or o - p - l (f=1); lengths cancel."""
    return f1 ^ f2, o2 + o1 if f2 == 0 else o2 - o1


def _inverse(f, o):
    """Forward maps invert by negating o; rc maps are involutions."""
    return (f, o) if f else (0, -o)


class _AffineUF:
    """Union-find where each node carries the interval map to its parent."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.f = np.zeros(n, np.int8)
        self.o = np.zeros(n, np.int64)

    def find(self, i: int):
        """Returns (root, f, o) with map node->root; path-compresses."""
        path = []
        while self.parent[i] != i:
            path.append(i)
            i = int(self.parent[i])
        # walk back down: each node's map to root = (its map to parent)
        # composed under the accumulated parent-to-root map
        f, o = 0, 0
        for j in reversed(path):
            f, o = _compose(f, o, int(self.f[j]), int(self.o[j]))
            self.parent[j] = i
            self.f[j], self.o[j] = f, o
        return i, f, o

    def union(self, a: int, b: int, f_ab: int, o_ab: int) -> bool:
        """Link a's root under b's root given map a->b. Returns False on
        cycle (same root)."""
        ra, fa, oa = self.find(a)
        rb, fb, ob = self.find(b)
        if ra == rb:
            return False
        # map ra->rb = (b->rb) o (a->b) o inverse(a->ra)
        f, o = _inverse(fa, oa)
        f, o = _compose(f_ab, o_ab, f, o)
        f, o = _compose(fb, ob, f, o)
        self.parent[ra] = rb
        self.f[ra], self.o[ra] = f, o
        return True


def stitch_layout(layout: cons.ContigLayout, seq_codes: np.ndarray,
                  lengths: np.ndarray,
                  thresh: int = STITCH_THRESH, device="cuda"
                  ) -> tuple[cons.ContigLayout, int]:
    """Merge re-alignable contigs. Returns (new_layout, n_stitched);
    n_stitched == 0 returns the input layout unchanged. Head matching runs
    on ``device``."""
    if layout.cbase is None or len(layout.cbase) < 2:
        return layout, 0
    bases = layout.cbase
    clen = layout.clen
    counts = layout.ccount
    nc = len(bases)
    hl = np.minimum(clen, HEAD_BASES).astype(np.int32)
    ok_head = hl >= 32                       # matcher needs two 16-windows
    # head rows: consensus codes at each contig start, zero-padded
    idx = bases[:, None] + np.arange(HEAD_BASES)[None, :]
    valid = np.arange(HEAD_BASES)[None, :] < hl[:, None]
    heads = np.where(valid, seq_codes[np.minimum(
        idx, len(seq_codes) - 1)], 0).astype(np.uint8)
    pk = packing.pack_codes(heads)
    nm0 = np.zeros_like(pk)
    hpos, hrc, placed = sc.align_leftovers_packed(
        seq_codes, pk, nm0, nm0, np.where(ok_head, hl, 0),
        thresh=thresh, exclude=bases.astype(np.int32), device=device)
    placed &= ok_head
    if not placed.any():
        return layout, 0

    # owner contig of each placement = segment containing the match start.
    # The verified window must lie ENTIRELY inside the owner segment: a
    # window crossing a segment boundary was verified against the NEXT
    # (unrelated) contig's bases, and merging on it would contest the
    # owner's own votes (measured: such merges tripled the noise streams)
    owner = np.searchsorted(bases, hpos[placed], side="right") - 1
    srcs = np.nonzero(placed)[0]
    end_j = bases[owner] + clen[owner]
    fits = (hpos[placed] + hl[srcs]) <= end_j
    # boundary crossers: the matcher verified those windows partly against
    # the NEXT (unrelated) segment's bases. Re-verify the truncated part
    # that lies inside the owner on host; the affine map is unchanged
    # (the position relation holds on any sub-window)
    trunc = (end_j - hpos[placed]).astype(np.int64)
    retry = ~fits & (trunc >= 48)
    if retry.any():
        qs = hpos[placed][retry]
        hls = hl[srcs][retry].astype(np.int64)
        tr = trunc[retry]
        off = np.arange(HEAD_BASES)
        region = seq_codes[np.minimum(qs[:, None] + off[None, :],
                                      len(seq_codes) - 1)].astype(np.int64)
        hsel = heads[srcs[retry]].astype(np.int64)
        rcm = hrc[placed][retry] == 1
        # forward: head[k] vs region[k]; rc: revcomp(head)[k] = 3-head[hl-1-k]
        kidx = np.where(rcm[:, None], hls[:, None] - 1 - off[None, :],
                        off[None, :])
        hcmp = np.take_along_axis(hsel, np.clip(kidx, 0, HEAD_BASES - 1),
                                  axis=1)
        hcmp = np.where(rcm[:, None], 3 - hcmp, hcmp)
        mask = off[None, :] < np.minimum(tr, hls)[:, None]
        ham = ((hcmp != region) & mask).sum(axis=1)
        ok_r = ham <= thresh
        fit_retry = np.zeros(len(fits), bool)
        fit_retry[np.nonzero(retry)[0][ok_r]] = True
        fits |= fit_retry
    srcs, owner = srcs[fits], owner[fits]
    hp, hr = hpos[placed][fits], hrc[placed][fits]
    uf = _AffineUF(nc)
    n_stitched = 0
    for i, j, q, r in zip(srcs, owner, hp, hr):
        i, j = int(i), int(j)
        if i == j:
            continue
        # map contig-i local coords -> contig-j local coords
        if r == 0:
            f_ij, o_ij = 0, int(q) - int(bases[j])
        else:
            f_ij, o_ij = 1, int(q) + int(hl[i]) - int(bases[j])
        if uf.union(i, j, f_ij, o_ij):
            n_stitched += 1
    if n_stitched == 0:
        return layout, 0

    # resolve every contig's map to its root: vectorized pointer doubling
    # (composes each node's map with its parent's, halving path lengths)
    root = uf.parent.copy()
    fr = uf.f.astype(np.int64)
    orr = uf.o.copy()
    while (root[root] != root).any():
        f2, o2 = fr[root], orr[root]
        orr = np.where(f2 == 0, o2 + orr, o2 - orr)
        fr = fr ^ f2
        root = root[root]

    # rank groups by first-appearance order of their root contig
    # (nc-sized host work, cheap)
    uroot, first_of, inv = np.unique(root, return_index=True,
                                     return_inverse=True)
    order_groups = np.argsort(first_of, kind="stable")
    rank = np.empty(len(uroot), np.int32)
    rank[order_groups] = np.arange(len(uroot), dtype=np.int32)
    grank_c = rank[inv.astype(np.int32)]          # (nc,) rank per contig

    # fused native per-read transform (csrc/layout.cpp): merged-frame
    # pos_r (int32, overflow-guarded inside), rc, read length, group
    # rank, and the composite (grank, pos) sort key in ONE parallel
    # pass. The numpy chain this replaces allocated ~10 full-length
    # temporaries — ~6 GB of peak RSS at 100M reads and 5+ s at 10M on
    # this host's lazily-backed memory (PROFILE.md).
    import ctypes
    lib = native.load()
    n_r = len(layout.gpos)
    gpos64 = np.ascontiguousarray(layout.gpos, np.int64)
    counts64 = np.ascontiguousarray(counts, np.int64)
    bases64 = np.ascontiguousarray(bases, np.int64)
    rids32 = np.ascontiguousarray(layout.rids, np.int32)
    lens32 = np.ascontiguousarray(lengths, np.int32)
    fr8 = np.ascontiguousarray(fr, np.uint8)
    orr64 = np.ascontiguousarray(orr, np.int64)
    rc8 = np.ascontiguousarray(layout.rc, np.uint8)
    pos_r = np.empty(n_r, np.int32)
    rc_new = np.empty(n_r, np.uint8)
    rlen = np.empty(n_r, np.int32)
    grank = np.empty(n_r, np.int32)
    key = np.empty(n_r, np.int64)
    rcode = lib.stpu_stitch_transform(
        cons._i64p(counts64), ctypes.c_int64(nc), cons._i64p(gpos64),
        cons._i64p(bases64), cons._i32p(rids32), cons._i32p(lens32),
        cons._u8p(fr8), cons._i64p(orr64), cons._u8p(rc8),
        cons._i32p(np.ascontiguousarray(grank_c, np.int32)),
        ctypes.c_int64(n_r), ctypes.c_int32(0),
        cons._i32p(pos_r), cons._u8p(rc_new), cons._i32p(rlen),
        cons._i32p(grank), cons._i64p(key))
    if rcode != 0:
        raise OverflowError(
            "stitched contig-chain extent exceeds int32 coordinates "
            "(>2 Gbase chain); refusing to build a corrupt layout")

    # rebase each group to min 0, compute extents, rebuild concatenated
    # coords (group order = first-member contig order). Native two-pass
    # kernel over group segments (csrc stpu_stitch_relayout): the numpy
    # gather/reduceat chain it replaces paid 17.6 s at 100M reads on
    # this host's fresh-page memory.
    order = np.argsort(key)
    ng = len(uroot)
    gsize = np.zeros(ng, np.int64)     # per-group READ counts, from the
    np.add.at(gsize, grank_c, counts64)  # contig level (nc-sized)
    group_first = np.concatenate([[0], np.cumsum(gsize)])
    rid_out = np.empty(n_r, np.int32)
    gpos_out = np.empty(n_r, np.int64)
    rc_out = np.empty(n_r, np.uint8)
    gbase = np.empty(ng, np.int64)
    glen = np.empty(ng, np.int64)
    lib.stpu_stitch_relayout.restype = ctypes.c_int64
    seq_len = lib.stpu_stitch_relayout(
        cons._i64p(order), cons._i64p(group_first), ctypes.c_int64(ng),
        cons._i32p(rids32), cons._u8p(rc_new), cons._i32p(pos_r),
        cons._i32p(rlen), ctypes.c_int64(n_r), ctypes.c_int32(0),
        cons._i32p(rid_out), cons._i64p(gpos_out), cons._u8p(rc_out),
        cons._i64p(gbase), cons._i64p(glen))
    layout2 = cons.ContigLayout(
        rids=rid_out, gpos=gpos_out, rc=rc_out,
        seq_len=int(seq_len), cbase=gbase, clen=glen, ccount=gsize)
    return layout2, n_stitched
