"""Second-chance alignment: place leftover reads against the consensus.

Port of spring_tpu/encode/second_chance.py. One sliding-window hash dict
is built on the device over every consensus 16-mer, and each oriented
leftover read probes it at its 16-aligned windows, verifying candidates
with an N-masked packed Hamming distance (an N lane forces a mismatch);
ambiguity resolves by a per-read min over (pos << 1 | rc). Reference
analog: the encoder's singleton re-alignment, Hamming <= THRESH_ENCODER
(src/encoder.h:242-351).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import params as P
from ..io import packing
from ..ops import bits
from ..reorder import dictionary as dct

_BIG = 2**31 - 1
CANDS = 8
_PAD = 16        # leading pad bases so window word -1 is addressable


def windows_for(max_len: int) -> tuple[int, ...]:
    """Read-local key windows, 16-base aligned, spread across the read so
    a read stays placeable unless every window carries an error."""
    ws = [0, 16]
    for st in (32, 48):
        if max_len >= st + 16:
            ws.append(st)
    return tuple(ws)


def _assemble_sc_rows(pk, nm_f, nm_r, lens):
    """(2*k2, 2W+1) oriented verify rows: forward rows then rc rows (packed
    revcomp), each followed by its N-mask plane and the length word."""
    rcpk = bits.revcomp_packed(pk, lens)
    lw = lens[:, None]
    fwd = torch.cat([pk, nm_f, lw], dim=1)
    rcr = torch.cat([rcpk, nm_r, lw], dim=1)
    return torch.cat([fwd, rcr], dim=0)


def _match_reads(seq_j, btab, rids, rows_j, total, W: int, thresh: int,
                 windows: tuple, exclude=None, rcbit=None):
    """Each oriented read probes the consensus dict at its windows and
    Hamming-verifies the candidate placements. Returns (nr,) per-row best
    = min(pos << 1 | rc), or _BIG when nothing verifies."""
    nr = rows_j.shape[0]
    dev = rows_j.device
    clen = rows_j[:, 2 * W]
    if rcbit is None:
        rcbit = (torch.arange(nr, dtype=torch.int32, device=dev)
                 >= nr // 2).to(torch.int32)
    best = torch.full((nr,), _BIG, dtype=torch.int32, device=dev)
    # consensus words fetched as k8 8-word rows + an offset gather: k8
    # covers offset 7 + W+1 words
    k8 = -(-(W + 8) // 8)
    s8 = seq_j.reshape(-1, 8)
    nrows8 = s8.shape[0]
    jj = torch.arange(W + 1, dtype=torch.int64, device=dev)
    for st in windows:
        key = rows_j[:, st // 16]            # windows are 16-aligned
        cand, hit = dct.probe_hash(btab, rids, key, CANDS)  # (nr, C) pos
        q = cand.to(torch.int32) - st        # candidate read start
        okc = (hit & (q >= 0) & ((q + clen[:, None]) <= total)
               & ((st + dct.KEY_BASES) <= clen)[:, None])
        if exclude is not None:
            okc &= q != exclude[:, None]     # self-placement veto
        wi = (q >> 4) + (_PAD // 16)
        r2 = 2 * (q & 15)
        b0 = (wi >> 3).clamp(0, nrows8 - k8).to(torch.int64)
        both = torch.cat([s8[b0 + i] for i in range(k8)], dim=-1)
        woff = (wi & 7).to(torch.int64)
        wrows = torch.gather(both, 2, (woff[..., None] + jj).expand(
            *woff.shape, W + 1))
        ham = torch.zeros(cand.shape, dtype=torch.int32, device=dev)
        for w in range(W):
            lo = wrows[..., w]
            hi = wrows[..., w + 1]
            fw = torch.where(r2 > 0, bits.srl_var(lo, r2) | (hi << (32 - r2)),
                             lo)
            dd = fw ^ rows_j[:, w][:, None]
            m = ((dd | bits.srl(dd, 1)) | rows_j[:, W + w][:, None]) \
                & bits.ODD_MASK
            mw = bits.prefix_word(clen[:, None] - 16 * w)
            ham += bits.popcount32(m & mw)
        okc &= ham <= thresh
        val = torch.where(okc, (q << 1) | rcbit[:, None], _BIG)
        best = torch.minimum(best, val.amin(dim=1))
    return best


def align_leftovers_packed(seq_codes: np.ndarray, pk: np.ndarray,
                           nm_f: np.ndarray, nm_r: np.ndarray,
                           lengths: np.ndarray,
                           thresh: int = P.THRESH_ENCODER,
                           exclude: np.ndarray | None = None,
                           device="cpu"
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Try to place each read on the consensus.

    pk: (n, W) packed 2-bit rows (N packed as A); nm_f/nm_r: packed N-mask
    planes, forward and length-reversed (NOverlay.nmask_planes). Returns
    (gpos, rc, placed) per input read; gpos is the start of the oriented
    read in seq coordinates, -1 if unplaced."""
    dev = torch.device(device)
    n = len(pk)
    out_pos = np.full(n, -1, np.int64)
    out_rc = np.zeros(n, np.uint8)
    total = len(seq_codes)
    if n == 0 or total < dct.KEY_BASES:
        return out_pos, out_rc, out_pos >= 0

    windows = windows_for(int(lengths.max()) if n else 32)
    W = pk.shape[1]
    # pow2-pad; forward half [0, k2), rc half [k2, 2*k2)
    k2 = max(1 << max(n - 1, 1).bit_length(), 64)

    def pad(a):
        out = np.zeros((k2, a.shape[1]), np.uint32)
        out[: len(a)] = a
        return torch.as_tensor(out.view(np.int32), device=dev)

    lens_p = np.zeros(k2, np.int32)
    lens_p[:n] = lengths
    rows_j = _assemble_sc_rows(pad(pk), pad(nm_f), pad(nm_r),
                               torch.as_tensor(lens_p, device=dev))

    # one whole-consensus dict up to 2^25 positions; beyond that, dicts
    # per 2^24-base segment with global positions, min-folded
    seg_bases = 1 << 24
    single_max = 1 << 25
    nseg = max(1, -(-total // seg_bases)) if total > single_max else 1

    seq_pk = packing.pack_codes(np.concatenate(
        [np.zeros(_PAD, np.uint8), seq_codes,
         np.zeros((W + 2) * 16, np.uint8)])[None, :])[0]
    need = max(len(seq_pk), _PAD // 16 + nseg * (seg_bases // 16) + 2)
    gran = max(1 << max(int(need - 1).bit_length() - 3, 6), 64)
    nw = -(-need // gran) * gran
    seq_p = np.zeros(nw, np.uint32)
    seq_p[: len(seq_pk)] = seq_pk
    seq_j = torch.as_tensor(seq_p.view(np.int32), device=dev)

    ex_j = None
    if exclude is not None:
        ex_p = np.full(k2, -2, np.int32)
        ex_p[:n] = exclude
        ex_j = torch.as_tensor(np.concatenate([ex_p, ex_p]), device=dev)
    rc_j = torch.cat([torch.zeros(k2, dtype=torch.int32, device=dev),
                      torch.ones(k2, dtype=torch.int32, device=dev)])
    # row chunks bound the candidate-row intermediates
    CH = min(2 * k2, 1 << 17)

    def match_fold(btab, pos_bins, best):
        for c0 in range(0, 2 * k2, CH):
            b = _match_reads(
                seq_j, btab, pos_bins, rows_j[c0:c0 + CH], total, W,
                thresh, windows,
                None if ex_j is None else ex_j[c0:c0 + CH],
                rc_j[c0:c0 + CH])
            np.minimum(best[c0:c0 + CH], b.cpu().numpy(),
                       out=best[c0:c0 + CH])
        return best

    best2 = np.full(2 * k2, _BIG, np.int32)
    if nseg == 1:
        npos = (nw - _PAD // 16) * 16
        S = max(dct.table_buckets(npos) // 2, 64)
        btab, _keys, pos_bins, _ = dct.build_hash_dict_seq_dev(
            seq_j, total, _PAD // 16, S)
        best2 = match_fold(btab, pos_bins, best2)
    else:
        S = dct.table_buckets(seg_bases)
        nw_seg = seg_bases // 16 + 2
        for k in range(nseg):
            btab, _keys, pos_bins, _ = dct.build_hash_dict_seq_seg(
                seq_j, total, k * seg_bases, _PAD // 16, nw_seg, S)
            best2 = match_fold(btab, pos_bins, best2)
    best = np.minimum(best2[:k2], best2[k2:])[:n]
    placed = best != _BIG
    out_pos[placed] = (best[placed] >> 1).astype(np.int64)
    out_rc[placed] = (best[placed] & 1).astype(np.uint8)
    return out_pos, out_rc, out_pos >= 0
