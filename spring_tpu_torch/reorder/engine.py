"""Batched read-reordering engine on one device (PyTorch).

Port of spring_tpu/reorder/engine.py. B contig walkers advance in
lock-step rounds: each round a walker probes SC shifts x 2 dictionaries x
{forward, reverse-complement} of its consensus, verifies the candidate
reads with the masked-Hamming kernel (ops/kernels.py), accepts every
verified read (first walker wins a contested read), updates its packed
u8x4 consensus counts, and emits (rid, delta|flag|rc) slots. Reference
analog: the greedy consensus-following walk of src/reorder.h:432-616.

The round and the flush (FLUSH_ROUNDS rounds, then a per-walker
compaction of the emissions) are plain functions over tensors on the
engine's device; the JAX program's lax.scan is a Python loop. Packed
words are int32 bit patterns (ops/bits.py). Every stage is integer-only
and deterministic, so emissions equal the JAX engine's exactly.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import params as P
from ..ops import bits, kernels
from . import dictionary as dct

FLUSH_ROUNDS = 32      # rounds between host syncs
CAP_PER_ROUND = 3      # emission-buffer slots per walker per round (SC=16)
_BIG = 2**31 - 1

# stats of the most recent run(): rounds, flush wall, emitted rows
LAST_RUN_STATS: dict = {}


def padded_n(n: int) -> int:
    """Engine read-count padding: pow2 up to 2^26 reads, then 1/8-octave
    granules. Always a multiple of 64 (bitmap words, pairs rows)."""
    np_pow2 = max(1 << max(n - 1, 1).bit_length(), 64)
    if n <= (1 << 26):
        return np_pow2
    gran = 1 << (max(n - 1, 1).bit_length() - 3)
    return min(-(-n // gran) * gran, np_pow2)


@dataclass
class ReorderConfig:
    max_readlen: int
    num_walkers: int = P.REORDER_BATCH
    candidates: int = P.DICT_PROBE_CANDIDATES
    thresh: int = P.THRESH_REORDER
    max_shift: int = 0   # 0 -> min(max_readlen // 2, MAX_SHIFT_CAP)
    shift_chunk: int = 16    # shifts probed per round
    accept_slots: int = 16   # accepted-candidate slots per walker per round

    def __post_init__(self):
        if self.max_shift == 0:
            self.max_shift = max(min(self.max_readlen // 2,
                                     P.MAX_SHIFT_CAP), 1)


# --------------- packed consensus counts ---------------
#
# Per-position base counts are four u8 lanes of one 32-bit word
# (c0 | c1<<8 | c2<<16 | c3<<24), saturating at 127.

def _counts_argmax_packed(c8: torch.Tensor) -> torch.Tensor:
    """(…, Lb) packed lanes -> argmax lane index (first max wins)."""
    c0 = c8 & 0xFF
    c1 = (c8 >> 8) & 0xFF
    c2 = (c8 >> 16) & 0xFF
    c3 = bits.srl(c8, 24)
    m = torch.maximum(torch.maximum(c0, c1), torch.maximum(c2, c3))
    return torch.where(c0 == m, 0, torch.where(
        c1 == m, 1, torch.where(c2 == m, 2, 3))).to(torch.int32)


def _shift_last_static(x: torch.Tensor, s: int) -> torch.Tensor:
    """x[..., p] = x[..., p + s], zero fill (static s)."""
    if s == 0:
        return x
    return torch.cat([x[..., s:], x.new_zeros((*x.shape[:-1], s))], dim=-1)


def _roll_words(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-row left roll of (…, Lb) along positions by t = 8q + r via two
    static select chains (q past Lb // 8 leaves the row unrolled)."""
    Lb = x.shape[-1]
    q, r = (t // 8)[..., None], (t % 8)[..., None]
    out = x
    for qq in range(1, Lb // 8 + 1):
        out = torch.where(q == qq, _shift_last_static(x, 8 * qq), out)
    base = out
    for rr in range(1, 8):
        out = torch.where(r == rr, _shift_last_static(base, rr), out)
    return out


def _lane_inc(codes: torch.Tensor, rlen: torch.Tensor) -> torch.Tensor:
    """(…, Lb) codes -> packed one-hot lane increments masked by rlen."""
    Lb = codes.shape[-1]
    valid = torch.arange(Lb, device=codes.device) < rlen[..., None]
    return torch.where(valid, 1 << (8 * codes), 0).to(torch.int32)


def _sat_add(c8: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """Lane-wise saturating add (lane sums stay below 256: counts <= 127
    and a round adds <= M <= 16 per lane)."""
    sm = bits.u32(c8) + inc.to(torch.int64)
    ov = (sm >> 7) & 0x01010101
    return bits.i32((sm & ~(ov * 0xFF)) | (ov * 0x7F))


def walker_frames_packed(c8: torch.Tensor, ref_len: torch.Tensor,
                         shift_base: torch.Tensor, sc: int):
    """Consensus comparison frames from packed lane counts (B, Lb).

    Returns (frames, s_tot): frames (B, sc, 2, W) packed consensus windows
    — orientation axis {forward shifted left by s, revcomp shifted right
    by s}; s_tot (B, sc) absolute shift of each probe."""
    Lb = c8.shape[-1]
    dev = c8.device
    refc = _counts_argmax_packed(c8)
    refc = torch.where(torch.arange(Lb, device=dev) < ref_len[:, None],
                       refc, 0)
    ref_pk = bits.pack(refc)
    rev_pk = bits.revcomp_packed(ref_pk, ref_len)
    base_ref = bits.shift_bases_left(ref_pk, shift_base, Lb)
    base_rev = bits.shift_bases_right(rev_pk, shift_base, Lb)
    ref_i = [bits.shift_bases_left_static(base_ref, i) for i in range(sc)]
    rev_i = [bits.shift_bases_right_static(base_rev, i) for i in range(sc)]
    frames = torch.stack([torch.stack(ref_i, dim=1),
                          torch.stack(rev_i, dim=1)], dim=2)
    s_tot = shift_base[:, None] + torch.arange(sc, dtype=torch.int32,
                                               device=dev)
    return frames, s_tot


def walker_queries(frames, s_tot, ref_len, starts):
    """Dictionary queries from the packed frames: (q, v) of (B, SC, D, 2)."""
    qs, vs = [], []
    for st in starts:
        k = bits.extract_key_packed(frames, st)      # (B, SC, 2)
        v_fwd = (s_tot + st + dct.KEY_BASES) <= ref_len[:, None]
        v_rev = (s_tot <= st) & ((st + dct.KEY_BASES - s_tot)
                                 <= ref_len[:, None])
        qs.append(k)
        vs.append(torch.stack([v_fwd, v_rev], dim=2))
    return torch.stack(qs, dim=2), torch.stack(vs, dim=2)


def _lex2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 key ordering int32 pairs (a, b) lexicographically."""
    return (a.to(torch.int64) << 32) + (b.to(torch.int64) + 2**31)


def resolve_conflicts(matched: torch.Tensor,
                      rid_sel: torch.Tensor) -> torch.Tensor:
    """First claimant (lowest index) wins each rid; the others lose."""
    key = torch.where(matched, rid_sel, _BIG)
    ks, order = torch.sort(key, stable=True)   # ties keep index order
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=key.device),
                       ks[1:] != ks[:-1]])
    win = torch.empty_like(matched)
    win[order] = first & (ks != _BIG)
    return win


def _assemble_rows(full: torch.Tensor, sel: torch.Tensor,
                   lengths_p: torch.Tensor) -> torch.Tensor:
    """Gather full[sel] and append the length word (claimed bit 31 set
    where sel < 0, i.e. padding rows)."""
    rows = full[sel.clamp(0, full.shape[0] - 1)]
    lw = torch.where(sel >= 0, lengths_p, lengths_p | -2**31)
    return torch.cat([rows, lw[:, None]], dim=1)


def _flush_program(Np: int, C: int, SC: int, accept_slots: int,
                   starts: tuple, thresh: int):
    """Build (round_fn, flush_fn, emit_cap) for one shape signature."""
    D = len(starts)
    # static probe-group list in priority order: shift > orientation >
    # dict (the reference search order, src/reorder.h:479-557)
    groups = [(s, o, d) for s in range(SC) for o in range(2)
              for d in range(D)]
    G = len(groups)
    g_srel_c = np.array([s for s, o, d in groups], np.int32)
    g_o_c = np.array([o for s, o, d in groups], np.int32)
    g_d_c = np.array([d for s, o, d in groups], np.int32)
    # flat index of group (s, o, d) in the (B, SC, D, 2) query tensor
    g_flat_c = np.array([(s * D + d) * 2 + o for s, o, d in groups],
                        np.int64)
    GSEL = max(1, min(accept_slots, G * C) // C)
    M = GSEL * C
    nwords = Np // 32 + 2
    S = M + 1
    CAP = FLUSH_ROUNDS * max(CAP_PER_ROUND, CAP_PER_ROUND * SC // 16) + S
    consts = {}

    def const(dev):
        if dev not in consts:
            t = {k: torch.as_tensor(v, device=dev) for k, v in (
                ("srel", g_srel_c), ("o", g_o_c), ("d", g_d_c),
                ("flat", g_flat_c))}
            t["negg"] = -torch.arange(G, dtype=torch.int32, device=dev)
            t["co"] = torch.arange(C, dtype=torch.int32, device=dev)
            consts[dev] = t
        return consts[dev]

    def claimed_bit(claimed, idx):
        return ((claimed[idx >> 5] >> (idx & 31)) & 1) == 1

    def claim(claimed, cond, idx):
        # bits claimed in one round are distinct, so the add is an OR (and
        # integer atomic adds are deterministic); the last word is the sink
        word = torch.where(cond, idx >> 5, nwords - 1)
        bit = torch.where(cond, 1 << (idx & 31), 0).to(torch.int32)
        return claimed.index_add(0, word, bit)

    def round_fn(state, lengths, dkeys, pairs_all, seed_order, n_real,
                 maxshift, rows_tab, room=None):
        counts = state["counts"]
        ref_len = state["ref_len"]
        active = state["active"]
        shift_base = state["shift_base"]
        claimed = state["claimed"]
        packed = rows_tab
        dev = counts.device
        k = const(dev)
        if room is None:
            room = torch.ones_like(active)
        # a walker whose flush emission buffer is nearly full stalls
        searching = active & room
        B, Lb = counts.shape
        Wl = packed.shape[1] - 1
        lp0 = state["left_phase"]

        frames, s_tot = walker_frames_packed(counts, ref_len, shift_base, SC)
        q, v = walker_queries(frames, s_tot, ref_len, starts)

        # ---- metadata-only probe of every static group (one gather) ----
        Sdict = dkeys.shape[0] // D
        q_g = q.reshape(B, SC * D * 2)[:, k["flat"]]
        v_g = v.reshape(B, SC * D * 2)[:, k["flat"]]
        st_g, ct_g = dct.probe_meta_groups(dkeys, Sdict, q_g, g_d_c)
        ct_g = torch.where(v_g, ct_g, 0)
        hit_g = (ct_g > 0) & searching[:, None]

        # ---- the GSEL best-priority hitting groups fetch candidates ----
        negp = torch.where(hit_g, k["negg"][None, :], -_BIG)
        negg = torch.topk(negp, GSEL, dim=1).values
        gok = negg != -_BIG
        g_id = torch.where(gok, -negg, 0).to(torch.int64)
        st_sel = torch.gather(st_g, 1, g_id)
        ct_sel = torch.where(gok, torch.gather(ct_g, 1, g_id), 0)
        d_sel = k["d"][g_id]
        o_sel = k["o"][g_id]
        srel = k["srel"][g_id]
        nprow = Np // 8
        rowid = d_sel * nprow + (st_sel >> 3)
        both = pairs_all[rowid.clamp(0, D * nprow - 1)]    # (B, GSEL, 16)
        off = (st_sel & 7).to(torch.int64)
        candg = torch.gather(both, 2, off[:, :, None]
                             + k["co"].to(torch.int64)[None, None, :])
        vcand = ((k["co"][None, None, :] < ct_sel.clamp(max=C)[:, :, None])
                 & gok[:, :, None])
        cand_m = candg.reshape(B, M)
        valid_m = (vcand & (candg >= 0)).reshape(B, M)
        k_o_m = o_sel[:, :, None].expand(B, GSEL, C).reshape(B, M)
        k_frame_m = (srel * 2 + o_sel)[:, :, None].expand(
            B, GSEL, C).reshape(B, M)
        s_m = shift_base[:, None] + srel[:, :, None].expand(
            B, GSEL, C).reshape(B, M)
        pr_m = (g_id.to(torch.int32)[:, :, None] * C
                + k["co"][None, None, :]).reshape(B, M)

        # ---- verify: one (B, M) row gather + the masked-Hamming kernel --
        safe = cand_m.clamp(0, Np - 1)
        rows = packed[safe]                           # (B, M, W+1)
        claimed_row = claimed_bit(claimed, safe)
        clen = rows[..., Wl] & 0x7FFFFFFF
        rl = ref_len[:, None]
        fwd = k_o_m == 0
        lo = torch.where(fwd, 0, s_m)
        hi = torch.where(fwd, torch.minimum(rl - s_m, clen),
                         torch.minimum(rl + s_m, clen))
        t = torch.where(fwd, s_m, rl + s_m - clen)
        frow = torch.gather(frames.reshape(B, 2 * SC, -1), 1,
                            k_frame_m.to(torch.int64)[:, :, None].expand(
                                B, M, Wl))
        ham = kernels.masked_hamming_rows(frow, rows, lo, hi)
        ok = valid_m & ~claimed_row & (ham <= thresh) & (t >= 0) & (hi > lo)

        # ---- batch accept: dedup rids within the walker (sort by
        # (rid, priority)), then order the accepts by (t, rid) ----
        rid_eff = torch.where(ok, cand_m, _BIG)
        _, p1 = torch.sort(_lex2(rid_eff, pr_m), dim=1, stable=True)
        rid_s = torch.gather(rid_eff, 1, p1)
        t_s = torch.gather(t, 1, p1)
        firsts = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                            rid_s[:, 1:] != rid_s[:, :-1]], dim=1)
        keep_s = (rid_s != _BIG) & firsts
        tkey = torch.where(keep_s, t_s, _BIG)
        _, p2 = torch.sort(_lex2(tkey, rid_s), dim=1, stable=True)
        slot_f = torch.gather(p1, 1, p2)              # original slot
        keep_f = torch.gather(keep_s, 1, p2)
        rid_f = torch.gather(rid_s, 1, p2)
        t_f = torch.gather(t_s, 1, p2)
        ko_f = torch.gather(k_o_m, 1, slot_f)
        clen_f = torch.gather(clen, 1, slot_f)
        rows_f = torch.gather(rows, 1, slot_f[:, :, None].expand(
            B, M, Wl + 1))

        # ---- cross-walker conflicts: first walker per rid wins ----
        win = resolve_conflicts(keep_f.reshape(-1),
                                rid_f.reshape(-1)).reshape(B, M)
        matched_any = win.any(dim=1)
        t_roll = torch.where(win, t_f, 0).amax(dim=1)

        # ---- batched consensus update (updaterefcount semantics,
        # src/reorder.h:110-220): roll to the last accepted read's start,
        # add each accepted read's one-hot at its relative offset ----
        left_phase = lp0
        first_rid = state["first_rid"]
        live = torch.arange(Lb, device=dev)[None, :] < ref_len[:, None]
        rolled0 = _roll_words(torch.where(live, counts, 0), t_roll)
        len0 = (ref_len - t_roll).clamp(min=0)
        pk_all = rows_f[..., :Wl]                     # (B, M, W)
        pk_all = torch.where((ko_f == 1)[:, :, None],
                             bits.revcomp_packed(pk_all, clen_f), pk_all)
        d_all = torch.where(win, t_roll[:, None] - t_f, 0)
        pk_all = bits.shift_bases_left(pk_all, d_all, Lb)
        codes_all = bits.unpack(pk_all, Lb)           # (B, M, Lb)
        len_all = torch.where(win, clen_f - d_all, 0)
        inc = _lane_inc(codes_all, len_all).sum(dim=1)
        rolled = _sat_add(rolled0, inc)
        new_len = torch.maximum(len0, len_all.amax(dim=1))
        counts = torch.where(matched_any[:, None], rolled, counts)
        ref_len = torch.where(matched_any, new_len, ref_len)
        claimed = claim(claimed, win.reshape(-1),
                        rid_f.clamp(0, Np - 1).reshape(-1))
        shift_base = torch.where(matched_any, 0, shift_base)

        # walkers that found nothing advance their shift window; an
        # exhausted forward walker whose contig grew restarts leftward
        # from the contig's first read, reverse-complemented (reference
        # src/reorder.h:562-571); an exhausted left walker dies
        grew = state["grew"] | matched_any
        missed = searching & ~matched_any
        shift_base = torch.where(missed, shift_base + SC, shift_base)
        death = missed & (shift_base > maxshift)
        start_left = death & ~left_phase & grew
        active = active & ~(death & (left_phase | ~grew))
        left_phase = left_phase | start_left
        shift_base = torch.where(start_left, 0, shift_base)
        fr_rows = packed[first_rid.clamp(0, Np - 1)]
        fr_len = fr_rows[:, Wl] & 0x7FFFFFFF
        fr_rc = bits.revcomp_packed(fr_rows[:, :Wl], fr_len)
        fr_counts = _lane_inc(bits.unpack(fr_rc, Lb), fr_len)
        counts = torch.where(start_left[:, None], fr_counts, counts)
        ref_len = torch.where(start_left, fr_len, ref_len)

        # seeding: inactive walkers take the next unclaimed queue reads
        # (reference src/reorder.h:570-592)
        inactive = ~active & room
        rank = torch.cumsum(inactive.to(torch.int32), dim=0) - 1
        qidx = state["queue_pos"] + rank
        in_range = inactive & (qidx < n_real)
        seed_rid = seed_order[qidx.clamp(0, Np - 1)]
        ok_seed = in_range & ~claimed_bit(claimed, seed_rid)
        claimed = claim(claimed, ok_seed, seed_rid)
        seed_len = lengths[seed_rid]
        seed_cnt = _lane_inc(bits.unpack(packed[seed_rid, :Wl], Lb),
                             seed_len)
        counts = torch.where(ok_seed[:, None], seed_cnt, counts)
        ref_len = torch.where(ok_seed, seed_len, ref_len)
        shift_base = torch.where(ok_seed, 0, shift_base)
        active = active | ok_seed
        left_phase = left_phase & ~ok_seed
        grew = grew & ~ok_seed
        first_rid = torch.where(ok_seed, seed_rid, first_rid)
        queue_pos = (state["queue_pos"]
                     + in_range.sum().to(torch.int32))

        # emissions (B, M+1, 2): slot 0 seeds (flag 0), slots 1..M the
        # t-ordered accepts with within-round position deltas; word 1 is
        # delta | flag << 16 | rc << 24
        tw = torch.where(win, t_f, 0)
        cm = torch.cummax(tw, dim=1).values
        prev = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, :-1]], dim=1)
        flagv = torch.where(lp0[:, None], 2, 1).to(torch.int32)
        meta = torch.where(win, tw - prev + (flagv << 16) + (ko_f << 24),
                           0).to(torch.int32)
        emit_m = torch.stack([torch.where(win, rid_f, -1), meta], dim=-1)
        emit_seed = torch.stack([torch.where(ok_seed, seed_rid, -1),
                                 torch.zeros_like(seed_rid)], dim=-1)
        emit = torch.cat([emit_seed[:, None, :], emit_m], dim=1)

        new_state = dict(counts=counts, ref_len=ref_len, active=active,
                         shift_base=shift_base, first_rid=first_rid,
                         left_phase=left_phase, grew=grew,
                         claimed=claimed, queue_pos=queue_pos)
        return new_state, emit.to(torch.int32)

    def flush_fn(state, lengths, dkeys, pairs_all, seed_order, n_real,
                 maxshift, rows_tab):
        """FLUSH_ROUNDS rounds, then each walker's emissions compacted by a
        stable sort that puts empty slots last and scattered into a dense
        walker-major prefix. Returns (state, dense, cnt, stats) with stats
        = (claimed bits, queue_pos, active walkers, emitted rows)."""
        B = state["counts"].shape[0]
        dev = state["counts"].device
        cnt = torch.zeros(B, dtype=torch.int32, device=dev)
        ys = []
        for _ in range(FLUSH_ROUNDS):
            room = cnt < CAP - S
            state, emit = round_fn(state, lengths, dkeys, pairs_all,
                                   seed_order, n_real, maxshift, rows_tab,
                                   room)
            cnt = cnt + (emit[:, :, 0] >= 0).sum(dim=1).to(torch.int32)
            ys.append(emit)
        em = torch.stack(ys, dim=1).reshape(B, FLUSH_ROUNDS * S, 2)
        empty = (em[:, :, 0] < 0).to(torch.int32)
        _, perm = torch.sort(empty, dim=1, stable=True)
        w0 = torch.gather(em[:, :, 0], 1, perm)[:, :CAP]
        w1 = torch.gather(em[:, :, 1], 1, perm)[:, :CAP]
        # dense prefix: walker w's first cnt[w] slots move to
        # [base[w], base[w]+cnt[w]) — walker-major, slot order kept
        base = torch.cumsum(cnt, dim=0) - cnt
        s_idx = torch.arange(CAP, dtype=torch.int32, device=dev)[None, :]
        fill = s_idx < cnt[:, None]
        dst = torch.where(fill, base[:, None] + s_idx, B * CAP).reshape(-1)
        dense = torch.full((B * CAP + 1, 2), -1, dtype=torch.int32,
                           device=dev)
        dense[dst] = torch.stack([w0.reshape(-1), w1.reshape(-1)], dim=-1)
        stats = torch.stack([
            bits.popcount32(state["claimed"][: Np // 32]).sum(),
            state["queue_pos"].to(torch.int64),
            state["active"].sum(),
            cnt.sum()]).to(torch.int32)
        return state, dense, cnt, stats

    return round_fn, flush_fn, CAP


class ReorderEngine:
    """Runs the batched reorder on one device.

    Inputs are host numpy: packed (N, W) uint32 reads and lengths (N,).
    run() returns the emissions (M, 4) int32 rows of (rid, flag,
    pos_delta, rc) in walker-major timeline order."""

    ordered_emissions = True   # run() returns filtered walker-major rows

    def __init__(self, packed: np.ndarray, lengths: np.ndarray,
                 cfg: ReorderConfig, select: np.ndarray | None = None,
                 device="cpu"):
        """With ``select``, packed covers the full read set and the engine
        operates on packed[select] (gathered on the device)."""
        self.cfg = cfg
        self.device = torch.device(device)
        if select is None:
            select = np.arange(packed.shape[0], dtype=np.int32)
            lengths_sel = lengths
        else:
            select = np.ascontiguousarray(select, np.int32)
            lengths_sel = lengths[select]
        self._full = packed
        self._sel = select
        self.N = len(select)
        self.W = packed.shape[1]
        self.Lb = self.W * bits.BASES_PER_WORD
        self.Np = padded_n(self.N)
        # ~256 reads per walker (B=4096 at 1M reads); an explicit
        # num_walkers below the REORDER_BATCH cap is honoured up to Np/8
        auto = max(8, self.Np // 256)
        self.B = int(min(cfg.num_walkers, auto)
                     if cfg.num_walkers >= P.REORDER_BATCH
                     else min(cfg.num_walkers, max(8, self.Np // 8)))
        self.windows = dct.default_windows(cfg.max_readlen)
        self._dicts = None
        self._released = False
        lengths_p = np.zeros(self.Np, np.int32)
        lengths_p[: self.N] = lengths_sel
        self.lengths = torch.as_tensor(lengths_p, device=self.device)
        _, self._flush_fn, _ = _flush_program(
            self.Np, cfg.candidates, cfg.shift_chunk, cfg.accept_slots,
            tuple(w.start for w in self.windows), cfg.thresh)

    def _check_live(self) -> None:
        if self._released:
            raise RuntimeError("ReorderEngine used after release()")

    @property
    def dicts(self) -> list[dct.DeviceDict]:
        """Device dictionaries (built from a fresh row table when accessed
        outside run())."""
        self._check_live()
        if self._dicts is None:
            self._build_dicts(self._device_rows())
        return self._dicts

    def release(self) -> None:
        """Drop the engine's device tensors and mark it unusable."""
        self._dicts = None
        self.lengths = None
        self._full = None
        self._released = True

    def _device_rows(self) -> torch.Tensor:
        """The engine's (Np, W+1) row table on the device: packed[select]
        plus the length word, bit 31 set on padding rows."""
        self._check_live()
        sel_p = np.full(self.Np, -1, np.int32)
        sel_p[: self.N] = self._sel
        n_used = int(self._sel.max()) + 1 if self.N else 1
        full = torch.as_tensor(np.ascontiguousarray(
            self._full[:n_used]).view(np.int32), device=self.device)
        return _assemble_rows(full, torch.as_tensor(sel_p,
                                                    device=self.device),
                              self.lengths)

    def _build_dicts(self, rows: torch.Tensor) -> None:
        self._dicts = dct.build_hash_dicts_device(rows, self.N, self.windows)
        for d in self._dicts:
            nd = int(d.dropped)
            if nd:
                print(f"[dict] {nd} keys overflowed the hash table and "
                      "were dropped", file=sys.stderr)

    def _init_state(self) -> dict:
        B, Lb, Np = self.B, self.Lb, self.Np
        dev = self.device
        # claimed set as a bitmap; the last word is a scatter sink
        nwords = Np // 32 + 2
        claimed = np.zeros(nwords, np.uint32)
        pad = np.zeros(Np, bool)
        pad[self.N:] = True                   # padding reads are never live
        claimed[: Np // 32] = np.packbits(
            pad, bitorder="little").view(np.uint32)

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return dict(
            counts=z((B, Lb), torch.int32),
            ref_len=z((B,), torch.int32),
            active=z((B,), torch.bool),
            shift_base=z((B,), torch.int32),
            first_rid=z((B,), torch.int32),
            left_phase=z((B,), torch.bool),
            grew=z((B,), torch.bool),
            claimed=torch.as_tensor(claimed.view(np.int32), device=dev),
            queue_pos=z((), torch.int32),
            rows=self._device_rows(),
        )

    def run(self, progress=None) -> np.ndarray:
        """Emissions (n_emitted, 4) int32 rows of (rid, flag, pos_delta,
        rc), walker-major, empty slots filtered out.

        The loop keeps the JAX engine's pipelining exactly, since it
        decides which reads seed which walkers: flush k+1 is dispatched
        before flush k's stats are read, seed-queue compaction acts on
        stats one flush old, and the speculative last flush is
        harvested."""
        dev = self.device
        state = self._init_state()
        rows_tab = state.pop("rows")
        self._build_dicts(rows_tab)
        # both dicts' tables stacked: one probe gather serves every dict
        dkeys = torch.cat([d.btab for d in self._dicts], dim=0)
        pairs_all = torch.cat([dct.pairs_from_rids(d.rids)
                               for d in self._dicts], dim=0)
        for d in self._dicts:
            d.btab = None
        lengths = self.lengths
        # strided seed order: the first B seeds spread over the input
        stride = max(self.N // self.B, 1)
        idx = np.arange(self.N, dtype=np.int32)
        so = (np.concatenate([idx[r::stride] for r in range(stride)])
              if self.N else idx)
        so = np.concatenate(
            [so, np.full(self.Np - len(so), self.Np - 1, np.int32)])
        queue = so[: self.N].astype(np.int32)
        n_real = len(queue)
        seed_order = torch.as_tensor(so.astype(np.int32), device=dev)
        maxshift = self.cfg.max_shift
        chunks = []
        rounds = 0
        LAST_RUN_STATS.clear()
        t_start = time.time()

        def dispatch():
            nonlocal state
            state, dense, cnt, stats = self._flush_fn(
                state, lengths, dkeys, pairs_all, seed_order, n_real,
                maxshift, rows_tab)
            return dense, cnt, stats

        def harvest(dense_k, cnt_k, emitted):
            """(walker, rid, word) rows of one flush — the walker column
            rebuilt from the per-walker counts."""
            cnt_np = cnt_k.cpu().numpy()
            out = np.empty((emitted, 3), np.int32)
            out[:, 0] = np.repeat(np.arange(len(cnt_np), dtype=np.int32),
                                  cnt_np)
            out[:, 1:] = dense_k[:emitted].cpu().numpy()
            return out

        inflight = dispatch()
        fetch_q = []
        while True:
            nxt = dispatch()
            dense_k, cnt_k, stats_k = inflight
            inflight = nxt
            stats_np = stats_k.cpu().numpy()
            emitted = int(stats_np[3])
            if emitted:
                fetch_q.append((dense_k, cnt_k, emitted))
            while len(fetch_q) > 1:
                chunks.append(harvest(*fetch_q.pop(0)))
            n_claimed = int(stats_np[0]) - (self.Np - self.N)
            queue_pos = int(stats_np[1])
            any_active = stats_np[2] > 0
            rounds += FLUSH_ROUNDS
            if progress is not None:
                progress(n_claimed, self.N)
            if (queue_pos >= n_real and not any_active
                    and (emitted == 0 or n_claimed >= self.N)):
                break
            # compact the seed queue: drop already-claimed reads so the
            # endgame doesn't burn rounds skipping them (reads the state
            # of the flush just dispatched)
            if (queue_pos > 0 and n_claimed < self.N
                    and self.N - n_claimed < 0.5 * n_real):
                claimed_np = np.unpackbits(
                    state["claimed"][: self.Np // 32].cpu().numpy()
                    .view(np.uint8), bitorder="little")[: self.N]
                remaining = queue[~claimed_np[queue].astype(bool)]
                queue = remaining
                if not len(remaining):
                    continue
                seed_order = torch.as_tensor(np.concatenate([
                    remaining,
                    np.full(self.Np - len(remaining), self.Np - 1,
                            np.int32)]).astype(np.int32), device=dev)
                n_real = len(remaining)
                state["queue_pos"] = torch.zeros((), dtype=torch.int32,
                                                 device=dev)
        # drain the speculative in-flight flush and the pending harvests
        dense_k, cnt_k, stats_k = inflight
        emitted_tail = int(stats_k[3].item())
        if emitted_tail:
            fetch_q.append((dense_k, cnt_k, emitted_tail))
        for f in fetch_q:
            chunks.append(harvest(*f))
        dt = time.time() - t_start
        out = _emissions_from_chunks(chunks)
        LAST_RUN_STATS.update(
            rounds=rounds, flush_wall_s=round(dt, 3),
            ms_per_round=round(1000 * dt / max(rounds, 1), 2),
            emitted=int(len(out)), walkers=self.B)
        return out


def _emissions_from_chunks(chunks: list[np.ndarray]) -> np.ndarray:
    """Per-flush (walker, rid, word) rows -> filtered walker-major (k, 4)
    rows of (rid, flag, pos_delta, rc): an O(n) stable merge of the
    walker-sorted chunks."""
    chunks = [c for c in chunks if len(c)]
    if not chunks:
        return np.empty((0, 4), np.int32)
    B = int(max(c[:, 0].max() for c in chunks)) + 1
    counts = [np.bincount(c[:, 0], minlength=B) for c in chunks]
    total = np.sum(counts, axis=0)
    starts = np.zeros(B, np.int64)
    np.cumsum(total[:-1], out=starts[1:])
    n = int(total.sum())
    em3 = np.empty((n, 3), np.int32)
    prior = np.zeros(B, np.int64)
    for c, cnt in zip(chunks, counts):
        w = c[:, 0]
        cstart = np.zeros(B, np.int64)
        np.cumsum(cnt[:-1], out=cstart[1:])
        within = np.arange(len(w), dtype=np.int64) - cstart[w]
        em3[starts[w] + prior[w] + within] = c
        prior += cnt
    # unpack word = delta | flag<<16 | rc<<24
    out = np.empty((n, 4), np.int32)
    out[:, 0] = em3[:, 1]
    out[:, 1] = (em3[:, 2] >> 16) & 0xFF
    out[:, 2] = em3[:, 2] & 0xFFFF
    out[:, 3] = (em3[:, 2] >> 24) & 0xFF
    return out
