"""Batched read-reordering engine on one device (PyTorch).

Port of spring_tpu/reorder/engine.py. B contig walkers advance in
lock-step rounds: each round a walker probes SC shifts x 2 dictionaries x
{forward, reverse-complement} of its consensus, verifies the candidate
reads with the fused fetch-and-verify kernel (ops/kernels.py), accepts every
verified read (first walker wins a contested read), updates its packed
u8x4 consensus counts, and emits (rid, delta|flag|rc) slots. Reference
analog: the greedy consensus-following walk of src/reorder.h:432-616.

The round is a plain function over tensors on the engine's device. A
flush (ReorderConfig.flush_rounds rounds, then a per-walker compaction of the
emissions) runs on a ``FlushRunner`` over static buffers, the counterpart
of the JAX program's jitted lax.scan: on CUDA one round is called, then
the round and the compaction are each captured once into a CUDA graph and
replayed, flush after flush; on the CPU the same steps are called on the
same buffers. The runner stays in the process's program cache
(ops/graphs.py, the counterpart of the JAX module's lru_cache): the next
engine of the same static shapes binds its inputs into the same buffers
and replays the same graphs.
Packed words are int32 bit patterns (ops/bits.py). Every stage is
integer-only and deterministic, so emissions equal the JAX engine's
exactly.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import params as P
from ..ops import bits, graphs, kernels
from ..utils import spans
from . import dictionary as dct

# the defaults of ReorderConfig.flush_rounds (rounds between host syncs)
# and .cap_per_round (emission-buffer slots per walker per round at SC=16)
FLUSH_ROUNDS = 32
CAP_PER_ROUND = 3
_BIG = 2**31 - 1

# stats of the most recent run(): rounds, flush wall, emitted rows, the
# flushes' device time (flush_device_s: CUDA events around each flush's
# work, None on the CPU; a captured flush's holds its capture) and the
# host's wait in the loop's device reads (flush_wait_s), and the flush
# runner's own (see FlushRunner.stats)
LAST_RUN_STATS: dict = {}


# reads up to which padded_n pads to a power of two (the JAX package's
# literal 2^26); past it, 1/8-octave granules
POW2_MAX_READS = 1 << 26


def padded_n(n: int) -> int:
    """Engine read-count padding: pow2 up to POW2_MAX_READS reads, then
    1/8-octave granules (100M reads: 6 * 2^24). Always a multiple of 64
    (bitmap words, pairs rows)."""
    np_pow2 = max(1 << max(n - 1, 1).bit_length(), 64)
    if n <= POW2_MAX_READS:
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
    # probe thinning: shifts >= far_near probe one dictionary (d = s % D)
    # instead of all D; 0 probes every dictionary at every shift (the
    # reference, src/reorder.h:479-557)
    far_near: int = 0
    # emission-buffer slots per walker per round (scaled by SC / 16); a
    # walker whose flush buffer is full stalls until the next flush
    cap_per_round: int = CAP_PER_ROUND
    # in-bin dictionary compaction when the claimed count grew by this
    # fraction of the reads since the last one (above 1: never)
    rebuild_fraction: float = 10.0
    flush_rounds: int = FLUSH_ROUNDS     # rounds between host syncs
    # wide dictionary rows (32-bit starts, 8-bit counts) below the 2^27
    # entries that call for them: the probe that 135M+ reads take
    force_wide: bool = False

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
                   starts: tuple, thresh: int, far_near: int = 0,
                   cap_per_round: int = CAP_PER_ROUND,
                   flush_rounds: int = FLUSH_ROUNDS):
    """Build (round_fn, flush_fn, emit_cap, flush_runner) for one shape
    signature."""
    D = len(starts)
    # static probe-group list in priority order: shift > orientation >
    # dict (the reference search order, src/reorder.h:479-557); with
    # far_near > 0, shifts past it probe one dictionary (d = s % D)
    thin = bool(far_near) and far_near < SC and D > 1
    groups = [(s, o, d) for s in range(SC) for o in range(2)
              for d in range(D)
              if not thin or s < far_near or d == s % D]
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
    CAP = flush_rounds * max(cap_per_round, cap_per_round * SC // 16) + S
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
        k_frame_m = (srel * 2 + o_sel)[:, :, None].expand(
            B, GSEL, C).reshape(B, M)
        pr_m = (g_id.to(torch.int32)[:, :, None] * C
                + k["co"][None, None, :]).reshape(B, M)

        # ---- verify: candidate-row fetch, claimed test, range and masked
        # Hamming of every slot in one fused kernel launch ----
        ok, t, clen, _ = kernels.verify_rows(
            packed, cand_m, valid_m, claimed, frames, k_frame_m,
            shift_base, ref_len, thresh)

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
        ko_f = torch.gather(k_frame_m, 1, slot_f) & 1
        clen_f = torch.gather(clen, 1, slot_f)
        # the accepted rows, fetched by id: a slot that did not win gets
        # another row than its candidate's, and is masked by len_all == 0
        safe_f = rid_f.clamp(0, Np - 1)
        rows_f = packed[safe_f]                       # (B, M, W+1)

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
        claimed = claim(claimed, win.reshape(-1), safe_f.reshape(-1))
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

    def flush_runner(state, lengths, dkeys, pairs_all, seed_order, n_real,
                     maxshift, rows_tab) -> FlushRunner:
        """A FlushRunner over these tensors. They are its static buffers:
        the state's tensors change in place flush by flush (the JAX flush
        donates its state), and the caller changes ``seed_order`` or the
        0-dim ``n_real`` and ``state["queue_pos"]`` in place only (through
        the runner's ``state`` and ``inputs``, which a later engine binds
        anew). n_real and maxshift may be given as ints. A flush returns
        (dense, cnt, stats): each walker's emissions of flush_rounds
        rounds, compacted by a stable sort that puts empty slots last and
        scattered into a dense walker-major prefix; stats = (claimed bits,
        queue_pos, active walkers, emitted rows)."""
        dev = state["counts"].device
        inputs = dict(
            lengths=lengths, dkeys=dkeys, pairs_all=pairs_all,
            seed_order=seed_order,
            n_real=torch.as_tensor(n_real, dtype=torch.int32, device=dev),
            maxshift=torch.as_tensor(maxshift, dtype=torch.int32,
                                     device=dev),
            rows_tab=rows_tab)

        def step(state, inp, room):
            return round_fn(state, inp["lengths"], inp["dkeys"],
                            inp["pairs_all"], inp["seed_order"],
                            inp["n_real"], inp["maxshift"], inp["rows_tab"],
                            room)

        def compact(state, em, cnt):
            B = cnt.shape[0]
            empty = (em[:, :, 0] < 0).to(torch.int32)
            _, perm = torch.sort(empty, dim=1, stable=True)
            w0 = torch.gather(em[:, :, 0], 1, perm)[:, :CAP]
            w1 = torch.gather(em[:, :, 1], 1, perm)[:, :CAP]
            # dense prefix: walker w's first cnt[w] slots move to
            # [base[w], base[w]+cnt[w]) — walker-major, slot order kept
            base = torch.cumsum(cnt, dim=0) - cnt
            s_idx = torch.arange(CAP, dtype=torch.int32, device=dev)[None, :]
            fill = s_idx < cnt[:, None]
            dst = torch.where(fill, base[:, None] + s_idx,
                              B * CAP).reshape(-1)
            dense = torch.full((B * CAP + 1, 2), -1, dtype=torch.int32,
                               device=dev)
            dense[dst] = torch.stack([w0.reshape(-1), w1.reshape(-1)],
                                     dim=-1)
            stats = torch.stack([
                bits.popcount32(state["claimed"][: Np // 32]).sum(),
                state["queue_pos"].to(torch.int64),
                state["active"].sum(),
                cnt.sum()]).to(torch.int32)
            return dense, cnt.clone(), stats

        return FlushRunner(state, inputs, step, compact, S, CAP,
                           flush_rounds)

    def flush_fn(state, lengths, dkeys, pairs_all, seed_order, n_real,
                 maxshift, rows_tab):
        """One flush on a new runner over these tensors (see
        flush_runner): (state, dense, cnt, stats)."""
        runner = flush_runner(state, lengths, dkeys, pairs_all, seed_order,
                              n_real, maxshift, rows_tab)
        return (runner.state, *runner.flush())

    return round_fn, flush_fn, CAP, flush_runner


class FlushRunner:
    """Runs flushes over static buffers: the counterpart of the JAX
    program's jitted lax.scan.

    ``state`` and ``inputs`` are dicts of tensors, the runner's buffers.
    ``step(state, inputs, room)`` runs one round (reading ``state``) and
    returns (new state, emissions (B, slots, 2)); ``room`` is False for a
    walker whose flush buffer of ``cap`` slots has no room for another
    round. ``compact(state, em, cnt)`` turns the flush's stacked emissions
    (B, rounds * slots, 2) and the per-walker counts of filled slots
    into the flush's outputs; it must not return ``cnt`` itself (it is
    zeroed for the next flush). A round writes the new state into
    ``state``'s tensors and its emissions into row r of a stack, r a
    device-side round counter: every tensor the steps touch keeps its
    storage for the runner's life. flush() runs ``rounds`` rounds and
    the compaction, and returns clones of the outputs, so that they
    outlive the flushes after it.

    On the CPU the steps are called. On CUDA the runner's first flush
    calls one round (kernel loads, lazy inits, a process group's
    communicator), captures the round into a CUDA graph on the state's
    device (ops/graphs.py) and replays it for the flush's other rounds;
    it calls the compaction, as the warm-up of its capture, and captures
    it too. Every later flush replays both: one graph launch a round. A
    capture that fails raises; nothing goes back to the called steps on
    the card. The runner outlives its engine in the program cache
    (ops/graphs.py): ``bind`` copies the next engine's start state and
    inputs into the buffers, and that engine's flushes replay the graphs
    from its first flush on."""

    def __init__(self, state: dict, inputs: dict, step, compact,
                 slots: int, cap: int, rounds: int = FLUSH_ROUNDS):
        B = state["counts"].shape[0]
        self.device = dev = state["counts"].device
        self.state, self.inputs = state, inputs
        self._step, self._compact = step, compact
        self.rounds = rounds
        self._room = cap - slots
        self._cnt = torch.zeros(B, dtype=torch.int32, device=dev)
        self._ys = torch.full((B, rounds, slots, 2), -1,
                              dtype=torch.int32, device=dev)
        self._r = torch.zeros(1, dtype=torch.int64, device=dev)
        self._graphs = None             # (round graph, compaction graph)
        self.pool_bytes = 0
        self._new_run()

    def _new_run(self) -> None:
        """Zero the counts of one engine run."""
        self.flushes = self.eager_rounds = 0
        self.round_replays = self.graphed_flushes = 0
        self.capture_s = None
        # host clock at the first flush, at the first capture's start, and
        # when the graphs were at hand (the capture's end, or the first
        # flush of a run that found them captured)
        self._t_first = self._t_capture = self._t_graphed = None

    def bind(self, state: dict, inputs: dict) -> None:
        """Start a new run on these buffers: copy ``state`` and ``inputs``
        (same keys, and each tensor of its buffer's shape and dtype; an
        int fills a 0-dim buffer) into them. The caller then reads and
        changes ``self.state`` and ``self.inputs``, not what it passed."""
        with torch.profiler.record_function("stpu::bind"):
            for bufs, new in ((self.state, state), (self.inputs, inputs)):
                if bufs.keys() != new.keys():
                    raise ValueError(f"bind: keys {sorted(new)} against "
                                     f"the runner's {sorted(bufs)}")
                for k, buf in bufs.items():
                    v = new[k]
                    if not isinstance(v, torch.Tensor):
                        buf.fill_(v)
                    elif v.shape != buf.shape or v.dtype != buf.dtype:
                        raise ValueError(
                            f"bind: {k} is {v.dtype}{tuple(v.shape)}, the "
                            f"runner's {buf.dtype}{tuple(buf.shape)}")
                    else:
                        buf.copy_(v)
            # every flush ends with the compaction, which zeroes both; a
            # run that raised part-way leaves them set
            self._cnt.zero_()
            self._r.zero_()
        self._new_run()

    def _round(self) -> None:
        new, emit = self._step(self.state, self.inputs,
                               self._cnt < self._room)
        for k, v in new.items():
            self.state[k].copy_(v)
        self._cnt.add_((emit[:, :, 0] >= 0).sum(dim=1).to(torch.int32))
        self._ys.index_copy_(1, self._r, emit[:, None])
        self._r.add_(1)

    def _epilogue(self) -> tuple:
        B = self._ys.shape[0]
        out = self._compact(self.state, self._ys.reshape(B, -1, 2),
                            self._cnt)
        self._cnt.zero_()
        self._r.zero_()
        return out

    def _replay_round(self) -> None:
        self._graphs[0].replay()
        self.round_replays += 1

    def flush(self) -> tuple:
        if not self.flushes:
            self._t_first = time.perf_counter()
            if self._graphs is not None:
                self._t_graphed = self._t_first
        if not graphs.enabled(self.device):
            for _ in range(self.rounds):
                self._round()
            self.eager_rounds += self.rounds
            outs = self._epilogue()
        elif self._graphs is None:
            # a new program: one round called, then captured (a capture
            # records and runs nothing) and replayed for the other rounds;
            # the compaction is called, then captured
            self._round()
            self.eager_rounds += 1
            self._capture()
            for _ in range(self.rounds - 1):
                self._replay_round()
            outs = self._epilogue()
            self._capture()
        else:
            for _ in range(self.rounds):
                self._replay_round()
            epi = self._graphs[1]
            epi.replay()
            self.graphed_flushes += 1
            outs = epi.outputs
        self.flushes += 1
        return tuple(o.clone() for o in outs)

    def _capture(self) -> None:
        """Capture the round (the first call) or the compaction (the
        second, into the round's memory pool). capture_s adds up the host
        time of both, instantiation included, and pool_bytes what the
        device's reserved memory grew by."""
        dev = self.device
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev) if cuda else 0
        t = time.perf_counter()
        if self._t_capture is None:
            self._t_capture = t
        with torch.profiler.record_function("stpu::capture"):
            if self._graphs is None:
                self._graphs = (graphs.Graph(self._round, dev),)
            else:
                rounds = self._graphs[0]
                self._graphs = (rounds, graphs.Graph(
                    self._epilogue, dev, pool=rounds.pool))
        if cuda:
            torch.cuda.synchronize(dev)
            self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self._t_graphed = time.perf_counter()
        self.capture_s = (self.capture_s or 0.0) + self._t_graphed - t

    def recount(self, old, new) -> None:
        """Counts the graphs add to ``old`` go to ``new`` from now on."""
        for g in self._graphs or ():
            g.recount(old, new)

    def nbytes(self) -> int:
        """Bytes of the buffers and the graph pool."""
        seen = {}
        for t in (*self.state.values(), *self.inputs.values(), self._cnt,
                  self._ys, self._r):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values()) + self.pool_bytes

    def free(self) -> None:
        """Drop the graphs and the buffers; the runner is unusable after."""
        for g in self._graphs or ():
            g.reset()
        self._graphs = None
        self.state, self.inputs = {}, {}
        self._cnt = self._ys = self._r = None
        self.pool_bytes = 0

    def stats(self) -> dict:
        """The runner's numbers of this run for LAST_RUN_STATS, taken when
        the run's last flush has been read: warmup_s is the host time from
        the first flush to the capture, capture_s that of the captures
        (both None where this run captured nothing), ms_per_graphed_round
        the host time after the graphs were at hand over the rounds
        replayed (None where no round was replayed)."""
        if not self.round_replays:
            return dict(flushes=self.flushes, graphed_flushes=0,
                        round_replays=0, capture_s=None,
                        graph_pool_bytes=None, warmup_s=None,
                        ms_per_graphed_round=None)
        after = time.perf_counter() - self._t_graphed
        captured = self.capture_s is not None
        return dict(
            flushes=self.flushes, graphed_flushes=self.graphed_flushes,
            round_replays=self.round_replays,
            capture_s=round(self.capture_s, 4) if captured else None,
            graph_pool_bytes=self.pool_bytes,
            warmup_s=(round(self._t_capture - self._t_first, 4)
                      if captured else None),
            ms_per_graphed_round=round(1000 * after / self.round_replays,
                                       3))


class DeviceRowStager:
    """Overlap the packed rows' host-to-device copy with the parse (copy
    of spring_tpu's DeviceRowStager).

    ``feed(r0, rows)`` copies each parsed segment into a device table
    while the next segment parses, so that the engine starts from device
    rows. The table holds ``cap`` rows, 1/8-octave granules of at least
    one segment; a tail segment is padded to the segment's shape. On the
    card a segment goes through one of two pinned host buffers and is
    copied without blocking on a side stream, so that the parse does not
    wait on the card; ``rows()`` makes the caller's stream wait for the
    copies."""

    def __init__(self, n: int, W: int, seg: int, device="cuda"):
        gran = max(1 << max(int(max(n, 1) - 1).bit_length() - 3, 6), seg)
        self.cap = -(-max(n, 1) // gran) * gran
        self.W = W
        self.seg = seg
        self.device = torch.device(device)
        self._buf = None
        self._released = False
        self._fed = 0
        self._stream = self._pinned = self._copied = None

    def _table(self) -> torch.Tensor:
        if self._buf is None:
            self._buf = torch.zeros((self.cap, self.W), dtype=torch.int32,
                                    device=self.device)
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
                # the side stream writes the table after it is zeroed
                self._stream.wait_stream(
                    torch.cuda.current_stream(self.device))
                self._pinned = [torch.empty((self.seg, self.W),
                                            dtype=torch.int32,
                                            pin_memory=True)
                                for _ in range(2)]
                self._copied = [None, None]
        return self._buf

    def feed(self, r0: int, rows: np.ndarray) -> None:
        """Copy the (k <= seg, W) uint32 rows of one segment to table rows
        [r0, r0 + seg)."""
        self._check_live()
        buf = self._table()
        k = rows.shape[0]
        src = torch.from_numpy(np.ascontiguousarray(rows).view(np.int32))
        if self.device.type != "cuda":
            buf[r0:r0 + k] = src
            buf[r0 + k:r0 + self.seg] = 0
            return
        i = self._fed % 2
        if self._copied[i] is not None:
            self._copied[i].synchronize()   # the copy of two feeds ago
        pin = self._pinned[i]
        pin[:k] = src
        pin[k:] = 0
        with torch.cuda.stream(self._stream):
            buf[r0:r0 + self.seg].copy_(pin, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._copied[i] = ev
        self._fed += 1

    def rows(self) -> torch.Tensor:
        """The (cap, W) int32 device table (zeros if nothing was fed),
        complete on the caller's stream."""
        self._check_live()
        buf = self._table()
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return buf

    def release(self) -> None:
        """Drop the table and the pinned buffers and mark the stager
        unusable: rows() after release raises instead of recreating
        zeros."""
        if self._stream is not None:
            self._stream.synchronize()
        self._buf = self._pinned = self._copied = self._stream = None
        self._released = True

    def _check_live(self) -> None:
        if self._released:
            raise RuntimeError("DeviceRowStager used after release()")


class ReorderEngine:
    """Runs the batched reorder on one device.

    Inputs are host numpy: packed (N, W) uint32 reads and lengths (N,).
    run() returns the emissions (M, 4) int32 rows of (rid, flag,
    pos_delta, rc) in walker-major timeline order."""

    ordered_emissions = True   # run() returns filtered walker-major rows

    def __init__(self, packed: np.ndarray, lengths: np.ndarray,
                 cfg: ReorderConfig, select: np.ndarray | None = None,
                 device="cuda", rows_dev: torch.Tensor | None = None):
        """With ``select``, packed covers the full read set and the engine
        operates on packed[select] (gathered on the device). ``rows_dev``
        is that read set's rows already on the device, a (>= max rid + 1,
        W) int32 table (DeviceRowStager.rows()): the engine gathers from
        it instead of copying ``packed``."""
        self.cfg = cfg
        self.device = torch.device(device)
        self._rows_dev = rows_dev
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
        self.dict_dropped: list[int] = []
        self._released = False
        lengths_p = np.zeros(self.Np, np.int32)
        lengths_p[: self.N] = lengths_sel
        self.lengths = torch.as_tensor(lengths_p, device=self.device)
        starts = tuple(w.start for w in self.windows)
        *_, self._flush_runner = _flush_program(
            self.Np, cfg.candidates, cfg.shift_chunk, cfg.accept_slots,
            starts, cfg.thresh, cfg.far_near, cfg.cap_per_round,
            cfg.flush_rounds)
        # every static thing the runner's buffers and graphs depend on
        # (jit keys the JAX program on its input shapes by itself)
        self._program_key = (
            "single", self.Np, self.W, self.B, self.Lb, starts,
            cfg.candidates, cfg.shift_chunk, cfg.accept_slots, cfg.thresh,
            cfg.far_near, cfg.cap_per_round, cfg.flush_rounds,
            dct._use_wide(self.Np, cfg.force_wide), str(self.device))

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
        """Drop the engine's device tensors and mark it unusable (what the
        program cache holds stays there; ops/graphs.py)."""
        self._dicts = None
        self._rows_dev = None
        self.lengths = None
        self._full = None
        self._released = True

    def _device_rows(self) -> torch.Tensor:
        """The engine's (Np, W+1) row table on the device: packed[select]
        plus the length word, bit 31 set on padding rows."""
        self._check_live()
        sel_p = np.full(self.Np, -1, np.int32)
        sel_p[: self.N] = self._sel
        if self._rows_dev is not None:
            full = self._rows_dev
        else:
            n_used = int(self._sel.max()) + 1 if self.N else 1
            full = torch.as_tensor(np.ascontiguousarray(
                self._full[:n_used]).view(np.int32), device=self.device)
        return _assemble_rows(full, torch.as_tensor(sel_p,
                                                    device=self.device),
                              self.lengths)

    def _build_dicts(self, rows: torch.Tensor) -> None:
        self._dicts = dct.build_hash_dicts_device(
            rows, self.N, self.windows, self.cfg.force_wide)
        self.dict_dropped = [int(d.dropped) for d in self._dicts]
        for nd in self.dict_dropped:
            if nd:
                print(f"[dict] {nd} keys overflowed the hash table and "
                      "were dropped", file=sys.stderr)

    def _compact_dicts(self, drids: list, claimed: torch.Tensor) -> list:
        """Each dictionary's rids with the live entries moved to the front
        of every bin (bin starts and counts unchanged): the reference's
        in-bin deletion (src/bitset_util.cpp:38-63), on the device."""
        return [dct.compact_bins_dev(d.keys_dev, r, claimed)
                for d, r in zip(self._dicts, drids)]

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

        The flushes run on one FlushRunner (a replayed CUDA graph on the
        card), taken from the program cache when an engine of the same key
        left one there (ops/graphs.py), else built over this run's tensors
        and left there. The loop keeps the JAX engine's pipelining
        exactly, since it decides which reads seed which walkers: flush
        k+1 is dispatched before flush k's stats are read, seed-queue
        compaction acts on stats one flush old, and the speculative last
        flush is harvested. When the claimed count has grown by
        ``cfg.rebuild_fraction`` of the reads since the last time, the
        dictionaries' bins are compacted against the claimed bitmap that
        the flush just dispatched leaves, and their pair rows rewritten in
        the runner's buffer: the next flush still reads the old rows, the
        one after it the new."""
        dev = self.device
        # a miss frees the device's old program before this run builds
        runner = graphs.cached_program(dev, 0, self._program_key)
        staged = self._rows_dev is not None
        state = self._init_state()
        rows_tab = state.pop("rows")
        # the staged table is folded into rows_tab: drop it before the
        # dictionary builds run their temporaries
        self._rows_dev = None
        self._build_dicts(rows_tab)
        # both dicts' tables stacked: one probe gather serves every dict
        dkeys = torch.cat([d.btab for d in self._dicts], dim=0)
        row_words = int(dkeys.shape[1])     # compact 12, wide 14
        pairs_all = torch.cat([dct.pairs_from_rids(d.rids)
                               for d in self._dicts], dim=0)
        for d in self._dicts:
            d.btab = None
        # the bins as the last dictionary compaction left them
        drids = [d.rids for d in self._dicts]
        # strided seed order: the first B seeds spread over the input
        stride = max(self.N // self.B, 1)
        idx = np.arange(self.N, dtype=np.int32)
        so = (np.concatenate([idx[r::stride] for r in range(stride)])
              if self.N else idx)
        so = np.concatenate(
            [so, np.full(self.Np - len(so), self.Np - 1, np.int32)])
        queue = so[: self.N].astype(np.int32)
        n_real = len(queue)
        # the seed queue lives in static buffers: compaction rewrites them
        seed_order = torch.as_tensor(so.astype(np.int32), device=dev)
        hit = runner is not None
        if hit:
            runner.bind(state, dict(
                lengths=self.lengths, dkeys=dkeys, pairs_all=pairs_all,
                seed_order=seed_order, n_real=n_real,
                maxshift=self.cfg.max_shift, rows_tab=rows_tab))
        else:
            runner = self._flush_runner(
                state, self.lengths, dkeys, pairs_all, seed_order, n_real,
                self.cfg.max_shift, rows_tab)
        # from here on the run reads and changes the runner's buffers
        del state, dkeys, pairs_all, seed_order, rows_tab
        state = runner.state
        seed_order = runner.inputs["seed_order"]
        n_real_dev = runner.inputs["n_real"]
        chunks = []
        rounds = compactions = dict_compactions = last_claimed = 0
        dict_compact_s = 0.0
        flush_rounds = self.cfg.flush_rounds
        LAST_RUN_STATS.clear()
        t_start = time.time_ns()
        waited = 0      # ns the host was blocked in the loop's device reads
        device_ms = []  # each flush's device time, on a card

        def read(t: torch.Tensor) -> np.ndarray:
            """``t`` on the host; the wait counts into ``waited``."""
            nonlocal waited
            t0 = time.time_ns()
            out = t.cpu().numpy()
            waited += time.time_ns() - t0
            return out

        def dispatch():
            """Enqueue a flush: its outputs, and for its span the dispatch's
            start, how it ran and, on a card, a pair of timing events
            recorded on the stream before and after its work."""
            t0 = time.time_ns()
            events = None
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
            replays = runner.graphed_flushes
            outs = runner.flush()
            if events is not None:
                events[1].record(stream)
            mode = ("called" if not graphs.enabled(dev) else "replayed"
                    if runner.graphed_flushes > replays else "captured")
            return outs, (t0, mode, events)

        def flush_span(meta, waited_from):
            """The span of a flush whose stats the host has read, from its
            dispatch to now: the device's time (the events are complete
            once the stats have reached the host) and the host's wait in
            the device reads since ``waited_from``."""
            t0, mode, events = meta
            ms = events[0].elapsed_time(events[1]) if events else None
            if ms is not None:
                device_ms.append(ms)
            spans.record("flush", "reorder", t0, time.time_ns(), mode=mode,
                         device_ms=ms, wait_ms=(waited - waited_from) / 1e6)

        def compact_dicts():
            """Compact the bins and rewrite their pair rows in place: the
            runner's graphs read pairs_all at a fixed address. Enqueued on
            the engine's stream after the flush in flight, it reads the
            claimed bitmap that flush leaves. Returns the host seconds
            around the compaction, the device synchronised before and
            after."""
            nonlocal drids
            sync = torch.cuda.synchronize if dev.type == "cuda" else None
            if sync:
                sync(dev)
            t = time.perf_counter()
            drids = self._compact_dicts(drids, state["claimed"])
            pairs_all = runner.inputs["pairs_all"]
            nprow = self.Np // 8
            for d, r in enumerate(drids):
                pairs_all[d * nprow:(d + 1) * nprow].copy_(
                    dct.pairs_from_rids(r))
            if sync:
                sync(dev)
            return time.perf_counter() - t

        def harvest(dense_k, cnt_k, emitted):
            """(walker, rid, word) rows of one flush — the walker column
            rebuilt from the per-walker counts."""
            cnt_np = read(cnt_k)
            out = np.empty((emitted, 3), np.int32)
            out[:, 0] = np.repeat(np.arange(len(cnt_np), dtype=np.int32),
                                  cnt_np)
            out[:, 1:] = read(dense_k[:emitted])
            return out

        inflight = dispatch()
        fetch_q = []
        done = None     # the flush read last, its span left to record
        while True:
            if done is not None:
                flush_span(*done)
            nxt = dispatch()
            (dense_k, cnt_k, stats_k), meta = inflight
            inflight = nxt
            waited_from = waited
            stats_np = read(stats_k)
            done = (meta, waited_from)
            emitted = int(stats_np[3])
            if emitted:
                fetch_q.append((dense_k, cnt_k, emitted))
            while len(fetch_q) > 1:
                chunks.append(harvest(*fetch_q.pop(0)))
            n_claimed = int(stats_np[0]) - (self.Np - self.N)
            queue_pos = int(stats_np[1])
            any_active = stats_np[2] > 0
            rounds += flush_rounds
            if progress is not None:
                progress(n_claimed, self.N)
            if (queue_pos >= n_real and not any_active
                    and (emitted == 0 or n_claimed >= self.N)):
                break
            if (n_claimed - last_claimed
                    > self.cfg.rebuild_fraction * max(self.N, 1)):
                dict_compact_s += compact_dicts()
                dict_compactions += 1
                last_claimed = n_claimed
            # compact the seed queue: drop already-claimed reads so the
            # endgame doesn't burn rounds skipping them (reads the state
            # of the flush just dispatched; the next flush reads the new
            # queue from the same buffers)
            if (queue_pos > 0 and n_claimed < self.N
                    and self.N - n_claimed < 0.5 * n_real):
                claimed_np = np.unpackbits(
                    read(state["claimed"][: self.Np // 32])
                    .view(np.uint8), bitorder="little")[: self.N]
                remaining = queue[~claimed_np[queue].astype(bool)]
                queue = remaining
                if not len(remaining):
                    continue
                seed_order.copy_(torch.from_numpy(np.concatenate([
                    remaining,
                    np.full(self.Np - len(remaining), self.Np - 1,
                            np.int32)]).astype(np.int32)))
                n_real = len(remaining)
                n_real_dev.fill_(n_real)
                state["queue_pos"].zero_()
                compactions += 1
        flush_span(*done)
        # drain the speculative in-flight flush and the pending harvests
        (dense_k, cnt_k, stats_k), meta = inflight
        waited_from = waited
        emitted_tail = int(read(stats_k)[3])
        if emitted_tail:
            fetch_q.append((dense_k, cnt_k, emitted_tail))
        for f in fetch_q:
            chunks.append(harvest(*f))
        flush_span(meta, waited_from)
        dt = (time.time_ns() - t_start) / 1e9
        out = _emissions_from_chunks(chunks)
        if not hit:     # a run that raised leaves no program behind
            graphs.cache_program(dev, 0, self._program_key, runner)
        LAST_RUN_STATS.update(
            rounds=rounds, flush_wall_s=round(dt, 3),
            ms_per_round=round(1000 * dt / max(rounds, 1), 2),
            flush_device_s=(round(sum(device_ms) / 1000, 6)
                            if device_ms else None),
            flush_wait_s=round(waited / 1e9, 6),
            emitted=int(len(out)), walkers=self.B,
            rounds_run=runner.flushes * flush_rounds,
            queue_compactions=compactions, dict_compactions=dict_compactions,
            dict_compact_s=round(dict_compact_s, 4), **runner.stats(),
            program_cache="hit" if hit else "miss",
            eager_rounds=runner.eager_rounds,
            cached_program_bytes=graphs.cached_program_bytes(dev),
            staged_rows=staged, dict_row_words=row_words, Np=self.Np,
            dict_dropped=list(self.dict_dropped))
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


def assemble_contigs(emissions: np.ndarray, num_walkers: int = 0,
                     lengths: np.ndarray | None = None,
                     slots: int = 1,
                     ordered: bool = False) -> list[dict[str, np.ndarray]]:
    """Group emissions into per-contig read lists (host numpy; copy of
    spring_tpu's assemble_contigs).

    ``ordered`` emissions are a filtered walker-major stream (run()'s);
    otherwise they are round-major (R, num_walkers, slots) rows with
    empty slots (rid < 0). Returns a list of contigs, each a dict with:
      rids: (k,) int32 read ids in contig order (position-sorted)
      pos:  (k,) int64 read start offsets within the contig (min = 0)
      rc:   (k,) uint8 orientation flags
    Contig order is walker-major then time (the reference concatenates
    per-thread shards the same way, src/reorder.h:703-728). Left-phase
    emissions (flag 2) are reads matched against the reverse complement of
    the contig's first read: their coordinates fold back as
    o = len(first) - q - len(read) with orientation flipped."""
    if ordered:
        # every walker timeline starts with its seed (flag 0), so contig
        # segmentation alone works
        cols = [emissions] if len(emissions) else []
    else:
        R = emissions.shape[0] // (num_walkers * slots)
        em = emissions.reshape(R, num_walkers, slots, 4)
        cols = []
        for w in range(num_walkers):
            col = em[:, w].reshape(-1, 4)
            col = col[col[:, 0] >= 0]
            if len(col):
                cols.append(col)
    contigs = []
    for col in cols:
        starts = np.nonzero(col[:, 1] == 0)[0]
        bounds = np.append(starts, len(col))
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = col[a:b]
            right = seg[seg[:, 1] != 2]
            left = seg[seg[:, 1] == 2]
            pos = np.cumsum(right[:, 2].astype(np.int64))
            pos -= pos[0]
            rids = right[:, 0].astype(np.int32)
            rcs = right[:, 3].astype(np.uint8)
            if len(left):
                if lengths is None:
                    raise ValueError("left-phase emissions need lengths")
                l0 = int(lengths[rids[0]])
                q = np.cumsum(left[:, 2].astype(np.int64))
                lr = left[:, 0].astype(np.int32)
                o = l0 - q - lengths[lr].astype(np.int64)
                rids = np.concatenate([rids, lr])
                pos = np.concatenate([pos, o])
                rcs = np.concatenate([rcs,
                                      (1 - left[:, 3]).astype(np.uint8)])
            pos = pos - pos.min()
            order = np.argsort(pos, kind="stable")
            contigs.append(dict(rids=rids[order], pos=pos[order],
                                rc=rcs[order]))
    return contigs
