"""Multi-device reorder over torch.distributed: O(B/n) work a rank.

Port of spring_tpu/parallel/dist.py. It runs the round of the
distributed JAX engine, which differs from the single-device round
(reorder/engine.py) by design, with every heavy structure sharded over
the n ranks of a ``multihost.World`` (one process a device, n a power of
two):

  * walkers are data-parallel: each rank owns B/n contig walkers, their
    consensus lanes, frames and batch accepts;
  * the k-mer dictionaries are key-sharded: rank d holds ONE merged
    bucketed hash table over the (salted) keys of all dictionary windows
    whose owner hash routes to d, plus the matching rid bins and
    overlapping pair rows. The per-dict key salt is a bijective XOR, so a
    cross-dict collision only merges two bins' candidates, which the
    Hamming verify rejects. The table is built on the devices: each rank
    takes keys from its row block and routes (key, global rid) pairs to
    their owners with one all_to_all each;
  * the probe is metadata-only and capacity-limited (sort by owner, rank
    within the group, drop the overflow): keys ship to their owner, one
    packed (start | count) word returns. Each walker then picks its GSEL
    best-priority hitting groups and only those ship a candidate-fetch
    request (one pairs-row gather at the owner, C rids back);
  * packed read rows are range-sharded by rid and read-only: the verify
    fetches candidate rows from their owners through a third exchange and
    runs on the hand-written masked-Hamming kernel
    (``kernels.masked_hamming_rows``: the fetched (Bl, M, W+1) rows are
    its row-major layout). Claim state lives in the replicated bitmap
    only (claimed candidates are filtered before dispatch; unfetched
    slots come back marked claimed);
  * cross-rank claim conflicts are resolved replicated from one
    all_gather of per-rank claim proposals; every rank applies identical
    updates to its copy of the claimed bitmap (Np/8 bytes);
  * each rank drains its own strided slice of the seed queue. Seed rows
    ride the row-fetch exchange, so seeding decisions use the walker
    state carried from the previous round (a walker that dies in round r
    reseeds in round r+1).

Slot validity across an exchange is tracked only by the dispatch's
per-query slot map (_collect gathers replies back by slot): payloads are
raw 32-bit patterns, carried as int32, and are never sign-tested on the
receiving side (a key with the top bit set is a legitimate value, not an
empty slot).

Collectives a round: 2 all_to_alls (probe keys, meta words), 2 (candidate
requests, rids), 2 (row requests, rows), 1 all_gather (claim proposals).
All O(B/n) sized except the proposal gather (O(B)).

In-bin dictionary compaction (the JAX program's ``compact_fn``): when
the claimed count has grown by ``DistConfig.rebuild_fraction`` of the
reads since the last one, each rank compacts the bins of its own merged
table against its copy of the claimed bitmap and rewrites its pair rows
in place. No collective: the bitmap is replicated. Off by default (a
fraction above 1 never triggers), as in the JAX engine.
"""
from __future__ import annotations

import hashlib
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import params as P
from ..ops import bits, graphs, kernels
from ..reorder import dictionary as dct
from ..reorder import engine as eng
from . import multihost as mh

# decorrelated from both table hashes (_HASH_MULT picks buckets, _TAG_MULT
# makes the 16-bit tags): sharing _TAG_MULT here would fix the tag's top
# lg(n) bits per rank and shrink the effective tag entropy
_OWNER_MULT = 0xC2B2AE35
_BIG = eng._BIG
# per-dict bijective XOR salts so D windows share one merged table a rank
_SALTS = (0, 0x3C6EF372, 0x61C88647, 0x9E3779B9)
_TOP_BIT = -2**31       # int32 pattern of bit 31


@dataclass
class DistConfig:
    max_readlen: int
    num_walkers: int = P.REORDER_BATCH  # global walkers (divisible by n)
    candidates: int = P.DICT_PROBE_CANDIDATES
    thresh: int = P.THRESH_REORDER
    max_shift: int = 0
    shift_chunk: int = 16
    accept_slots: int = 16
    capacity_factor: float = 2.0   # all_to_all slack over the uniform load
    # the two knobs the JAX engine takes from its module globals
    # (REBUILD_FRACTION, FLUSH_ROUNDS): ReorderConfig's meaning and
    # defaults; the emission slots a round stay at 3 (scaled by SC / 16)
    rebuild_fraction: float = 10.0
    flush_rounds: int = eng.FLUSH_ROUNDS

    def __post_init__(self):
        # same cap as ReorderConfig
        if self.max_shift == 0:
            self.max_shift = max(min(self.max_readlen // 2,
                                     P.MAX_SHIFT_CAP), 1)


def _owner_of_key(key: torch.Tensor, n: int) -> torch.Tensor:
    """Owner rank of int32-pattern keys: the top lg(n) bits of a hash."""
    if n == 1:
        return torch.zeros(key.shape, dtype=torch.int32, device=key.device)
    lg = int(np.log2(n))
    return (bits.mul32(bits.u32(key), _OWNER_MULT) >> (32 - lg)).to(
        torch.int32)


def _dispatch(payloads: tuple, owner: torch.Tensor, valid: torch.Tensor,
              n: int, cap: int):
    """Capacity-limited dispatch table, built sort-first.

    payloads: tuple of (Q,) int32 tensors routed together. Returns
      sends: list of (n*cap,) int32 per-destination tables (-1 fill)
      slot:  (Q,) int32 table slot of each query (n*cap if dropped)
    Overflow beyond ``cap`` per destination is dropped. A dropped probe or
    candidate only loses match opportunities (the read stays a singleton
    or seeds later), never correctness.

    The tables are gathered from the stably sorted order (slot j of the
    table reads sorted entry starts[j // cap] + j % cap); the per-query
    slot map is the sorted slots put back through the sort's permutation."""
    Q = owner.shape[0]
    dev = owner.device
    key = torch.where(valid, owner, n)           # invalid to the end
    idx = torch.arange(Q, dtype=torch.int32, device=dev)
    ko, perm = torch.sort(key, stable=True)
    firsts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        ko[1:] != ko[:-1]])
    grp_start = torch.cummax(torch.where(firsts, idx, 0), 0).values
    rank = idx - grp_start
    ok = (ko < n) & (rank < cap)
    # per-destination entry counts and starts in the sorted order (n is
    # tiny: one broadcast compare)
    dests = torch.arange(n, dtype=torch.int32, device=dev)
    cnt = (ko[None, :] == dests[:, None]).sum(dim=1).to(torch.int32)
    starts = torch.cumsum(cnt, 0).to(torch.int32) - cnt
    j = torch.arange(n * cap, dtype=torch.int32, device=dev)
    d = (j // cap).to(torch.int64)
    r = j % cap
    src_idx = perm[(starts[d] + r).clamp(0, Q - 1).to(torch.int64)]
    slot_ok = r < cnt[d].clamp(max=cap)
    sends = [torch.where(slot_ok, p[src_idx], -1) for p in payloads]
    slot_q = torch.empty(Q, dtype=torch.int32, device=dev)
    slot_q[perm] = torch.where(ok, ko * cap + rank, n * cap)
    return sends, slot_q


def _collect(replies: torch.Tensor, slot_q: torch.Tensor) -> torch.Tensor:
    """Gather exchange replies back to their source queries.

    replies: (n*cap, ...) aligned with the dispatch table; slot_q as
    returned by _dispatch ((Q,), n*cap where nothing was sent). Returns
    (Q, ...) with zeros where nothing returned."""
    T = replies.shape[0]
    out = replies[slot_q.clamp(0, T - 1).to(torch.int64)]
    good = slot_q < T
    if replies.ndim > 1:
        good = good.reshape(good.shape + (1,) * (replies.ndim - 1))
    return torch.where(good, out, 0)


def _probe_meta_sc(btab: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Compact-table metadata probe of int32-pattern keys: the packed
    (start | count) word of the first tag hit as an int32 pattern, 0 on a
    miss (the math of dct.probe_meta's compact rows)."""
    S = btab.shape[0]
    flat = bits.u32(keys)
    b = bits.mul32(flat, dct._HASH_MULT) >> (32 - dct._log2(S))
    row = bits.u32(btab[b])
    tags, qtag = dct._tag_rows(row, flat)
    scw = row[:, dct.SLOTS // 2:]
    hit = (tags == qtag[:, None]) & ((scw & dct.SC_CMASK) > 0)
    first = hit.to(torch.uint8).argmax(dim=1, keepdim=True)
    sc = torch.where(hit.any(dim=1), scw.gather(1, first)[:, 0], 0)
    return bits.i32(sc)


def _dist_programs(world: mh.World, Np: int, W: int, B: int, C: int,
                   SC: int, accept_slots: int, starts: tuple, thresh: int,
                   capf: float,
                   flush_rounds: int = eng.FLUSH_ROUNDS) -> dict:
    """The build, compact, flush and flush-runner functions of one rank
    for one static shape signature, and the sizes that follow from it
    (``exchange``: the per-destination capacities of the key, probe,
    candidate and row exchanges, the entries R of this rank's merged
    table and its buckets S). The
    collectives go through ``ctx["world"]``: an engine that takes this
    program's runner from the cache puts its own World (of the same
    group) there."""
    n = world.size
    if n & (n - 1):
        raise ValueError(f"world size {n} is not a power of two")
    D = len(starts)
    if not 1 <= D <= len(_SALTS):
        raise ValueError(f"{D} dictionary windows; want 1..{len(_SALTS)}")
    me = world.rank
    Bl = B // n
    Npl = Np // n
    lg_npl = int(np.log2(Npl))
    Lb = W * 16
    G = SC * 2 * D
    GSEL = max(1, min(accept_slots, G * C) // C)
    M = GSEL * C
    S_EMIT = M + 1
    CAP = flush_rounds * max(3, 3 * SC // 16) + S_EMIT
    nwords = Np // 32 + 2
    # exchange capacities (per destination, per rank), never above the
    # query count itself (at n <= 2 the slack factor would size the tables
    # past what a destination can possibly receive)
    capk = max(-(-min(int(np.ceil(capf * D * Npl / n)), D * Npl)
                 // 8) * 8, 8)
    capq = max(min(int(np.ceil(capf * (Bl * G) / n)), Bl * G), 1)
    capc = max(min(int(np.ceil(capf * (Bl * GSEL) / n)), Bl * GSEL), 1)
    capr = max(min(int(np.ceil(capf * (Bl * (M + 2)) / n)),
                   Bl * (M + 2)), 1)
    R = n * capk                    # dictionary entries a rank
    if R > dct.MAX_COMPACT_ENTRIES:
        raise ValueError(
            f"per-device dictionary of {R} entries exceeds the compact "
            f"table's {dct.MAX_COMPACT_ENTRIES} (packed 27-bit starts); "
            "add ranks to shrink the per-device shard (the wide format "
            "used by the single-device engine past 2^27 entries is not "
            "wired into the distributed probe exchange)")
    S = dct.table_buckets(max(D * Np // n, 64))
    salts = np.array(_SALTS[:D], np.uint32).view(np.int32)
    salt_on = {}        # device -> the salts as a tensor there
    ctx = {"world": world}

    def a2a(x):
        return mh.all_to_all(ctx["world"], x)

    # ---------------- sharded dictionary build ----------------

    def build_fn(rows_local):
        # each temporary goes as soon as it is used (as in
        # dct._hash_build_core), so that the routing's tables are gone
        # before the hash build's peak
        dev = rows_local.device
        lengths = rows_local[:, W] & 0x7FFFFFFF
        ks, vs = [], []
        for d, st in enumerate(starts):
            w0, b = divmod(st, 16)
            lo = bits.srl(rows_local[:, w0], 2 * b)
            if b:
                lo = lo | (rows_local[:, w0 + 1] << (32 - 2 * b))
            ks.append(lo ^ int(salts[d]))
            # padding rows carry length 0, so the window check excludes
            # them along with genuinely short reads
            vs.append(lengths >= st + dct.KEY_BASES)
        del lengths, lo
        keys, valid = torch.cat(ks), torch.cat(vs)
        del ks, vs
        rids = (me * Npl + torch.arange(Npl, dtype=torch.int32, device=dev)
                ).repeat(D)
        sends, _ = _dispatch((keys, rids), _owner_of_key(keys, n), valid, n,
                             capk)
        del keys, rids, valid
        rk = a2a(sends[0])
        rr = a2a(sends[1])
        del sends
        keys_u = bits.u32(rk)
        del rk
        btab, h_s, rids_s, dropped = dct._hash_build_core(
            keys_u, rr >= 0, S, compact=True, rids=rr)
        del keys_u, rr
        return (btab, h_s, rids_s, dct.pairs_from_rids(rids_s),
                dropped.reshape(1))

    # ---------------- dictionary compaction (local, no collective) ------

    def compact_fn(keys_l, rids_l, claimed):
        """This rank's bins compacted against the replicated bitmap, and
        the pair rows of the new rids."""
        rids2 = dct.compact_bins_dev(keys_l, rids_l, claimed)
        return rids2, dct.pairs_from_rids(rids2)

    # ---------------- the sharded round ----------------

    def round_fn(state, btab, pairs, rows_local, seed_slice, maxshift,
                 room):
        counts = state["counts"]          # (Bl, Lb) packed u8x4 lanes
        ref_len = state["ref_len"]
        active = state["active"]
        shift_base = state["shift_base"]
        first_rid = state["first_rid"]
        lp0 = state["left_phase"]
        claimed = state["claimed"]        # replicated bitmap
        qpos = state["queue_pos"]         # (1,) this rank's queue cursor
        nq = state["n_queue"]             # (1,) live entries in my slice
        dev = counts.device
        i32 = torch.int32
        searching = active & room

        def claimed_bit(idx):
            return ((claimed[(idx >> 5).to(torch.int64)]
                     >> (idx & 31)) & 1) == 1

        def arange(k):
            return torch.arange(k, dtype=i32, device=dev)

        # ---- seed draw (from the previous round's walker state) ----
        inactive = ~active & room
        rank = torch.cumsum(inactive.to(i32), 0).to(i32) - 1
        qidx = qpos[0] + rank
        in_range = inactive & (qidx < nq[0])
        seed_rid = seed_slice[qidx.clamp(0, Npl - 1).to(torch.int64)]
        seed_try = in_range & ~claimed_bit(seed_rid)
        qpos = qpos + in_range.sum().to(i32)

        # ---- frames + salted queries ----
        frames, s_tot = eng.walker_frames_packed(counts, ref_len,
                                                 shift_base, SC)
        q, v = eng.walker_queries(frames, s_tot, ref_len, starts)
        # (Bl, SC, D, 2) -> (Bl, SC, 2, D): group id g = ((s*2+o)*D + d),
        # slot order IS the priority (shift > orientation > dict, the
        # reference search order, src/reorder.h:479-557)
        if dev not in salt_on:
            salt_on[dev] = torch.as_tensor(salts, device=dev)
        salt = salt_on[dev]
        keys_bg = (q.movedim(2, 3) ^ salt).reshape(Bl, G)
        v_g = (v.movedim(2, 3)
               & searching[:, None, None, None]).reshape(Bl * G)

        # ---- metadata-only probe exchange ----
        keys_g = keys_bg.reshape(-1)
        sends_q, slot_q = _dispatch((keys_g,), _owner_of_key(keys_g, n),
                                    v_g, n, capq)
        recv_k = a2a(sends_q[0])
        sc_back = a2a(_probe_meta_sc(btab, recv_k))
        sc_g = _collect(sc_back, slot_q).reshape(Bl, G)
        hit_g = ((sc_g & dct.SC_CMASK) > 0) & searching[:, None]

        # ---- pick the GSEL best-priority hitting groups ----
        negp = torch.where(hit_g, -arange(G)[None, :], -_BIG)
        negg = torch.topk(negp, GSEL, dim=1).values        # (Bl, GSEL)
        gok = negg != -_BIG
        g_id = torch.where(gok, -negg, 0)
        g64 = g_id.to(torch.int64)
        sc_sel = torch.gather(sc_g, 1, g64)
        st_sel = bits.srl(sc_sel, dct.SC_SHIFT)
        ct_sel = torch.where(gok, sc_sel & dct.SC_CMASK, 0)
        key_sel = torch.gather(keys_bg, 1, g64)
        o_sel = (g_id // D) % 2
        srel = g_id // (2 * D)

        # ---- candidate fetch exchange: only GSEL starts per walker ----
        sends_c, slot_c = _dispatch((st_sel.reshape(-1),),
                                    _owner_of_key(key_sel.reshape(-1), n),
                                    gok.reshape(-1), n, capc)
        recv_st = a2a(sends_c[0])
        prow = pairs[(recv_st >> 3).clamp(0, pairs.shape[0] - 1)
                     .to(torch.int64)]
        co = arange(C)
        cr = torch.gather(prow, 1, ((recv_st & 7)[:, None]
                                    + co[None, :]).to(torch.int64))
        back_c = a2a(cr)
        fetched_c = slot_c < n * capc
        cand_sel = torch.where(fetched_c[:, None],
                               _collect(back_c, slot_c),
                               -1).reshape(Bl, GSEL, C)
        vcand = ((co[None, None, :] < ct_sel.clamp(max=C)[:, :, None])
                 & gok[:, :, None])
        cand_m = cand_sel.reshape(Bl, M)
        valid_m = (vcand & (cand_sel >= 0)).reshape(Bl, M)

        def per_slot(x):
            """(Bl, GSEL) group field -> (Bl, M), one value a slot."""
            return x[:, :, None].expand(Bl, GSEL, C).reshape(Bl, M)

        # per-slot fields are pure arithmetic on the group id
        k_o_m = per_slot(o_sel)
        k_frame_m = per_slot(srel * 2 + o_sel)
        s_m = shift_base[:, None] + per_slot(srel)

        # ---- row fetch exchange: M candidates + first_rid + seed ----
        # claimed candidates are filtered before dispatch (the bitmap is
        # replicated and fresh as of last round); unfetched slots come
        # back with the claimed marker so they are never accepted
        req = torch.cat([cand_m.reshape(-1), first_rid, seed_rid])
        req_valid = torch.cat([
            (valid_m & ~claimed_bit(cand_m.clamp(0, Np - 1))).reshape(-1),
            torch.ones(Bl, dtype=torch.bool, device=dev), seed_try])
        owner_r = req.clamp(0, Np - 1) >> lg_npl
        sends_r, slot_r = _dispatch((req,), owner_r, req_valid, n, capr)
        recv_r = a2a(sends_r[0])
        rows_srv = rows_local[(recv_r.clamp(0, Np - 1) & (Npl - 1))
                              .to(torch.int64)]
        rows_back = a2a(rows_srv)
        fetched = slot_r < n * capr
        rows_all = torch.where(fetched[:, None],
                               _collect(rows_back, slot_r), _TOP_BIT)
        rows = rows_all[: Bl * M].reshape(Bl, M, W + 1)
        fr_rows = rows_all[Bl * M: Bl * M + Bl]
        seed_rows = rows_all[Bl * M + Bl:]

        # ---- verify: the masked-Hamming kernel over the fetched rows --
        lw = rows[..., W]
        claimed_row = lw < 0                              # bit 31
        clen = lw & 0x7FFFFFFF
        rl = ref_len[:, None]
        fwd = k_o_m == 0
        lo = torch.where(fwd, 0, s_m)
        hi = torch.where(fwd, torch.minimum(rl - s_m, clen),
                         torch.minimum(rl + s_m, clen))
        t = torch.where(fwd, s_m, rl + s_m - clen)
        frow = torch.gather(
            frames.reshape(Bl, 2 * SC, W), 1,
            k_frame_m.to(torch.int64)[:, :, None].expand(Bl, M, W))
        ham = kernels.masked_hamming_rows(frow, rows, lo, hi)
        ok = (valid_m & ~claimed_row & (ham <= thresh) & (t >= 0)
              & (hi > lo))

        # ---- dedup rids within the walker, then order accepts by t ----
        pr_m = (g_id[:, :, None] * C + co[None, None, :]).reshape(Bl, M)
        rid_eff = torch.where(ok, cand_m, _BIG)
        _, p1 = torch.sort(eng._lex2(rid_eff, pr_m), dim=1, stable=True)
        rid_s = torch.gather(rid_eff, 1, p1)
        t_s = torch.gather(t, 1, p1)
        firsts = torch.cat([torch.ones((Bl, 1), dtype=torch.bool,
                                       device=dev),
                            rid_s[:, 1:] != rid_s[:, :-1]], dim=1)
        keep_s = (rid_s != _BIG) & firsts
        tkey = torch.where(keep_s, t_s, _BIG)
        _, p2 = torch.sort(eng._lex2(tkey, rid_s), dim=1, stable=True)
        slot_f = torch.gather(p1, 1, p2)              # original slot
        keep_f = torch.gather(keep_s, 1, p2)
        rid_f = torch.gather(rid_s, 1, p2)
        t_f = torch.gather(t_s, 1, p2)
        ko_f = torch.gather(k_o_m, 1, slot_f)
        clen_f = torch.gather(clen, 1, slot_f)
        rows_f = torch.gather(
            rows, 1, slot_f[:, :, None].expand(Bl, M, W + 1))

        # ---- global claim resolution: one all_gather of proposals ----
        # priority classes: matches (first) beat seeds on the same rid
        prop_rid = torch.cat([torch.where(keep_f, rid_f, _BIG).reshape(-1),
                              torch.where(seed_try, seed_rid, _BIG)])
        Ppd = prop_rid.shape[0]
        props = mh.all_gather(ctx["world"], prop_rid)
        cls = torch.cat([torch.zeros(Bl * M, dtype=torch.int64, device=dev),
                         torch.ones(Bl, dtype=torch.int64, device=dev)]
                        ).repeat(n)
        # stable on (rid, class): ties fall to the gather's own order
        ks2, order = torch.sort(props.to(torch.int64) * 2 + cls,
                                stable=True)
        ks = ks2 >> 1
        firstp = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            ks[1:] != ks[:-1]])
        win_all = torch.empty(props.shape[0], dtype=torch.bool, device=dev)
        win_all[order] = firstp & (ks != _BIG)

        # replicated claimed-bitmap update for every winner (winner bits
        # were 0 before: proposals were filtered by the bitmap and the
        # resolution dedups within the round, so the add is an OR; the
        # last word is the sink)
        win_rid = torch.where(win_all, props, Np - 1)
        word = torch.where(win_all, win_rid >> 5, nwords - 1)
        bit = torch.where(win_all, 1 << (win_rid & 31), 0).to(i32)
        claimed = claimed.index_add(0, word.to(torch.int64), bit)

        # my verdict slices
        win_me = win_all[me * Ppd:(me + 1) * Ppd]
        win = win_me[: Bl * M].reshape(Bl, M) & keep_f
        ok_seed = win_me[Bl * M:] & seed_try

        matched_any = win.any(dim=1)
        t_roll = torch.where(win, t_f, 0).amax(dim=1)

        # ---- batched consensus update over packed lanes (O(Bl)) ----
        live = arange(Lb)[None, :] < ref_len[:, None]
        rolled0 = eng._roll_words(torch.where(live, counts, 0), t_roll)
        len0 = (ref_len - t_roll).clamp(min=0)
        pk_all = rows_f[..., :W]                          # (Bl, M, W)
        pk_all = torch.where((ko_f == 1)[:, :, None],
                             bits.revcomp_packed(pk_all, clen_f), pk_all)
        d_all = torch.where(win, t_roll[:, None] - t_f, 0)
        pk_all = bits.shift_bases_left(pk_all, d_all, Lb)
        codes_all = bits.unpack(pk_all, Lb)               # (Bl, M, Lb)
        len_all = torch.where(win, clen_f - d_all, 0)
        inc = eng._lane_inc(codes_all, len_all).sum(dim=1)
        rolled = eng._sat_add(rolled0, inc)
        new_len = torch.maximum(len0, len_all.amax(dim=1))
        counts = torch.where(matched_any[:, None], rolled, counts)
        ref_len = torch.where(matched_any, new_len, ref_len)
        shift_base = torch.where(matched_any, 0, shift_base)

        # ---- death / left phase ----
        left_phase = lp0
        missed = searching & ~matched_any
        shift_base = torch.where(missed, shift_base + SC, shift_base)
        death = missed & (shift_base > maxshift)
        start_left = death & ~left_phase
        active = active & ~(death & left_phase)
        left_phase = left_phase | start_left
        shift_base = torch.where(start_left, 0, shift_base)
        fr_len = fr_rows[:, W] & 0x7FFFFFFF
        fr_rc = bits.revcomp_packed(fr_rows[:, :W], fr_len)
        fr_counts = eng._lane_inc(bits.unpack(fr_rc, Lb), fr_len)
        counts = torch.where(start_left[:, None], fr_counts, counts)
        ref_len = torch.where(start_left, fr_len, ref_len)

        # ---- apply seeds ----
        seed_len = seed_rows[:, W] & 0x7FFFFFFF
        seed_cnt = eng._lane_inc(bits.unpack(seed_rows[:, :W], Lb),
                                 seed_len)
        counts = torch.where(ok_seed[:, None], seed_cnt, counts)
        ref_len = torch.where(ok_seed, seed_len, ref_len)
        shift_base = torch.where(ok_seed, 0, shift_base)
        active = active | ok_seed
        left_phase = left_phase & ~ok_seed
        first_rid = torch.where(ok_seed, seed_rid, first_rid)

        # ---- emissions (packed like the single-device round) ----
        tw = torch.where(win, t_f, 0)
        cm = torch.cummax(tw, dim=1).values
        prev = torch.cat([torch.zeros_like(cm[:, :1]), cm[:, :-1]], dim=1)
        flagv = torch.where(lp0[:, None], 2, 1).to(i32)
        meta = torch.where(win, tw - prev + (flagv << 16) + (ko_f << 24), 0)
        emit_m = torch.stack([torch.where(win, rid_f, -1), meta], dim=-1)
        emit_seed = torch.stack([torch.where(ok_seed, seed_rid, -1),
                                 torch.zeros_like(seed_rid)], dim=-1)
        emit = torch.cat([emit_seed[:, None, :], emit_m], dim=1)

        new_state = dict(counts=counts, ref_len=ref_len, active=active,
                         shift_base=shift_base, first_rid=first_rid,
                         left_phase=left_phase, claimed=claimed,
                         queue_pos=qpos, n_queue=nq)
        return new_state, emit.to(i32)

    # ---------------- the flush (flush_rounds rounds) ----------------

    def flush_runner(state, btab, pairs, rows_local, seed_slice,
                     maxshift) -> eng.FlushRunner:
        """A FlushRunner over these tensors, as the single engine's
        (reorder/engine.py): they are its static buffers, the state's
        tensors change in place, and the caller changes ``seed_slice``,
        ``state["n_queue"]`` and ``state["queue_pos"]`` in place only
        (through the runner's ``state`` and ``inputs``, which a later
        engine binds anew); maxshift may be an int. The runner's
        ``world_ctx`` is this program's ``ctx``. A flush runs flush_rounds
        rounds, then compacts each walker's stacked emissions once by a
        stable sort that puts empty slots last, and returns (buf (Bl,
        CAP, 2), stats (1, 4)) with stats = (claimed bits, queue_pos,
        active walkers, emitted rows). On CUDA the round's seven
        collectives are captured with it."""
        dev = state["counts"].device
        inputs = dict(btab=btab, pairs=pairs, rows_local=rows_local,
                      seed_slice=seed_slice,
                      maxshift=torch.as_tensor(maxshift, dtype=torch.int32,
                                               device=dev))

        def step(state, inp, room):
            return round_fn(state, inp["btab"], inp["pairs"],
                            inp["rows_local"], inp["seed_slice"],
                            inp["maxshift"], room)

        def compact(state, em, cnt):
            empty = (em[:, :, 0] < 0).to(torch.int32)
            _, perm = torch.sort(empty, dim=1, stable=True)
            buf = torch.stack([torch.gather(em[:, :, 0], 1, perm)[:, :CAP],
                               torch.gather(em[:, :, 1], 1, perm)[:, :CAP]],
                              dim=-1)
            # the claimed popcount is taken on the replicated bitmap, so it
            # is the same on every rank
            stats = torch.stack([
                bits.popcount32(state["claimed"][: Np // 32]).sum(),
                state["queue_pos"][0].to(torch.int64),
                state["active"].sum(),
                cnt.sum()]).to(torch.int32)[None, :]
            return buf, stats

        runner = eng.FlushRunner(state, inputs, step, compact, S_EMIT, CAP,
                                 flush_rounds)
        runner.world_ctx = ctx
        return runner

    def flush_fn(state, btab, pairs, rows_local, seed_slice, maxshift):
        """One flush on a new runner over these tensors (see
        flush_runner): (state, buf, stats)."""
        runner = flush_runner(state, btab, pairs, rows_local, seed_slice,
                              maxshift)
        return (runner.state, *runner.flush())

    return dict(build=build_fn, compact=compact_fn, flush=flush_fn,
                runner=flush_runner, CAP=CAP, Bl=Bl, Npl=Npl, M=M,
                exchange=dict(capk=capk, capq=capq, capc=capc, capr=capr,
                              R=R, S=S))


class DistReorderEngine:
    """Multi-device counterpart of ReorderEngine: walkers data-parallel,
    dictionaries and packed rows sharded, probe, candidate and row
    traffic over capacity-limited all_to_alls. Every rank of the world
    constructs it on the same reads and calls run(), which returns the
    same emissions on every rank (the contract of ReorderEngine.run)."""

    ordered_emissions = True

    def __init__(self, packed: np.ndarray, lengths: np.ndarray,
                 cfg: DistConfig, world: mh.World | None = None,
                 device="cuda"):
        """``world`` defaults to multihost.maybe_initialize(device); a
        world given here brings its own device."""
        self.world = world or mh.maybe_initialize(device)
        n = self.n = self.world.size
        self.cfg = cfg
        self.N = packed.shape[0]
        self.W = packed.shape[1]
        self.Lb = self.W * bits.BASES_PER_WORD
        self.Np = max(1 << max(self.N - 1, 1).bit_length(), 64 * n)
        # same auto walker sizing as the single-device engine (~256 reads
        # per walker), rounded to the world
        self.B = int(min(cfg.num_walkers,
                         max(8 * n, self.Np // 256)) // n * n)
        self.windows = dct.default_windows(cfg.max_readlen)
        starts = tuple(w.start for w in self.windows)
        self._prog = _dist_programs(
            self.world, self.Np, self.W, self.B, cfg.candidates,
            cfg.shift_chunk, cfg.accept_slots, starts, cfg.thresh,
            cfg.capacity_factor, cfg.flush_rounds)
        # the runner's key in the program cache: the world (as JAX keys
        # its programs on the mesh) and every static shape
        wd = self.world
        self._program_key = (
            "dist", wd.group, wd.rank, wd.size, str(wd.device), self.Np,
            self.W, self.B, cfg.candidates, cfg.shift_chunk,
            cfg.accept_slots, starts, cfg.thresh, cfg.capacity_factor,
            cfg.flush_rounds)
        # padded rows + length word; padding rows carry the claimed bit
        # (the only claim bit rows ever hold: live claim state is the
        # replicated bitmap, rows are read-only)
        packed_p = np.zeros((self.Np, self.W + 1), np.uint32)
        packed_p[: self.N, : self.W] = packed
        lengths_p = np.zeros(self.Np, np.int32)
        lengths_p[: self.N] = lengths
        packed_p[:, self.W] = lengths_p.view(np.uint32)
        packed_p[self.N:, self.W] |= np.uint32(1 << 31)
        self.packed = packed_p

    def release(self) -> None:
        """Drop the engine's row table and mark it unusable."""
        self.packed = None

    def _check_live(self) -> None:
        if self.packed is None:
            raise RuntimeError("DistReorderEngine used after release()")

    def _queue_slices(self, remaining: np.ndarray):
        """Strided split of the seed queue over the ranks at a fixed width
        (Npl), so queue compaction never changes the flush shape."""
        n, Npl = self.n, self._prog["Npl"]
        out = np.full((n, Npl), self.Np - 1, np.int32)
        nq = np.zeros((n, 1), np.int32)
        for d in range(n):
            s = remaining[d::n]
            out[d, : len(s)] = s
            nq[d, 0] = len(s)
        return out.reshape(n * Npl), nq.reshape(n)

    def init_state(self) -> dict:
        """This rank's share of the start state: walker fields are blocks
        of the B global walkers, the claimed bitmap is whole."""
        self._check_live()
        w = self.world
        nwords = self.Np // 32 + 2
        claimed = np.zeros(nwords, np.uint32)
        pad = np.zeros(self.Np, bool)
        pad[self.N:] = True
        claimed[: self.Np // 32] = np.packbits(
            pad, bitorder="little").view(np.uint32)
        Bl = self._prog["Bl"]

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=w.device)

        return dict(
            counts=z((Bl, self.Lb), torch.int32),
            ref_len=z((Bl,), torch.int32),
            active=z((Bl,), torch.bool),
            shift_base=z((Bl,), torch.int32),
            first_rid=z((Bl,), torch.int32),
            left_phase=z((Bl,), torch.bool),
            claimed=mh.put_replicated(w, claimed),
            queue_pos=z((1,), torch.int32),
            n_queue=z((1,), torch.int32),
        )

    def run(self, max_rounds: int | None = None,
            progress=None) -> np.ndarray:
        """Full distributed reorder. Returns filtered walker-major
        (rid, flag, pos_delta, rc) rows like ReorderEngine.run, the same
        on every rank. The flushes run on one FlushRunner (on the card a
        replayed CUDA graph, collectives included). The host loop keeps
        the JAX engine's pipelining: flush k+1 is dispatched before flush
        k's stats are read, and the speculative last flush is
        harvested. Dictionary compaction follows the single engine's
        trigger and order (reorder/engine.py, ReorderEngine.run)."""
        self._check_live()
        prog = self._prog
        w = self.world
        n = self.n
        collectives0, collective_s0 = w.collectives, w.collective_s
        # a miss frees the device's old program before this run builds
        runner = graphs.cached_program(w.device, w.rank, self._program_key)
        rows_dev = mh.put_sharded(w, self.packed)
        # the merged table's sorted keys and rids stay for compaction
        btab, keys_l, rids_l, pairs, dropped = prog["build"](rows_dev)
        dropped = mh.to_host(w, dropped).tolist()     # a rank each
        nd = sum(dropped)
        if nd:
            print(f"[dict] {nd} keys overflowed the sharded hash tables "
                  "and were dropped", file=sys.stderr)
        stride = max(self.N // max(self.B, 1), 1)
        idx = np.arange(self.N, dtype=np.int32)
        so = (np.concatenate([idx[r::stride] for r in range(stride)])
              if self.N else idx)
        queue = so.astype(np.int32)
        state = self.init_state()
        qslice, nq_arr = self._queue_slices(queue)
        state["n_queue"] = mh.put_sharded(w, nq_arr)
        # the seed queue lives in static buffers: compaction rewrites them
        seed_dev = mh.put_sharded(w, qslice)
        hit = runner is not None
        if hit:
            runner.bind(state, dict(btab=btab, pairs=pairs,
                                    rows_local=rows_dev, seed_slice=seed_dev,
                                    maxshift=self.cfg.max_shift))
            # the program's collectives and their counts follow this world
            old = runner.world_ctx["world"]
            if old is not w:
                runner.recount(old, w)
                runner.world_ctx["world"] = w
        else:
            runner = prog["runner"](state, btab, pairs, rows_dev, seed_dev,
                                    self.cfg.max_shift)
        # from here on the run reads and changes the runner's buffers
        del state, btab, pairs, rows_dev, seed_dev
        state = runner.state
        seed_dev = runner.inputs["seed_slice"]
        chunks = []
        rounds = compactions = dict_compactions = last_claimed = 0
        round_collectives = 0
        dict_compact_s = 0.0
        flush_rounds = self.cfg.flush_rounds
        eng.LAST_RUN_STATS.clear()
        t_start = time.time()

        def dispatch():
            nonlocal round_collectives
            before = w.collectives
            out = runner.flush()
            round_collectives += w.collectives - before
            return out

        def harvest(buf_k):
            return _compact_emit(mh.to_host(w, buf_k))

        inflight = dispatch()
        while True:
            nxt = dispatch()
            buf_k, stats_k = inflight
            inflight = nxt
            stats_np = mh.to_host(w, stats_k).reshape(n, 4)
            chunks.append(harvest(buf_k))
            rounds += flush_rounds
            n_claimed = int(stats_np[0, 0]) - (self.Np - self.N)
            any_active = stats_np[:, 2].sum() > 0
            emitted = int(stats_np[:, 3].sum())
            drained = bool((stats_np[:, 1] >= nq_arr).all())
            if progress is not None:
                progress(n_claimed, self.N)
            if drained and not any_active and (emitted == 0
                                               or n_claimed >= self.N):
                break
            if max_rounds is not None and rounds >= max_rounds:
                break
            # in-bin dictionary compaction on the bitmap the flush in
            # flight leaves; the pair rows are rewritten in the runner's
            # buffer (its graphs read them at a fixed address)
            if (n_claimed - last_claimed
                    > self.cfg.rebuild_fraction * max(self.N, 1)):
                cuda = w.device.type == "cuda"
                if cuda:
                    torch.cuda.synchronize(w.device)
                tc = time.perf_counter()
                rids_l, new_pairs = prog["compact"](keys_l, rids_l,
                                                    state["claimed"])
                runner.inputs["pairs"].copy_(new_pairs)
                del new_pairs
                if cuda:
                    torch.cuda.synchronize(w.device)
                dict_compact_s += time.perf_counter() - tc
                dict_compactions += 1
                last_claimed = n_claimed
            # endgame seed-queue compaction (drop claimed reads so the
            # tail doesn't burn rounds skipping them batch by batch)
            if n_claimed < self.N and \
                    self.N - n_claimed < 0.5 * max(int(nq_arr.sum()), 1):
                claimed_np = np.unpackbits(
                    state["claimed"][: self.Np // 32].cpu().numpy()
                    .view(np.uint8), bitorder="little")[: self.N].astype(bool)
                remaining = queue[~claimed_np[queue]]
                if len(remaining) < int(nq_arr.sum()):
                    queue = remaining
                    qslice, nq_arr = self._queue_slices(queue)
                    seed_dev.copy_(mh.put_sharded(w, qslice))
                    state["n_queue"].copy_(mh.put_sharded(w, nq_arr))
                    state["queue_pos"].zero_()
                    compactions += 1
        # drain the speculative in-flight flush
        chunks.append(harvest(inflight[0]))
        out = eng._emissions_from_chunks(chunks)
        dt = time.time() - t_start
        if not hit:     # a run that raised leaves no program behind
            graphs.cache_program(w.device, w.rank, self._program_key, runner)
        rstats = runner.stats()
        eng.LAST_RUN_STATS.update(
            rounds=rounds, flush_wall_s=round(dt, 3),
            ms_per_round=round(1000 * dt / max(rounds, 1), 2),
            emitted=int(len(out)), walkers=self.B, world_size=n,
            emissions_sha256=hashlib.sha256(out.tobytes()).hexdigest(),
            rounds_run=runner.flushes * flush_rounds,
            queue_compactions=compactions, dict_compactions=dict_compactions,
            dict_compact_s=round(dict_compact_s, 4),
            collectives=w.collectives - collectives0,
            # host seconds inside the collectives, known only where every
            # flush called them (a graph replays them with no host call)
            collective_host_s=(round(w.collective_s - collective_s0, 3)
                               if not rstats["graphed_flushes"] else None),
            collectives_per_round=round(
                round_collectives / (runner.flushes * flush_rounds), 3),
            **rstats, program_cache="hit" if hit else "miss",
            eager_rounds=runner.eager_rounds,
            cached_program_bytes=graphs.cached_program_bytes(w.device),
            Np=self.Np, dict_dropped=dropped,
            # host seconds inside the collectives called, not replayed
            # (a graphed run's: the build's exchange, the called round,
            # the stats' gathers)
            world_collective_s=round(w.collective_s - collective_s0, 4),
            exchange=prog["exchange"])
        return out


def _compact_emit(buf: np.ndarray) -> np.ndarray:
    """One flush's (B, CAP, 2) emit buffer -> (k, 3) int32 rows of
    (walker, rid, word), slot order preserved per walker."""
    w, s = np.nonzero(buf[:, :, 0] >= 0)
    out = np.empty((len(w), 3), np.int32)
    out[:, 0] = w
    out[:, 1] = buf[w, s, 0]
    out[:, 2] = buf[w, s, 1]
    return out
