"""Read k-mer dictionaries: built on the host or on the device, probed on
the device (PyTorch).

Port of spring_tpu/reorder/dictionary.py. A dictionary
is a bucketed open hash over 16-base (one 32-bit word) window keys: each
bucket holds SLOTS entries of (16-bit key tag, bin start, bin count), and
the bins are CSR runs of read ids sorted by h = key * _HASH_MULT, so the
bucket id h >> shift is monotonic along the sorted order. Reference
analog: the BooPHF + CSR bins of bbhashdict (src/bitset_util.h:74-221).

Tables are int32 tensors holding uint32 bit patterns (see ops/bits.py);
hash arithmetic runs in int64 on values in [0, 2^32). The host builders
(build_hash_dicts, build_hash_dicts_packed) stay numpy, as in the JAX
package, and put their tables on an explicit device.
"""
from __future__ import annotations

import functools
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import bits

KEY_BASES = 16  # bases per dictionary key (32 bits, 2 bits/base)
SLOTS = 8
_HASH_MULT = 0x9E3779B1
_HASH_MULT_INV = 0x0E8B2F51   # modular inverse mod 2^32
_TAG_MULT = 0x85EBCA6B
# compact row: SLOTS/2 words of packed 16-bit tags + SLOTS words of
# (start << SC_SHIFT | min(count, SC_CMASK)); tables past 2^27 entries, or
# any table with force_wide, use the wide row: full 32-bit starts + a
# plane of 8-bit counts
COMPACT_WORDS = SLOTS // 2 + SLOTS
WIDE_WORDS = SLOTS // 2 + SLOTS + SLOTS // 4
SC_SHIFT = 5
SC_CMASK = (1 << SC_SHIFT) - 1
MAX_COMPACT_ENTRIES = 1 << (32 - SC_SHIFT)
_PAD_RID = 2**31 - 1        # sort key of padding entries (after real rids)


@dataclass
class DictSpec:
    """Base window [start, start+KEY_BASES) indexed by one dictionary."""
    start: int

    @property
    def end(self) -> int:
        return self.start + KEY_BASES


def default_windows(max_len: int) -> list[DictSpec]:
    """Two windows flanking the read midpoint (reference src/reorder.h:
    752-759); short reads fall back to the front of the read."""
    mid = max_len // 2
    if max_len >= 2 * KEY_BASES:
        lo = min(mid - KEY_BASES, max_len - 2 * KEY_BASES)
        return [DictSpec(lo), DictSpec(min(mid, max_len - KEY_BASES))]
    if max_len >= KEY_BASES:
        return [DictSpec(0)]
    return []


def _window_keys_np(codes: np.ndarray, start: int) -> np.ndarray:
    """16-base window keys (uint32) of (n, L) base-code rows."""
    window = codes[:, start:start + KEY_BASES].astype(np.uint32)
    shifts = (2 * np.arange(KEY_BASES, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(window << shifts, axis=1)


def _window_keys_packed(packed: np.ndarray, start: int) -> np.ndarray:
    """16-base (one uint32) window keys straight from packed 2-bit rows."""
    w0, b = divmod(start, 16)
    lo = packed[:, w0] >> np.uint32(2 * b)
    if b:
        lo = lo | (packed[:, w0 + 1] << np.uint32(32 - 2 * b))
    return lo.astype(np.uint32)


def table_buckets(n_keys: int) -> int:
    """Bucket count for n_keys (pow2, ~2 slots per key), capped at 2^25."""
    b = max(1 << int(max(4 * n_keys // SLOTS, 1) - 1).bit_length(), 64)
    return min(b, 1 << 25)


def _use_wide(n_entries: int, force_wide: bool = False) -> bool:
    """Wide rows past the compact row's 2^27 starts, or when asked for
    (ReorderConfig.force_wide: the wide-row probe below that size)."""
    return force_wide or n_entries > MAX_COMPACT_ENTRIES


@dataclass
class HashDict:
    """One hash dictionary built on the host."""
    btab: torch.Tensor     # (S, COMPACT_WORDS or WIDE_WORDS) int32 rows
                           # (or classic (S, 3*SLOTS) [keys|starts|counts])
    rids: torch.Tensor     # (n,) int32 CSR payload, bins sorted by
                           # h = key * _HASH_MULT (bucket ids monotonic)
    start: int             # window start
    keys_sorted: object = None   # host np: original keys in bin order

    @property
    def nbuckets(self) -> int:
        return int(self.btab.shape[0])


def build_hash_dicts(codes: np.ndarray, lengths: np.ndarray,
                     windows: list[DictSpec] | None = None,
                     pad_to_pow2: bool = True, compact: bool = True,
                     device="cuda", force_wide: bool = False
                     ) -> list[HashDict]:
    """Host build from (n, L) base-code rows; tables on ``device``."""
    if windows is None:
        windows = default_windows(codes.shape[1])
    return _build_hash_dicts(
        lambda ok, start: _window_keys_np(codes[ok], start),
        lengths, windows, pad_to_pow2, compact, device, force_wide)


def build_hash_dicts_packed(packed: np.ndarray, lengths: np.ndarray,
                            windows: list[DictSpec],
                            pad_to_pow2: bool = True, compact: bool = True,
                            device="cuda", force_wide: bool = False
                            ) -> list[HashDict]:
    """build_hash_dicts from packed 2-bit rows (no codes matrix)."""
    return _build_hash_dicts(
        lambda ok, start: _window_keys_packed(packed[ok], start),
        lengths, windows, pad_to_pow2, compact, device, force_wide)


def _build_hash_dicts(keyfn, lengths: np.ndarray, windows: list[DictSpec],
                      pad_to_pow2: bool = True, compact: bool = True,
                      device="cuda", force_wide: bool = False
                      ) -> list[HashDict]:
    """The host build of every window: the same tables, bit for bit, as
    the device build of the same reads (rows sorted by h, bins found by
    np.unique, the all-padding sentinel bin dropped, at most SLOTS bins a
    bucket; the others are dropped, and counted)."""
    dev = torch.device(device)
    out = []
    for spec in windows:
        ok = lengths >= spec.end
        rids = np.nonzero(ok)[0].astype(np.int32)
        keys = keyfn(ok, spec.start)
        h = (keys * np.uint32(_HASH_MULT)).astype(np.uint32)
        order = np.argsort(h, kind="stable")
        keys, rids, h = keys[order], rids[order], h[order]
        if pad_to_pow2:
            n = max(1 << max(len(keys) - 1, 1).bit_length(), 64)
            keys = np.concatenate(
                [keys, np.full(n - len(keys), 0xFFFFFFFF, np.uint32)])
            rids = np.concatenate(
                [rids, np.full(n - len(rids), -1, np.int32)])
            h = np.concatenate(
                [h, np.full(n - len(h), 0xFFFFFFFF, np.uint32)])
        uh, starts, counts = np.unique(h, return_index=True,
                                       return_counts=True)
        ukeys = keys[starts]
        # drop the sentinel bin (rid -1 padding)
        if len(uh) and uh[-1] == 0xFFFFFFFF and rids[starts[-1]] == -1:
            uh, starts, counts = uh[:-1], starts[:-1], counts[:-1]
            ukeys = ukeys[:-1]
        S = table_buckets(len(uh))
        shift = 32 - _log2(S)
        bkey = np.zeros((S, SLOTS), np.uint32)
        bstart = np.zeros((S, SLOTS), np.int32)
        bcount = np.zeros((S, SLOTS), np.int32)
        # buckets are sorted; rank = index - first index of the bucket
        b = (uh >> np.uint32(shift)).astype(np.int64)
        first = np.concatenate([[True], b[1:] != b[:-1]])
        grp = np.cumsum(first) - 1
        first_idx = np.nonzero(first)[0]
        rank = np.arange(len(b)) - first_idx[grp]
        fits = rank < SLOTS
        bi, si = b[fits], rank[fits]
        bkey[bi, si] = ukeys[fits]
        bstart[bi, si] = starts[fits]
        bcount[bi, si] = counts[fits]
        dropped = int((~fits).sum())
        if compact:
            t8 = ((bkey * np.uint32(_TAG_MULT)) >> np.uint32(16)) \
                & np.uint32(0xFFFF)
            tagw = t8[:, 0::2] | (t8[:, 1::2] << np.uint32(16))
            if _use_wide(len(keys), force_wide):
                c8 = np.minimum(bcount, 255).astype(np.uint32)
                countw = (c8[:, 0::4] | (c8[:, 1::4] << np.uint32(8))
                          | (c8[:, 2::4] << np.uint32(16))
                          | (c8[:, 3::4] << np.uint32(24)))
                btab = np.concatenate(
                    [tagw, bstart.astype(np.uint32), countw], axis=1)
            else:
                scw = (bstart.astype(np.uint32) << np.uint32(SC_SHIFT)) \
                    | np.minimum(bcount, SC_CMASK).astype(np.uint32)
                btab = np.concatenate([tagw, scw], axis=1)
        else:
            if dropped:
                print(f"[dict] {dropped}/{len(uh)} keys overflowed the hash "
                      "table and were dropped", file=sys.stderr)
            btab = np.concatenate([bkey, bstart.view(np.uint32),
                                   bcount.view(np.uint32)], axis=1)
        out.append(HashDict(
            btab=torch.as_tensor(btab.view(np.int32), device=dev),
            rids=torch.as_tensor(rids, device=dev), start=spec.start,
            keys_sorted=keys))
    return out


@dataclass
class DeviceDict:
    """One hash dictionary on the device."""
    btab: torch.Tensor      # (S, COMPACT_WORDS or WIDE_WORDS) int32
    rids: torch.Tensor      # (Np,) int32, bins sorted by h (-1 = empty)
    keys_dev: torch.Tensor  # (Np,) int32 patterns of the sorted h
    start: int
    dropped: torch.Tensor   # () int32 — unique keys that overflowed


def _log2(S: int) -> int:
    return int(np.log2(S))


def _build_hash_dict_dev(rows: torch.Tensor, n_real, start: int, S: int,
                         wide: bool = False):
    """Build one bucketed hash dict from engine-layout rows on the device.

    rows: (Np, W+1) int32 — packed reads + length word (bit 31 marks
    padding). Returns (btab, keys_sorted, rids_sorted, dropped)."""
    Np, Wp1 = rows.shape
    W = Wp1 - 1
    lengths = rows[:, W] & 0x7FFFFFFF
    # dynamic_slice semantics: the 2-word window start clamps into range
    w0 = min(max(start // 16, 0), Wp1 - 2)
    b2 = 2 * (start % 16)
    lo = bits.srl(rows[:, w0], b2)
    if b2 > 0:
        lo = lo | (rows[:, w0 + 1] << (32 - b2))
    rid = torch.arange(Np, dtype=torch.int32, device=rows.device)
    ok = (rid < n_real) & (lengths >= start + KEY_BASES)
    return _hash_build_core(bits.u32(lo), ok, S, compact=True, wide=wide)


def _seq_keys(seq_words: torch.Tensor, p: torch.Tensor, w_off,
              nw: int) -> torch.Tensor:
    """16-mer key starting at base p of a packed flat sequence (int32)."""
    wi = (p >> 4) + w_off
    r2 = (2 * (p & 15)).to(torch.int32)
    lo = seq_words[wi.clamp(0, nw - 1)]
    hi = seq_words[(wi + 1).clamp(0, nw - 1)]
    return torch.where(r2 > 0, bits.srl_var(lo, r2) | (hi << (32 - r2)), lo)


def build_hash_dict_seq_dev(seq_words: torch.Tensor, total, word_offset: int,
                            S: int):
    """Sliding-window hash dict over a packed flat sequence: key[p] = the
    16-mer starting at base p, value = p. ``seq_words`` carries
    ``word_offset`` leading padding words. Returns (btab, keys_sorted,
    pos_sorted, dropped) with classic full-key rows; probe with
    probe_hash."""
    nw = seq_words.shape[0]
    npos = (nw - word_offset) * 16
    p = torch.arange(npos, dtype=torch.int32, device=seq_words.device)
    keys = _seq_keys(seq_words, p, word_offset, nw)
    ok = p <= total - KEY_BASES
    return _hash_build_core(bits.u32(keys), ok, S)


def build_hash_dict_seq_seg(seq_words: torch.Tensor, total, base: int,
                            word_offset: int, nw_seg: int, S: int):
    """Segmented build_hash_dict_seq_dev: keys for the (nw_seg - 2) * 16
    positions from flat-sequence base ``base`` (a multiple of 16), payload
    = global position. Bounds the build's memory for long consensus."""
    nw = seq_words.shape[0]
    w0 = min(max(word_offset + (base >> 4), 0), nw - nw_seg)
    seg = seq_words[w0:w0 + nw_seg]
    npos = (nw_seg - 2) * 16
    p = torch.arange(npos, dtype=torch.int32, device=seq_words.device)
    keys = _seq_keys(seg, p, 0, nw_seg)
    gp = p + base
    ok = gp <= total - KEY_BASES
    return _hash_build_core(bits.u32(keys), ok, S, rids=gp)


def _hash_build_core(keys: torch.Tensor, ok: torch.Tensor, S: int,
                     compact: bool = False, rids=None, wide: bool = False):
    """Shared device build, one sort total.

    keys: (Np,) int64 key values in [0, 2^32). Rows sort by (h, rid) with
    h = key * _HASH_MULT (a bijection, so equal keys still bin together
    and bucket ids come out monotonic) and padding keyed as
    (0xFFFFFFFF, INT32_MAX); the sort key is the composite int64
    h * 2^31 + rid. After the sort the work runs over the K bins (their
    heads, found by neighbour compares), not the Np rows: per-bucket slot
    ranks and placement follow from cumulative ops over the bins. Each
    temporary is dropped as soon as it is used (the Np-long ones first),
    so that the build holds a few Np-long words beside the sort's (at
    100M reads Np is 100,663,296: 0.8 GB an int64 word). The bin-head
    count syncs with the host: the build runs eagerly, never inside a
    CUDA graph. Returns (btab, keys_sorted, rids_sorted, dropped) —
    keys_sorted holds h."""
    Np = keys.shape[0]
    dev = keys.device
    rid = (torch.arange(Np, dtype=torch.int64, device=dev) if rids is None
           else rids.to(torch.int64))
    skey = torch.where(ok, bits.mul32(keys, _HASH_MULT), bits.MASK32)
    del keys
    skey.mul_(2**31).add_(torch.where(ok, rid, _PAD_RID))
    del rid, ok
    skey = torch.sort(skey).values
    h_s = skey >> 31
    rids_out = skey & _PAD_RID
    del skey
    rids_out = torch.where(rids_out == _PAD_RID, -1, rids_out).to(
        torch.int32)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    # bin heads (K,), ascending; a bin runs to the next head
    pos = torch.cat([one, h_s[1:] != h_s[:-1]]).nonzero().squeeze(1)
    ucount = torch.diff(pos, append=pos.new_full((1,), Np))
    hb = h_s[pos]
    h_out = bits.i32(h_s)
    del h_s
    # drop the all-padding sentinel bin
    entry = ~((hb == bits.MASK32) & (rids_out[pos] == -1))
    b = hb >> (32 - _log2(S))                    # monotonic buckets
    keys_s = bits.mul32(hb, _HASH_MULT_INV)      # original window keys
    del hb
    bfirst = torch.cat([one, b[1:] != b[:-1]])
    e = entry.to(torch.int64)
    ecum0 = torch.cumsum(e, 0) - e
    del e
    rank = ecum0 - torch.cummax(torch.where(bfirst, ecum0, 0), 0).values
    del ecum0, bfirst
    fits = entry & (rank < SLOTS)
    dropped = (entry & ~fits).sum().to(torch.int32)
    del entry

    if compact:
        # direct 2-D scatter-add into (S+1, words) rows, row S the sink:
        # slots 2j/2j+1 own disjoint 16-bit halves of tag word j
        t16 = (bits.mul32(keys_s, _TAG_MULT) >> 16) & 0xFFFF
        rowi = torch.where(fits, b, S)
        col_tag = (rank >> 1).clamp(0, SLOTS // 2 - 1)
        val_tag = torch.where(fits, t16 << (16 * (rank & 1)), 0)
        col_st = SLOTS // 2 + rank
        if not wide:
            scv = (((pos << SC_SHIFT) & bits.MASK32)
                   | ucount.clamp(max=SC_CMASK))
            cols = [col_tag, col_st.clamp(0, COMPACT_WORDS - 1)]
            vals = [val_tag, torch.where(fits, scv, 0)]
            words = COMPACT_WORDS
        else:
            # 4 tag words | 8 start words | 2 count words (byte s%4 of s//4)
            cnt8 = ucount.clamp(max=255) << (8 * (rank & 3))
            cols = [col_tag, col_st.clamp(0, SLOTS // 2 + SLOTS - 1),
                    (SLOTS // 2 + SLOTS + (rank >> 2)).clamp(
                        0, WIDE_WORDS - 1)]
            vals = [val_tag, torch.where(fits, pos, 0),
                    torch.where(fits, cnt8, 0)]
            words = WIDE_WORDS
        # integer adds commute, so the atomic scatter-add is deterministic;
        # a word's values own disjoint bits (at most one of them bit 31),
        # so their int32 patterns add without overflow
        btab = torch.zeros((S + 1) * words, dtype=torch.int32, device=dev)
        btab.index_add_(0, torch.cat([rowi * words + c for c in cols]),
                        bits.i32(torch.cat(vals)))
        return btab.view(S + 1, words)[:S], h_out, rids_out, dropped

    # classic full-key rows [keys | starts | counts] (sequence dicts),
    # placed as int32 patterns straight away
    flat = torch.where(fits, b * SLOTS + rank, S * SLOTS)
    planes = []
    for v in (bits.i32(keys_s), pos.to(torch.int32), ucount.to(torch.int32)):
        f = torch.zeros(S * SLOTS + 1, dtype=torch.int32, device=dev)
        f[flat] = torch.where(fits, v, 0)   # only the sink sees duplicates
        planes.append(f[: S * SLOTS].reshape(S, SLOTS))
    return torch.cat(planes, dim=1), h_out, rids_out, dropped


def build_hash_dicts_device(rows: torch.Tensor, n_real: int,
                            windows: list[DictSpec],
                            force_wide: bool = False) -> list[DeviceDict]:
    """Build all dictionaries on the device from engine-layout rows."""
    Np = int(rows.shape[0])
    S = table_buckets(Np)
    out = []
    for spec in windows:
        btab, keys_s, rids_s, dropped = _build_hash_dict_dev(
            rows, n_real, spec.start, S, _use_wide(Np, force_wide))
        out.append(DeviceDict(btab=btab, rids=rids_s, keys_dev=keys_s,
                              start=spec.start, dropped=dropped))
    return out


def pairs_from_rids_stacked(rids_all: torch.Tensor, D: int) -> torch.Tensor:
    """pairs_from_rids for D dictionaries stacked flat in ``rids_all``
    (dict d's rids at [d*n, (d+1)*n)): the (D*n/8, 16) stacked pair rows
    in one gather; a dictionary's boundary behaves like its own tail
    (positions past its n fill with -1)."""
    n = rids_all.shape[0] // D
    rows_per = n // 8
    dev = rids_all.device
    i = torch.arange(D * rows_per, dtype=torch.int64, device=dev)[:, None]
    d = i // rows_per
    li = (i % rows_per) * 8 + torch.arange(16, dtype=torch.int64,
                                            device=dev)[None, :]
    out = rids_all[(d * n + li).clamp(max=D * n - 1)]
    return torch.where(li >= n, -1, out).to(rids_all.dtype)


def pairs_from_rids(rids: torch.Tensor) -> torch.Tensor:
    """(n,) rids -> (n/8, 16) overlapping pair rows: row i holds
    rids[8i : 8i+16] (positions past n filled with -1), so a probe's up to
    8 candidates at any bin offset land in one gathered row."""
    n = rids.shape[0]
    dev = rids.device
    idx = (torch.arange(n // 8, dtype=torch.int64, device=dev)[:, None] * 8
           + torch.arange(16, dtype=torch.int64, device=dev)[None, :])
    out = rids[idx.clamp(max=n - 1)]
    return torch.where(idx >= n, -1, out)


def compact_bins_dev(keys_s: torch.Tensor, rids_s: torch.Tensor,
                     claimed: torch.Tensor) -> torch.Tensor:
    """In-bin compaction on the device: the live entries of each bin move
    to its front, ordered by ascending rid, and the dead ones (rid < 0, or
    claimed in the engine's bitmap ``claimed``) become -1; bin starts and
    counts are unchanged. keys_s: the sorted int32-pattern bin keys of
    the build; rids_s: its int32 rids. Reference analog: the bin deletion
    of src/bitset_util.cpp:38-63.

    One sort of (key, dead << 31 | rid), both halves ordered as unsigned
    32-bit words (the key's bit 31 flipped, so that the composite is a
    signed int64): within a bin live entries come first by ascending rid,
    the canonical in-bin order of the build."""
    safe = rids_s.clamp(0, claimed.shape[0] * 32 - 1).to(torch.int64)
    bit = (claimed[safe >> 5] >> (safe & 31)) & 1
    dead = (rids_s < 0) | (bit == 1)
    key2 = (torch.where(dead, 1 << 31, 0)
            | torch.where(rids_s < 0, 0, rids_s).to(torch.int64))
    skey, _ = torch.sort((bits.u32(keys_s) - 2**31) * 2**32 + key2)
    key2_s = skey & bits.MASK32
    return torch.where((key2_s >> 31) == 1, -1, key2_s).to(torch.int32)


def compact_bins(rids_np: np.ndarray, keys_np: np.ndarray,
                 claimed_np: np.ndarray) -> np.ndarray:
    """In-bin compaction on the host (the plain version of
    compact_bins_dev; copy of spring_tpu's compact_bins): move live
    entries to each bin's front without changing bin starts and counts
    (stable sort by (key, dead)). claimed_np: a bool per rid."""
    dead = (rids_np < 0) | claimed_np[np.clip(rids_np, 0,
                                              len(claimed_np) - 1)]
    order = np.lexsort((dead, keys_np))
    new_rids = rids_np[order].copy()
    new_rids[dead[order]] = -1
    return new_rids


def _tag_rows(row: torch.Tensor, qflat: torch.Tensor):
    """(Q, words) int64 bucket rows -> per-slot 16-bit tags (Q, SLOTS) and
    the queries' tags (Q,)."""
    tagw = row[:, :SLOTS // 2]
    tags = torch.stack([tagw & 0xFFFF, tagw >> 16], dim=2).reshape(-1, SLOTS)
    qtag = (bits.mul32(qflat, _TAG_MULT) >> 16) & 0xFFFF
    return tags, qtag


def _at_first_hit(hit: torch.Tensor, *planes: torch.Tensor):
    """Per row, each plane's value at the first slot where ``hit`` is set,
    0 where none is (argmax returns the first maximum)."""
    first = hit.to(torch.uint8).argmax(dim=1, keepdim=True)
    found = hit.any(dim=1)
    return [torch.where(found, p.gather(1, first)[:, 0], 0).to(torch.int32)
            for p in planes]


def _meta_from_rows(row: torch.Tensor, qflat: torch.Tensor):
    """(start, count) int32 of the first tag hit in compact/wide rows."""
    tags, qtag = _tag_rows(row, qflat)
    if row.shape[1] == COMPACT_WORDS:
        scw = row[:, SLOTS // 2:]
        hit = (tags == qtag[:, None]) & ((scw & SC_CMASK) > 0)
        return _at_first_hit(hit, scw >> SC_SHIFT, scw & SC_CMASK)
    srow = row[:, SLOTS // 2: SLOTS // 2 + SLOTS]
    cw = row[:, SLOTS // 2 + SLOTS:]
    cnts = torch.stack([cw & 0xFF, (cw >> 8) & 0xFF, (cw >> 16) & 0xFF,
                        cw >> 24], dim=2).reshape(-1, SLOTS)
    return _at_first_hit((tags == qtag[:, None]) & (cnts > 0), srow, cnts)


def probe_meta(btab: torch.Tensor, queries: torch.Tensor):
    """Hash-probe int32-pattern keys for bin metadata only: (start, count)
    int32 per query, count 0 on miss. Accepts classic (S, 3*SLOTS),
    compact (S, COMPACT_WORDS) and wide (S, WIDE_WORDS) rows."""
    S = btab.shape[0]
    flat = bits.u32(queries.reshape(-1))
    b = bits.mul32(flat, _HASH_MULT) >> (32 - _log2(S))
    row = bits.u32(btab[b])                      # one row gather
    if btab.shape[1] in (COMPACT_WORDS, WIDE_WORDS):
        start, count = _meta_from_rows(row, flat)
    else:
        crow = row[:, 2 * SLOTS:]
        start, count = _at_first_hit(
            (row[:, :SLOTS] == flat[:, None]) & (crow > 0),
            row[:, SLOTS:2 * SLOTS], crow)
    return start.reshape(queries.shape), count.reshape(queries.shape)


def probe_meta_split_stacked(btab_all: torch.Tensor, S: int,
                             queries: torch.Tensor):
    """Metadata probe of D compact/wide tables stacked along dim 0 (dict
    d's buckets at rows [d*S, (d+1)*S)); queries (D, ...) int32 keys.
    Returns (start, count) int32 with queries' shape (count 0 on miss):
    one row gather serves every dictionary, the format read from the
    stacked table's row width."""
    D = queries.shape[0]
    flat = bits.u32(queries.reshape(D, -1))
    b = bits.mul32(flat, _HASH_MULT) >> (32 - _log2(S))
    b = b + (torch.arange(D, dtype=torch.int64, device=queries.device)
             * S)[:, None]
    start, count = _meta_from_rows(bits.u32(btab_all[b.reshape(-1)]),
                                   flat.reshape(-1))
    return start.reshape(queries.shape), count.reshape(queries.shape)


@functools.lru_cache(maxsize=None)
def _group_offsets(dict_of_g: tuple, S: int, device) -> torch.Tensor:
    """(G,) int64 first bucket row of each group's dictionary, made once
    per device: a host-to-device copy each round would also stop the
    round from being captured into a CUDA graph."""
    return torch.tensor([d * S for d in dict_of_g], dtype=torch.int64,
                        device=device)


def probe_meta_groups(btab_all: torch.Tensor, S: int, queries: torch.Tensor,
                      dict_of_g: np.ndarray):
    """Metadata probe of D stacked compact/wide tables (dict d's buckets at
    rows [d*S, (d+1)*S)) for a static group list: queries (B, G) int32
    keys, dict_of_g (G,) the dictionary each group probes. One row
    gather. Returns (start, count) int32 (B, G)."""
    B, G = queries.shape
    flat = bits.u32(queries.reshape(-1))
    b = bits.mul32(flat, _HASH_MULT) >> (32 - _log2(S))
    off = _group_offsets(tuple(int(d) for d in dict_of_g), S,
                         queries.device)
    b = (b.reshape(B, G) + off[None, :]).reshape(-1)
    start, count = _meta_from_rows(bits.u32(btab_all[b]), flat)
    return start.reshape(B, G), count.reshape(B, G)


def probe_hash(btab: torch.Tensor, rids: torch.Tensor, queries: torch.Tensor,
               max_candidates: int):
    """Hash-probe int32-pattern keys: (cand, valid) of shape
    (*queries.shape, max_candidates). ``rids`` is the flat (n,) CSR payload
    or the (n/8, 16) pair rows of pairs_from_rids."""
    start, count = probe_meta(btab, queries)
    start = start.reshape(-1).to(torch.int64)
    count = count.reshape(-1)
    dev = rids.device
    offs = torch.arange(max_candidates, dtype=torch.int64, device=dev)
    valid = offs[None, :] < count.clamp(max=max_candidates)[:, None]
    if rids.ndim == 2 or (max_candidates <= 8 and rids.shape[0] % 8 == 0):
        if rids.ndim == 2:
            # overlapping pair rows: one gather covers [start & ~7, +16)
            nrows = rids.shape[0]
            both = rids[(start >> 3).clamp(0, nrows - 1)]
        else:
            # two contiguous 8-wide row gathers
            r2d = rids.reshape(-1, 8)
            nrows = r2d.shape[0]
            b0 = (start >> 3).clamp(0, nrows - 1)
            both = torch.cat([r2d[b0], r2d[(b0 + 1).clamp(max=nrows - 1)]],
                             dim=-1)
        cand = torch.gather(both, 1, (start & 7)[:, None] + offs[None, :])
    else:
        n = rids.shape[0]
        cand = rids[(start[:, None] + offs[None, :]).clamp(max=n - 1)]
    shape = (*queries.shape, max_candidates)
    return cand.reshape(shape), valid.reshape(shape)
