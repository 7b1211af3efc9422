"""The short-mode block format through pipeline/blocks.py: blocks made
here, on a random consensus, go through the port's codec pool into
members, and decoding the members gives back every read, length, id and
quality they were made from. spring_tpu's decoder reads the same members
to the same arrays. One PE case for each pair flag 0-4 (flag 1: mates
32,767 or more bases apart, which the port's small test genomes never
give), and one SE case with aligned and literal reads. Tolerance: exact."""
import numpy as np
import pytest

pytest.importorskip("jax")

from spring_tpu.pipeline import short_mode as jshort  # noqa: E402
from spring_tpu_torch import params as P  # noqa: E402
from spring_tpu_torch.codecs import bsc  # noqa: E402
from spring_tpu_torch.encode import consensus as cons  # noqa: E402
from spring_tpu_torch.encode import streams as st  # noqa: E402
from spring_tpu_torch.io import packing  # noqa: E402
from spring_tpu_torch.io.ids import find_id_pattern, modify_id  # noqa: E402
from spring_tpu_torch.pipeline import blocks, qualstream  # noqa: E402

SEQ_LEN = 40_000        # room for mates 32,767 bases and more apart
BLOCK = 16              # reads (SE) or pairs (PE) a block: two blocks
RECORDS = 24
ML = 100


class _Members(dict):
    """Archive members in memory: the writer the pool adds to, and the
    reader the decoders take."""

    def add(self, name, data):
        self[name] = data

    def get(self, name):
        return self[name]

    def get_block(self, stream, b):
        return self[f"{stream}.{b}"]


def _read(rng, seq, gpos, rc, length):
    """The consensus window at gpos with a few substitutions, reverse
    complemented under rc."""
    codes = seq[gpos:gpos + length].copy()
    at = rng.choice(length, size=rng.integers(0, 4), replace=False)
    codes[at] = (codes[at] + rng.integers(1, 4, len(at))) % 4
    return packing.COMP[codes[::-1]] if rc else codes


def _mates(rng, flag):
    """Positions of two aligned mates under pair flag 0 (near) or 1."""
    if flag == 0:
        g1 = int(rng.integers(0, SEQ_LEN - 2 * ML))
        return g1, g1 + int(rng.integers(-g1, ML))
    g1 = int(rng.integers(0, SEQ_LEN - 32_767 - ML))
    g2 = g1 + int(rng.integers(32_767, SEQ_LEN - ML - g1))
    return (g1, g2) if rng.integers(2) else (g2, g1)


def _block_data(paired, flag, seed):
    """The reads (file 1 then file 2 for PE), their placements (gpos -1:
    literal), ids, qualities and the consensus."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, SEQ_LEN, dtype=np.uint8)
    n = 2 * RECORDS if paired else RECORDS
    gpos = np.full(n, -1, np.int64)
    rc = rng.integers(0, 2, n).astype(np.uint8)
    if paired:
        # the case's flag on two pairs of three, every flag on the rest
        flags = [flag if i % 3 else i % 5 for i in range(RECORDS)]
        for i, f in enumerate(flags):
            if f in (0, 1):
                gpos[i], gpos[RECORDS + i] = _mates(rng, f)
            elif f in (3, 4):
                gpos[i if f == 3 else RECORDS + i] = rng.integers(
                    0, SEQ_LEN - ML)
    else:
        flags = None
        on = rng.random(n) < 0.6
        gpos[on] = rng.integers(0, SEQ_LEN - ML, int(on.sum()))
    lengths = rng.integers(60, ML + 1, n).astype(np.int32)
    codes = np.zeros((n, ML), np.uint8)
    for r in range(n):
        if gpos[r] >= 0:
            codes[r, :lengths[r]] = _read(rng, seq, gpos[r], rc[r],
                                         lengths[r])
        else:
            codes[r, :lengths[r]] = rng.integers(0, 4, lengths[r])
    lit = np.nonzero(gpos < 0)[0]
    codes[lit[0], 3] = packing.N          # an N in a literal read
    names = [f"@SYN.{seed}.{k}".encode() for k in rng.permutation(n)]
    ids = ([m + b"/1" for m in names[:RECORDS]]
           + [m + b"/2" for m in names[:RECORDS]] if paired else names)
    quals = rng.integers(33, 75, (n, ML)).astype(np.uint8)
    return seq, codes, lengths, gpos, rc, ids, quals, flags


def _encode(tmp_path, paired, flag, seed):
    seq, codes, lengths, gpos, rc, ids, quals, flags = _block_data(
        paired, flag, seed)
    n = len(lengths)
    per_file = RECORDS if paired else n
    cp = P.CompressionParams(num_reads_per_block=BLOCK, paired_end=paired)
    if paired and flag % 2 == 0:
        # even flags: file-2 ids derive from file-1 ids
        code = find_id_pattern(ids[0], ids[RECORDS])
        assert code
        ids[RECORDS:] = [modify_id(i, code) for i in ids[:RECORDS]]
        cp.paired_id_match, cp.paired_id_code = True, code
    elif paired:
        ids[RECORDS:] = [i[:-2] + b"x/2" for i in ids[RECORDS:]]
    packed = packing.pack_codes(codes)
    overlay = cons.NOverlay.from_codes(codes)
    t = blocks.ReadTable(lengths, ML)
    al = np.nonzero(gpos >= 0)[0]
    nn, npos, nchar = cons.extract_noise_packed(
        cons.ContigLayout(rids=al.astype(np.int32), gpos=gpos[al],
                          rc=rc[al], seq_len=SEQ_LEN),
        seq, packed, lengths, overlay)
    t.place(al, gpos[al], rc[al], nn, npos, nchar)
    # PE: the literals gathered into the side table; SE: unpacked per block
    assert t.take_literals(packed, overlay,
                           n * ML if paired else 0) is paired
    idlens = np.array([len(i) for i in ids], np.uint32)
    idbuf = np.frombuffer(b"".join(ids), np.uint8)
    idoffs = np.concatenate([[0], np.cumsum(idlens.astype(np.int64))])
    spool = qualstream.QualSpool(n, ML, dir=str(tmp_path))
    spool.write(0, quals)
    heads = np.random.default_rng(seed + 1).permutation(per_file)
    members = _Members()
    pool = blocks.CodecPool(members, num_threads=3, spool=spool)
    pool.submit(blocks.SEQ, pool.bsc, blocks.seq_member(seq))
    blocks.submit_ids(pool, heads, cp, per_file, (idbuf, idoffs, idlens))
    pool.start_quality(blocks.quality_sels(heads, cp, per_file), lengths, cp)
    blocks.submit_read_streams(pool, t, heads, BLOCK,
                               per_file if paired else None)
    pool.join_quality()
    pool.finish()
    return members, cp, heads, (codes, lengths, ids, quals, flags, seq)


def _check_half(half, rows, codes, lengths, ids, quals):
    idbuf, idlens, chars, rlen, qmat = half
    assert list(rlen) == list(lengths[rows])
    assert idbuf.tobytes() == b"".join(ids[r] for r in rows)
    assert list(idlens) == [len(ids[r]) for r in rows]
    for i, r in enumerate(rows):
        want = packing.CODE_TO_CHAR[codes[r, :lengths[r]]]
        np.testing.assert_array_equal(chars[i, :lengths[r]], want)
        np.testing.assert_array_equal(qmat[i, :lengths[r]],
                                      quals[r, :lengths[r]])


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flag", range(5))
def test_pair_block_round_trip(tmp_path, flag):
    members, cp, heads, (codes, lengths, ids, quals, flags, seq) = _encode(
        tmp_path, True, flag, seed=40 + flag)
    np.testing.assert_array_equal(blocks.decode_seq(members), seq)
    for b, p1 in enumerate(blocks.block_heads(heads, BLOCK)):
        got = st.decode_u8(bsc.decompress(members[f"flag.{b}"]))
        np.testing.assert_array_equal(got, [flags[p] for p in p1])
        halves = blocks.decode_block_pe(members, cp, b, seq, RECORDS)
        for j, half in enumerate(halves):
            _check_half(half, p1 + j * RECORDS, codes, lengths, ids, quals)
        _same(jshort._decode_block_pe(members, cp, b, seq, RECORDS), halves)


def test_se_block_round_trip(tmp_path):
    members, cp, heads, (codes, lengths, ids, quals, _f, seq) = _encode(
        tmp_path, False, None, seed=50)
    for b, sel in enumerate(blocks.block_heads(heads, BLOCK)):
        flag = st.decode_u8(bsc.decompress(members[f"flag.{b}"]))
        assert 0 < flag.sum() < len(sel)    # aligned and literal reads
        half = blocks.decode_block(members, cp, b, seq)
        _check_half(half, sel, codes, lengths, ids, quals)
        _same(jshort._decode_block(members, cp, b, seq, RECORDS), half)
