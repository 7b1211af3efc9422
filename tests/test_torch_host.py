"""The port's own host layer (spring_tpu_torch/{params,codecs,io,encode,
pipeline,utils}) against the spring_tpu modules it was copied from, on the
same numpy inputs made from a seed. Tolerance: exact (equal bytes, equal
arrays). Each package loads its own native library; both are live in this
process."""
import dataclasses
import filecmp
import gzip

import numpy as np
import pytest

pytest.importorskip("jax")

from spring_tpu import params as jP  # noqa: E402
from spring_tpu.codecs import bsc as jbsc  # noqa: E402
from spring_tpu.codecs import idcodec as jidc  # noqa: E402
from spring_tpu.codecs import native as jnative  # noqa: E402
from spring_tpu.codecs import qv as jqv  # noqa: E402
from spring_tpu.encode import streams as jst  # noqa: E402
from spring_tpu.io import container as jcont  # noqa: E402
from spring_tpu.io import fastq as jfastq  # noqa: E402
from spring_tpu.io import fastq_native as jfqn  # noqa: E402
from spring_tpu.io import ids as jids  # noqa: E402
from spring_tpu.io import packing as jpack  # noqa: E402
from spring_tpu.pipeline import quality as jqual  # noqa: E402
from spring_tpu.pipeline import qvz as jqvz  # noqa: E402
from spring_tpu.utils import synth as jsynth  # noqa: E402
from spring_tpu_torch import params as tP  # noqa: E402
from spring_tpu_torch.codecs import bsc as tbsc  # noqa: E402
from spring_tpu_torch.codecs import idcodec as tidc  # noqa: E402
from spring_tpu_torch.codecs import native as tnative  # noqa: E402
from spring_tpu_torch.codecs import qv as tqv  # noqa: E402
from spring_tpu_torch.encode import streams as tst  # noqa: E402
from spring_tpu_torch.io import container as tcont  # noqa: E402
from spring_tpu_torch.io import fastq as tfastq  # noqa: E402
from spring_tpu_torch.io import fastq_native as tfqn  # noqa: E402
from spring_tpu_torch.io import ids as tids  # noqa: E402
from spring_tpu_torch.io import packing as tpack  # noqa: E402
from spring_tpu_torch.pipeline import quality as tqual  # noqa: E402
from spring_tpu_torch.pipeline import qvz as tqvz  # noqa: E402
from spring_tpu_torch.utils import synth as tsynth  # noqa: E402


def test_two_native_libraries_side_by_side():
    """The port builds csrc/host into a library of its own; it is not the
    JAX package's, and both stay usable in one process."""
    jl, tl = jnative.load(), tnative.load()
    assert jl._name != tl._name
    assert "spring_tpu_torch" in tl._name
    assert "libspringtpu" not in tl._name
    assert jl.stpu_fastq_ckpt_stride() == tl.stpu_fastq_ckpt_stride()


def test_params_equal():
    consts = [k for k in vars(jP) if k.isupper()]
    assert consts and consts == [k for k in vars(tP) if k.isupper()]
    for k in consts:
        assert getattr(jP, k) == getattr(tP, k), k
    kw = dict(paired_end=True, num_reads=12345, quality_mode="qvz",
              shard_reads=(8192, 4153))
    jcp, tcp = jP.CompressionParams(**kw), tP.CompressionParams(**kw)
    assert jcp.to_json() == tcp.to_json()
    assert (dataclasses.asdict(tP.CompressionParams.from_json(jcp.to_json()))
            == dataclasses.asdict(jcp))


def _payloads():
    rng = np.random.default_rng(1)
    text = b"".join(b"@SRR554369.%d %d/1\n" % (i, i) for i in range(3000))
    return {
        "empty": b"",
        "one": b"A",
        "random": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "skewed": rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000,
                             p=[0.7, 0.1, 0.1, 0.1]).tobytes(),
        "text": text,
    }


@pytest.mark.parametrize("name", list(_payloads()))
def test_bsc_bytes_equal_and_cross_decode(name):
    raw = _payloads()[name]
    # a small block size makes the multi-block framing run too
    for kw in ({}, {"block_size": 1 << 15, "num_threads": 2}):
        cj, ct = jbsc.compress(raw, **kw), tbsc.compress(raw, **kw)
        assert cj == ct
        assert tbsc.decompress(cj) == raw
        assert jbsc.decompress(ct, num_threads=2) == raw


def test_bsc_array_forms_equal():
    rng = np.random.default_rng(2)
    strings = [rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                          int(rng.integers(0, 150))).tobytes()
               for _ in range(500)]
    cj = jbsc.compress_str_array(strings)
    assert cj == tbsc.compress_str_array(strings)
    assert tbsc.decompress_str_array(cj) == strings
    dj = jbsc.compress_dna_str_array(strings)
    assert dj == tbsc.compress_dna_str_array(strings)
    assert tbsc.decompress_dna_str_array(dj) == strings
    lens = rng.integers(1, 101, 400).astype(np.int32)
    mat = rng.integers(33, 74, (400, 100)).astype(np.uint8)
    rj = jbsc.compress_rows(mat, lens)
    assert rj == tbsc.compress_rows(mat, lens)
    mj, lj = jbsc.decompress_rows(rj, max_len=100)
    mt, lt = tbsc.decompress_rows(rj, max_len=100)
    assert np.array_equal(mj, mt) and np.array_equal(lj, lt)
    arr = rng.integers(0, 2**31, 5000).astype(np.uint32)
    aj = jbsc.compress_array(arr)
    assert aj == tbsc.compress_array(arr)
    assert np.array_equal(tbsc.decompress_array(aj, np.uint32), arr)


@pytest.mark.parametrize("style", ["affine", "sra", "illumina"])
def test_idcodec_bytes_equal_and_cross_decode(style):
    if style == "affine":
        ids = [b"@SRR554369.%d %d/1" % (i + 1, i + 1) for i in range(2000)]
    elif style == "sra":
        ids = [b"@ERR174310.%d HSQ1008_141:5:1101:%d:%d/1"
               % (i, 1200 + 7 * i % 9000, (i * 37) % 100_000)
               for i in range(2000)]
    else:
        rng = np.random.default_rng(3)
        ids = [b"@M0:1:FC:1:%d:%d:%d 1:N:0:ACGT" % tuple(
            rng.integers(1, 30000, 3)) for _ in range(2000)]
    cj = jidc.compress_ids(ids)
    assert cj == tidc.compress_ids(ids)
    assert tidc.decompress_ids(cj, len(ids)) == ids
    buf = np.frombuffer(b"".join(ids), np.uint8)
    lens = np.fromiter((len(i) for i in ids), np.uint32, len(ids))
    rj = jidc.compress_ids_raw(buf, lens)
    assert rj == tidc.compress_ids_raw(buf, lens) == cj
    bj, lj = jidc.decompress_ids_raw(rj, len(ids))
    bt, lt = tidc.decompress_ids_raw(rj, len(ids))
    assert np.array_equal(bj, bt) and np.array_equal(lj, lt)
    assert np.array_equal(bt, buf) and np.array_equal(lt, lens)


@pytest.mark.parametrize("fine_pos", [False, True])
def test_qv_bytes_equal_and_cross_decode(fine_pos):
    rng = np.random.default_rng(4)
    n, L = 3000, 100
    lens = rng.integers(20, L + 1, n).astype(np.int32)
    levels = np.array([2, 14, 21, 27, 32, 36, 39, 40], np.uint8) + 33
    mat = levels[np.clip(rng.normal(5, 2, (n, L)), 0, 7).astype(np.int64)]
    cj = jqv.compress_rows(mat, lens, 2, fine_pos)
    ct = tqv.compress_rows(mat, lens, 2, fine_pos)
    assert cj == ct
    mj, lj = jqv.decompress_rows(ct, max_len=L)
    mt, lt = tqv.decompress_rows(cj, max_len=L, num_threads=2)
    assert np.array_equal(mj, mt) and np.array_equal(lj, lt)
    valid = np.arange(L)[None, :] < lens[:, None]
    assert np.array_equal(mt[valid], mat[valid])
    strings = [mat[i, :lens[i]].tobytes() for i in range(200)]
    sj = jqv.compress_str_array(strings)
    assert sj == tqv.compress_str_array(strings)
    assert tqv.decompress_str_array(sj) == strings


def test_packing_equal():
    rng = np.random.default_rng(5)
    n, L = 300, 100
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    pj, pt = jpack.pack_codes(codes), tpack.pack_codes(codes)
    assert pj.dtype == pt.dtype and np.array_equal(pj, pt)
    assert np.array_equal(tpack.unpack_codes(pt, L), codes)
    assert np.array_equal(tfqn.pack_2bit(codes), pj)
    assert np.array_equal(tfqn.unpack_2bit(pt, L), jfqn.unpack_2bit(pj, L))
    c5 = rng.integers(0, 5, (n, L)).astype(np.uint8)
    assert np.array_equal(jpack.pack_codes_4bit(c5),
                          tpack.pack_codes_4bit(c5))
    assert np.array_equal(
        tpack.unpack_codes_4bit(tpack.pack_codes_4bit(c5), L), c5)
    assert np.array_equal(jpack.revcomp_codes(c5, lens),
                          tpack.revcomp_codes(c5, lens))
    bj = jpack.codes_to_bitstream_2bit(codes, lens)
    assert bj == tpack.codes_to_bitstream_2bit(codes, lens)
    tot = int(lens.sum())
    assert np.array_equal(jpack.bitstream_2bit_to_flat(bj, tot),
                          tpack.bitstream_2bit_to_flat(bj, tot))
    reads = [b"ACGTNACGT", b"", b"NNNN", b"GATTACA" * 9]
    cj, lj = jpack.strings_to_codes(reads, 70)
    ct, lt = tpack.strings_to_codes(reads, 70)
    assert np.array_equal(cj, ct) and np.array_equal(lj, lt)
    assert tpack.codes_to_strings(ct, lt) == jpack.codes_to_strings(cj, lj)
    assert np.array_equal(jpack.CODE_TO_CHAR, tpack.CODE_TO_CHAR)


def test_streams_equal():
    rng = np.random.default_rng(6)
    pos = np.sort(rng.integers(0, 5_000_000, 4000)).astype(np.int32)
    pos[100] = pos[99] + 200_000            # a delta that escapes 16 bits
    ej = jst.encode_deltas_u16(pos)
    assert ej == tst.encode_deltas_u16(pos)
    assert np.array_equal(tst.decode_deltas_u16(ej), pos)
    u16 = rng.integers(0, 65536, 1000).astype(np.uint16)
    assert jst.encode_u16(u16) == tst.encode_u16(u16)
    assert np.array_equal(tst.decode_u16(jst.encode_u16(u16)),
                          jst.decode_u16(jst.encode_u16(u16)))
    u8 = rng.integers(0, 256, 1000).astype(np.uint8)
    assert jst.encode_u8(u8) == tst.encode_u8(u8)
    v = rng.integers(-1000, 1000, 500)
    assert np.array_equal(jst.zigzag(v), tst.zigzag(v))
    assert np.array_equal(tst.unzigzag(tst.zigzag(v)), v)


def test_id_patterns_equal():
    pairs = [(b"@r.1 1/1", b"@r.1 1/2"), (b"@x/1", b"@x/2"),
             (b"@a 1:N:0", b"@a 2:N:0"), (b"@same", b"@same"),
             (b"@a", b"@b"), (b"@r.7 7/1", b"@r.8 8/2")]
    for a, b in pairs:
        code = jids.find_id_pattern(a, b)
        assert code == tids.find_id_pattern(a, b)
        for c in (1, 2, 3):
            assert (jids.check_id_pattern(a, b, c)
                    == tids.check_id_pattern(a, b, c))
        if code:
            assert jids.modify_id(a, code) == tids.modify_id(a, code) == b


def _pe_ids(code, n):
    """n pairs of ids that match ``code``, of mixed lengths."""
    pad = [b"x" * (i % 23) for i in range(n)]
    if code == 1:
        return ([b"@r.%d%s/1" % (i, pad[i]) for i in range(n)],
                [b"@r.%d%s/2" % (i, pad[i]) for i in range(n)])
    if code == 2:
        ids = [b"@r.%d %s" % (i, pad[i]) for i in range(n)]
        return ids, list(ids)
    return ([b"@r.%d 1:N:%s" % (i, pad[i]) for i in range(n)],
            [b"@r.%d 2:N:%s" % (i, pad[i]) for i in range(n)])


@pytest.mark.parametrize("code,n,swap", [
    (1, 64, {}), (2, 64, {}), (3, 64, {}),
    (1, 64, {1: (b"@r.1/1", b"@r.2/2")}),
    (3, 64, {32: (b"@a 1:N", b"@b 2:N")}),
    (2, 64, {63: (b"@x", b"@y")}),
    (2, 64, {10: (b"@same", b"@same.")}),
    (1, 64, {10: (b"@r.10/1", b"@r.10//2")}),
    (3, 64, {40: (b"@nospace1", b"@nospace2")}),
    (3, 64, {40: (b"@r.40 ", b"@r.40 ")}),
    (3, 64, {50: (b"@r.50 1:N:A", b"@r.50 2:N:B")}),
    (1, 64, {20: (b"", b"")}),
    (2, 64, {20: (b"", b"")}),
    (1, 1, {}),
    (3, 1, {0: (b"@a 1", b"@a 3")}),
    (1, 300, {150: (b"@r.150" + b"y" * 200 + b"/1",
                    b"@r.150" + b"y" * 200 + b"/2"),
              299: (b"@r/1", b"@r/1")}),
], ids=["code1", "code2", "code3", "pair1", "middle", "last",
        "length_only", "length_only_code1", "code3_no_space",
        "code3_space_last", "code3_tail", "empty_code1", "empty_code2",
        "per_file_1", "per_file_1_fails", "mixed_lengths"])
def test_pe_id_first_mismatch_equals_per_pair_check(code, n, swap):
    ids1, ids2 = _pe_ids(code, n)
    for i, (a, b) in swap.items():
        ids1[i], ids2[i] = a, b
    want = next((i for i in range(n)
                 if not jids.check_id_pattern(ids1[i], ids2[i], code)), n)
    allids = ids1 + ids2
    idbuf = np.frombuffer(b"".join(allids), np.uint8)
    idoffs = np.concatenate(
        [[0], np.cumsum([len(x) for x in allids])]).astype(np.int64)
    assert tfqn.pe_id_first_mismatch(idbuf, idoffs, n, code) == want
    with pytest.raises(ValueError):
        tfqn.pe_id_first_mismatch(idbuf, idoffs, n, 4)


@pytest.mark.parametrize("kind", ["fastq", "fastq_n_varlen", "fasta", "gz"])
def test_fastq_native_scan_and_parse_equal(tmp_path, kind):
    fq = str(tmp_path / "in.fastq")
    n = 5000                     # past one 4096-record checkpoint
    if kind == "fastq_n_varlen":
        tsynth.make_se(fq, n, genome_size=30_000, seed=8, n_rate=0.002,
                       len_range=(40, 100))
    else:
        tsynth.make_se(fq, n, read_len=100, genome_size=30_000, seed=8)
    fasta = kind == "fasta"
    path = fq
    if fasta:
        path = str(tmp_path / "in.fasta")
        with open(fq, "rb") as f, open(path, "wb") as o:
            lines = f.read().split(b"\n")
            for i in range(0, len(lines) - 1, 4):
                o.write(b">" + lines[i][1:] + b"\n" + lines[i + 1] + b"\n")
    elif kind == "gz":
        path = fq + ".gz"
        with open(fq, "rb") as f, gzip.open(path, "wb") as o:
            o.write(f.read())
    bj, bt = jfqn.open_buf(path), tfqn.open_buf(path)
    assert np.array_equal(bj, bt)
    ij = jfqn.scan_buf(bj, path, fasta=fasta)
    it = tfqn.scan_buf(bt, path, fasta=fasta)
    assert (ij.n, ij.maxlen, ij.idbytes) == (it.n, it.maxlen, it.idbytes)
    assert it.n == n
    assert np.array_equal(ij.ckpt_byte, it.ckpt_byte)
    assert np.array_equal(ij.ckpt_id, it.ckpt_id)
    ml = it.maxlen
    W = -(-ml // 16)

    def parse(mod, buf, info):
        packed = np.zeros((n, W), np.uint32)
        lengths = np.empty(n, np.int32)
        quals = None if fasta else np.zeros((n, ml), np.uint8)
        idbuf = np.empty(info.idbytes, np.uint8)
        idlens = np.empty(n, np.uint32)
        exc = mod.parse_packed_into(buf, path, info, ml, packed, lengths,
                                    quals, idbuf, idlens, fasta=fasta,
                                    num_threads=2)
        # the parser's threads append the (read, position) N records in
        # no fixed order: compare them sorted
        exc = exc[np.lexsort((exc[:, 1], exc[:, 0]))]
        return packed, lengths, quals, idbuf, idlens, exc

    for a, b in zip(parse(jfqn, bj, ij), parse(tfqn, bt, it)):
        assert (a is None and b is None) or np.array_equal(a, b)
    aj = jfqn.load_file(path, fasta=fasta)
    at = tfqn.load_file(path, fasta=fasta)
    for f in ("codes", "lengths", "quals", "idbuf", "idlens"):
        a, b = getattr(aj, f), getattr(at, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    chars = tpack.CODE_TO_CHAR[at.codes]
    rj = jfqn.format_records(chars, aj.lengths, aj.quals,
                             aj.idbuf[:ij.idbytes], aj.idlens)
    rt = tfqn.format_records(chars, at.lengths, at.quals,
                             at.idbuf[:it.idbytes], at.idlens)
    assert rj == rt
    if not fasta:
        with open(fq, "rb") as f:
            assert rt == f.read()


def test_fastq_block_reader_and_writer_equal(tmp_path):
    fq = str(tmp_path / "in.fastq")
    tsynth.make_se(fq, 700, read_len=80, genome_size=9000, seed=9)
    bj = list(jfastq.read_blocks(fq, 256))
    bt = list(tfastq.read_blocks(fq, 256))
    assert len(bj) == len(bt) == 3
    for a, b in zip(bj, bt):
        assert (a.ids, a.seqs, a.quals) == (b.ids, b.seqs, b.quals)
    assert jfastq.count_reads(fq) == tfastq.count_reads(fq) == 700
    for gz in (False, True):
        oj, ot = str(tmp_path / f"j{gz}"), str(tmp_path / f"t{gz}")
        for mod, out, blocks in ((jfastq, oj, bj), (tfastq, ot, bt)):
            with mod.BlockWriter(out, gzipped=gz, num_threads=2) as w:
                for b in blocks:
                    w.write_block(b.ids, b.seqs, b.quals)
        assert filecmp.cmp(oj, ot, shallow=False)
        assert tfastq.is_gzipped(ot) == gz
        with (gzip.open(ot, "rb") if gz else open(ot, "rb")) as f, \
                open(fq, "rb") as g:
            assert f.read() == g.read()


def test_container_bytes_equal_and_cross_read(tmp_path):
    rng = np.random.default_rng(10)
    members = {f"{s}.{b}": rng.integers(0, 256, int(rng.integers(0, 5000)),
                                        dtype=np.uint8).tobytes()
               for b in (1, 0, 10, 2) for s in ("flag", "seq", "id")}
    members["sh0/params.json"] = b"{}"
    kw = dict(num_reads=99, num_blocks=3, max_readlen=100)
    for spooled in (False, True):
        pj = str(tmp_path / f"j{spooled}.stpu")
        pt = str(tmp_path / f"t{spooled}.stpu")
        for mod, P, path in ((jcont, jP, pj), (tcont, tP, pt)):
            with mod.ArchiveWriter(path, spooled=spooled) as w:
                for name, data in members.items():
                    w.add(name, data)
                w.finish(P.CompressionParams(**kw))
        assert filecmp.cmp(pj, pt, shallow=False)
        with jcont.ArchiveReader(pt) as rj, tcont.ArchiveReader(pj) as rt:
            assert list(rj.names()) == list(rt.names())
            assert rj.params.to_json() == rt.params.to_json()
            assert rj.size_by_prefix() == rt.size_by_prefix()
            for name, data in members.items():
                assert rt.get(name) == rj.get(name) == data
            assert rt.get_block("id", 10) == members["id.10"]
            assert rt.has_block("seq", 2) and not rt.has_block("seq", 3)


@pytest.mark.parametrize("mode,kw", [
    ("ill_bin", {}), ("binary", {"bin_thresholds": (53, 73, 35)})])
def test_quality_tables_equal(mode, kw):
    tj = jqual.make_table(mode, **kw)
    tt = tqual.make_table(mode, **kw)
    assert np.array_equal(tj, tt)
    rng = np.random.default_rng(11)
    mat = rng.integers(33, 74, (200, 60)).astype(np.uint8)
    lens = rng.integers(1, 61, 200).astype(np.int32)
    assert np.array_equal(jqual.quantize_matrix(mat.copy(), lens, tj),
                          tqual.quantize_matrix(mat.copy(), lens, tt))


@pytest.mark.parametrize("ratio", [1.0, 8.0])
def test_qvz_quantizer_equal(ratio):
    rng = np.random.default_rng(12)
    n, L = 800, 16      # >= 512 rows: per-context codebooks, not pooled
    mat = (np.clip(rng.normal(33, 6, (n, L)), 0, 40).astype(np.uint8) + 33)
    # fixed read length: with ragged rows both packages' quantizer can
    # index a context past the next column's alphabet (ROADMAP queue C)
    lens = np.full(n, L, np.int32)
    qj = jqvz.quantize_matrix(mat.copy(), lens, ratio)
    qt = tqvz.quantize_matrix(mat.copy(), lens, ratio)
    assert np.array_equal(qj, qt)
    quals = [mat[i, :lens[i]].tobytes() for i in range(100)]
    assert (jqvz.quantize_block(quals, ratio)
            == tqvz.quantize_block(quals, ratio))


@pytest.mark.parametrize("paired", [False, True])
def test_synth_files_equal(tmp_path, paired):
    kw = dict(read_len=100, genome_size=20_000, seed=13, n_rate=0.001)
    names = ["j1", "j2", "t1", "t2"]
    j1, j2, t1, t2 = (str(tmp_path / x) for x in names)
    if paired:
        jsynth.make_pe(j1, j2, 1500, **kw)
        tsynth.make_pe(t1, t2, 1500, **kw)
        assert filecmp.cmp(j2, t2, shallow=False)
    else:
        jsynth.make_se(j1, 1500, len_range=(50, 100), **kw)
        tsynth.make_se(t1, 1500, len_range=(50, 100), **kw)
    assert filecmp.cmp(j1, t1, shallow=False)
