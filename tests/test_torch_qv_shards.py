"""Quality coding one qv shard to a codec task (pipeline/qualstream.py's
``drive_quality_shards`` over codecs/qv.py's ``shard_plan``,
``compress_shard`` and ``frame_shards``), held against the JAX package: a
block's member is byte for byte spring_tpu's ``qv.compress_rows`` of its
table-mapped rows, whatever the rows, the alphabet, the table or the
order the shards finish in; through ``compress_short`` every quality
member equals spring_tpu's bin path (``drive_quality_bins``) over the
same blocks, qvz's included, the archive reads back, and
``LAST_RUN_STATS`` counts the shard tasks (or, under qvz, the bin path's
blocks); a shard that fails raises from the compress and no member of its
block is written."""
import collections
import os
import struct
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import records  # noqa: E402

from spring_tpu_torch import api  # noqa: E402
from spring_tpu_torch import params as P  # noqa: E402
from spring_tpu_torch.codecs import qv  # noqa: E402
from spring_tpu_torch.encode import second_chance as sc  # noqa: E402
from spring_tpu_torch.io.container import ArchiveReader  # noqa: E402
from spring_tpu_torch.io.container import ArchiveWriter  # noqa: E402
from spring_tpu_torch.pipeline import quality as qual_mod  # noqa: E402
from spring_tpu_torch.pipeline import qualstream  # noqa: E402
from spring_tpu_torch.reorder import engine as eng  # noqa: E402
from spring_tpu_torch.utils import spans, synth  # noqa: E402


THRESHOLDS = (20, 40, 10)      # -q binary's threshold, high and low


def _reference():
    """spring_tpu's quality codec, tables and bin path: the reference."""
    pytest.importorskip("jax")
    from spring_tpu.codecs import qv as ref_qv
    from spring_tpu.pipeline import quality as ref_quality
    from spring_tpu.pipeline import qualstream as ref_qualstream
    return ref_qv, ref_quality, ref_qualstream


def _levels(k: int) -> np.ndarray:
    return np.arange(33, 33 + 41, dtype=np.uint8)[
        np.linspace(0, 40, k).round().astype(int)]


def _case(name: str, rng):
    """(raw spool rows, lens of every spool row, quality mode, fine_pos,
    rows the block takes, expected S)."""
    ml, mode, fine_pos = 100, "lossless", False
    n, k, sel_n, S = 3000, 40, 2000, 1
    if name == "ragged":
        n, sel_n, S = 130_000, 120_000, 2
    elif name == "capped":
        n, k, sel_n, S = 700_000, 2, 700_000, 16
    elif name == "empty":
        sel_n = 0
    elif name == "levels8":
        k = 8
    elif name in ("ill_bin", "binary"):
        mode = name
    raw = _levels(k)[rng.integers(0, k, (n, ml), dtype=np.uint8)]
    lens = rng.integers(0, ml + 1, n).astype(np.int32)
    if name == "capped":
        lens[:] = ml
    if name == "const_prefix":
        raw[:] = raw[0]
        fine_pos = True
    raw[np.arange(ml)[None, :] >= lens[:, None]] = 0    # the parse's pad
    sel = rng.permutation(n)[:sel_n]
    if sel_n:
        sel[rng.integers(sel_n)] = n - 1    # the spool's last row
        sel = np.unique(sel)
        rng.shuffle(sel)
    return raw, lens, mode, fine_pos, sel, S


def _spool(tmp_path, raw: np.ndarray, module=qualstream):
    spool = module.QualSpool(*raw.shape, dir=str(tmp_path))
    half = len(raw) // 2
    spool.write(0, raw[:half])
    spool.write(half, raw[half:])
    return spool


@pytest.mark.parametrize("name", ["ragged", "one_shard", "capped", "empty",
                                  "const_prefix", "levels8", "levels40",
                                  "ill_bin", "binary"])
def test_shard_member_equals_compress_rows(name, tmp_path):
    ref_qv, ref_quality, _ = _reference()
    raw, lens, mode, fine_pos, sel, S = _case(name, np.random.default_rng(7))
    bl = lens[sel]
    rows = raw[sel]
    ref_table = ref_quality.make_table(mode, 8.0, THRESHOLDS)
    if ref_table is not None:
        rows = ref_quality.quantize_matrix(rows, bl, ref_table)
    want = ref_qv.compress_rows(rows, bl, 0, fine_pos)
    table = qual_mod.make_table(mode, 8.0, THRESHOLDS)
    spool = _spool(tmp_path, raw)
    try:
        spool.map()
        r0 = qv.shard_plan(bl)
        assert len(r0) - 1 == S and r0[0] == 0 and r0[-1] == len(sel)
        assert struct.unpack_from("<I", want)[0] == S
        with ThreadPoolExecutor(4) as ex:
            parts = list(ex.map(
                lambda ab: qv.compress_shard(
                    spool.address, spool.n, spool.ml, sel[ab[0]:ab[1]],
                    bl[ab[0]:ab[1]], table, fine_pos),
                zip(r0[:-1], r0[1:])))
        assert qv.frame_shards(parts) == want
    finally:
        spool.close()
    if name == "ragged":
        mat, got_lens = qv.decompress_rows(want, raw.shape[1])
        assert np.array_equal(got_lens, bl)
        assert np.array_equal(mat, raw[sel])


def test_drive_quality_shards_equals_the_bin_path(tmp_path):
    """Blocks of several shards on a pool of more threads than shards,
    switching often: each block's member is written once, by its last
    shard, and equals the reference's bin path."""
    _, ref_quality, ref_qualstream = _reference()
    raw, lens, _, _, _, _ = _case("ill_bin", np.random.default_rng(3))
    table = qual_mod.make_table("ill_bin")
    raw = np.concatenate([raw] * 80)
    lens = np.concatenate([lens] * 80)
    order = np.random.default_rng(4).permutation(len(raw))
    sels = [(f"quality.{b}", order[b * 100_000:(b + 1) * 100_000])
            for b in range(3)]          # ~5M, ~5M and ~2M chars
    spool = _spool(tmp_path, raw)
    got, attrs = {}, collections.defaultdict(list)
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(8) as ex:
            futs = []

            def sink(name, fn, *args, **a):
                attrs[name].append(a)

                def run():
                    data = fn(*args)
                    if data is not None:
                        with lock:
                            assert name not in got
                            got[name] = data
                futs.append(ex.submit(run))
            tasks = qualstream.drive_quality_shards(
                spool, sink, sels, lens, table)
            for f in futs:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
        spool.close()
    want = _reference_bins(tmp_path, raw, sels, lens, "ill_bin",
                           ref_quality.make_table("ill_bin"))
    assert got == want
    plans = [qv.shard_plan(lens[s]) for _, s in sels]
    assert tasks == sum(len(r) - 1 for r in plans) > len(sels)
    for (name, s), r in zip(sels, plans):
        a = attrs[name]
        assert [x["shard"] for x in a] == list(range(len(r) - 1))
        assert {x["shards"] for x in a} == {len(r) - 1}
        assert [x["rows"] for x in a] == list(np.diff(r))
        assert sum(x["chars"] for x in a) == int(lens[s].sum())


def _reference_bins(tmp_path, raw, sels, lengths, mode, ref_table,
                    qvz_ratio=8.0) -> dict:
    """The members spring_tpu's bin path codes of ``raw``'s rows in the
    blocks ``sels``."""
    _, _, ref_qualstream = _reference()
    want = {}
    spool = _spool(tmp_path, raw, ref_qualstream)
    try:
        ref_qualstream.drive_quality_bins(
            spool, lambda name, fn, *a: want.__setitem__(name, fn(*a)),
            sels, lengths, mode, ref_table, qvz_ratio, mode == "qvz", 4)
    finally:
        spool.close()
    return want


# ---- through compress_short: tiny synth inputs, blocks of 64 reads ----

BLOCK = 64
TWO_LEVELS = bytes(35 if c < 55 else 73 for c in range(256))    # '#', 'I'
CELLS = [(paired, flags) for paired in (True, False)
         for flags in ("default", "r", "r_noids")]
LOSSY = [(True, "r", "ill_bin"), (False, "default", "binary")]


def _qualities(files: list, ml: int) -> np.ndarray:
    """The inputs' quality rows in the spool's index space (file 1, then
    file 2), zero-padded to ml."""
    rows = []
    for f in files:
        with open(f, "rb") as fh:
            rows += fh.read().split(b"\n")[3::4]
    out = np.zeros((len(rows), ml), np.uint8)
    for i, q in enumerate(rows):
        out[i, :len(q)] = np.frombuffer(q, np.uint8)
    return out


def _compress(files, arc, opts, monkeypatch):
    """api.compress on the CPU in blocks of BLOCK reads, the arguments of
    each drive_quality_* call and the codec spans of the compress."""
    calls = []
    for fn in ("drive_quality_shards", "drive_quality_bins"):
        real = getattr(qualstream, fn)

        def spy(spool, sink, sels, lengths, *rest, _real=real, _fn=fn):
            calls.append((_fn, sels, np.array(lengths), rest))
            return _real(spool, sink, sels, lengths, *rest)
        monkeypatch.setattr(qualstream, fn, spy)
    params = P.CompressionParams
    with monkeypatch.context() as mp:
        # the matchers pad their consensus words to SEG_BASES (2^24 by
        # default, seconds a call here)
        mp.setattr(sc, "SEG_BASES", 1 << 14)
        mp.setattr(P, "CompressionParams",
                   lambda **kw: params(num_reads_per_block=BLOCK, **kw))
        api.compress(files, arc, opts, device="cpu")
    last = spans.context()[0]
    codec = [s for s in spans.spans() if s.compress == last
             and s.name == "codec" and s.attrs["family"] == "quality"]
    return calls, dict(eng.LAST_RUN_STATS), codec


def _members(arc: str) -> dict:
    with ArchiveReader(arc) as r:
        return {m: r.get(m) for m in r.names() if m.startswith("quality.")}


def _inputs(tmp_path, paired: bool) -> list:
    files = [str(tmp_path / f"in_{m}.fq") for m in (1, 2)[:1 + paired]]
    if paired:
        synth.make_pe(*files, 150, genome_size=1500, seed=11,
                      qual_levels=40, len_range=(60, 100))
    else:
        synth.make_se(files[0], 300, genome_size=1500, seed=12,
                      qual_levels=40, len_range=(60, 100))
    return files


def _check_members(tmp_path, monkeypatch, paired: bool, flags: str,
                   mode: str) -> None:
    """Compress under ``flags`` and ``mode``: every quality member equals
    the reference's, one shard task a shard, and the archive reads
    back."""
    _, ref_quality, _ = _reference()
    files = _inputs(tmp_path, paired)
    opts = api.CompressOptions(num_threads=3, verbose=False,
                               reorder=flags != "default",
                               preserve_id=flags != "r_noids",
                               quality_mode=mode, bin_thresholds=THRESHOLDS)
    arc = str(tmp_path / "a.stpu")
    calls, stats, codec = _compress(files, arc, opts, monkeypatch)
    (fn, sels, lengths, (table,)), = calls
    assert fn == "drive_quality_shards"
    want_table = qual_mod.make_table(mode, 8.0, THRESHOLDS)
    assert (table is None) == (want_table is None)
    assert table is None or np.array_equal(table, want_table)
    got = _members(arc)
    want = _reference_bins(tmp_path, _qualities(files, int(lengths.max())),
                           sels, lengths, mode,
                           ref_quality.make_table(mode, 8.0, THRESHOLDS))
    assert len(sels) == (3 if paired else 5)
    assert got == want
    shards = sum(struct.unpack_from("<I", m)[0] for m in got.values())
    assert stats["quality_shard_tasks"] == shards == len(codec)
    assert stats["quality_bin_blocks"] == 0
    for s in codec:
        assert (s.attrs["shards"], s.attrs["shard"]) == (1, 0)
        assert s.attrs["chars"] > 0 and s.attrs["rows"] > 0
    outs = [str(tmp_path / f"out_{m}.fq") for m in (1, 2)[:1 + paired]]
    api.decompress(arc, outs, num_threads=2, verbose=False)
    faults = records.compare(files, outs, {
        "order": flags == "default", "ids": flags != "r_noids",
        "qualities": mode == "lossless"})
    assert faults and not any(faults.values()), faults


@pytest.mark.parametrize("paired,flags", CELLS)
def test_compress_members_equal_the_bin_path(paired, flags, tmp_path,
                                             monkeypatch):
    _check_members(tmp_path, monkeypatch, paired, flags, "lossless")


@pytest.mark.parametrize("paired,flags,mode", LOSSY)
def test_binned_compress_members_equal_the_bin_path(paired, flags, mode,
                                                    tmp_path, monkeypatch):
    _check_members(tmp_path, monkeypatch, paired, flags, mode)


def test_qvz_keeps_the_bin_path(tmp_path, monkeypatch):
    files = [str(tmp_path / f"in_{m}.fq") for m in (1, 2)]
    synth.make_pe(*files, 150, genome_size=1500, seed=13, qual_levels=40)
    for f in files:
        # two levels: qvz trains its codebooks in seconds a level here
        with open(f, "rb") as fh:
            lines = fh.read().split(b"\n")
        lines[3::4] = [q.translate(TWO_LEVELS) for q in lines[3::4]]
        with open(f, "wb") as fh:
            fh.write(b"\n".join(lines))
    arc = str(tmp_path / "a.stpu")
    calls, stats, codec = _compress(
        files, arc, api.CompressOptions(num_threads=3, verbose=False,
                                        quality_mode="qvz"), monkeypatch)
    (fn, sels, lengths, (qvz_ratio, _)), = calls
    assert fn == "drive_quality_bins"
    got = _members(arc)
    assert got == _reference_bins(
        tmp_path, _qualities(files, int(lengths.max())), sels, lengths,
        "qvz", None, qvz_ratio)
    assert stats["quality_shard_tasks"] == 0
    assert stats["quality_bin_blocks"] == len(got) == len(codec) > 1
    assert not any("shard" in s.attrs for s in codec)


def test_failing_shard_raises_and_writes_no_member(tmp_path, monkeypatch):
    """A spool that claims a row fewer than the plan reads: the shard
    that holds the last row fails, compress_short raises, and the block
    of that shard has no member while every member written is whole."""
    files = [str(tmp_path / f"in_{m}.fq") for m in (1, 2)]
    synth.make_pe(*files, 150, genome_size=1500, seed=14, qual_levels=40)
    real_map = qualstream.QualSpool.map

    def short_map(self):
        real_map(self)
        self.n -= 1
    monkeypatch.setattr(qualstream.QualSpool, "map", short_map)
    added = {}
    real_add = ArchiveWriter.add

    def add(self, name, data):
        added[name] = data
        real_add(self, name, data)
    monkeypatch.setattr(ArchiveWriter, "add", add)
    with pytest.raises(RuntimeError, match=r"qv shard failed \(-5\)"):
        _compress(files, str(tmp_path / "a.stpu"),
                  api.CompressOptions(num_threads=3, verbose=False),
                  monkeypatch)
    last = (300 - 1) // 2 // BLOCK     # file 2's last row: the last block
    assert f"quality.{last}" not in added
    for name, data in added.items():
        if name.startswith("quality."):
            mat, lens = qv.decompress_rows(data)
            assert len(lens) == 2 * BLOCK


def test_a_failure_while_submitting_raises_from_the_compress(tmp_path,
                                                             monkeypatch):
    """The submitting thread's own failure (here the plan of the second
    block) is raised by compress_short, not lost with the thread."""
    files = [str(tmp_path / f"in_{m}.fq") for m in (1, 2)]
    synth.make_pe(*files, 150, genome_size=1500, seed=15, qual_levels=40)
    real_plan = qv.shard_plan
    plans = []

    def plan(lens):
        plans.append(len(lens))
        if len(plans) == 2:
            raise ValueError("plan refused")
        return real_plan(lens)
    monkeypatch.setattr(qv, "shard_plan", plan)
    with pytest.raises(ValueError, match="plan refused"):
        _compress(files, str(tmp_path / "a.stpu"),
                  api.CompressOptions(num_threads=3, verbose=False,
                                      reorder=True), monkeypatch)
    assert plans == [2 * BLOCK, 2 * BLOCK]
