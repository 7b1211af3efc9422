"""Device dictionary build and probes: spring_tpu_torch.reorder.dictionary
against spring_tpu.reorder.dictionary (JAX on CPU). Exact equality of
btab, sorted keys, rids, dropped counts and probe answers."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from spring_tpu.io import packing  # noqa: E402
from spring_tpu.reorder import dictionary as jdct  # noqa: E402
from spring_tpu_torch import convert  # noqa: E402
from spring_tpu_torch.reorder import dictionary as tdct  # noqa: E402


def _tt(a):
    """numpy -> the port's tensor, on the CPU (convert's default is the
    card)."""
    return convert.to_torch(a, "cpu")


def _np(a):
    return np.asarray(a)


def _rows(seed=7, n=3000, L=100):
    """Engine-layout rows (Np, W+1): packed reads + length word, bit 31 on
    padding, with duplicated windows (multi-entry bins) and short reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    codes[1000:1500] = codes[:500]
    codes[2000:2100] = codes[0]                  # one large bin
    lengths = np.full(n, L, np.int32)
    lengths[:50] = 40                            # too short for mid windows
    packed = packing.pack_codes(codes)
    W = packed.shape[1]
    Np = max(1 << max(n - 1, 1).bit_length(), 64)
    rows = np.zeros((Np, W + 1), np.uint32)
    rows[:n, :W] = packed
    lp = np.zeros(Np, np.int32)
    lp[:n] = lengths
    rows[:, W] = lp.view(np.uint32)
    rows[n:, W] |= np.uint32(1 << 31)
    return rows, n, jdct.default_windows(L)


def _assert_build_equal(t_out, j_out):
    tb, tk, tr, td = t_out
    jb, jk, jr, jd = j_out
    np.testing.assert_array_equal(convert.to_numpy(tb, uint32=True), _np(jb))
    np.testing.assert_array_equal(convert.to_numpy(tk, uint32=True), _np(jk))
    np.testing.assert_array_equal(convert.to_numpy(tr), _np(jr))
    assert int(td) == int(jd)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("window", [0, 1])
def test_build_hash_dict_dev(wide, window):
    rows, n, windows = _rows()
    S = jdct.table_buckets(rows.shape[0])
    start = windows[window].start
    j_out = jdct._build_hash_dict_dev(jnp.asarray(rows),
                                      jnp.asarray(n, jnp.int32), start, S,
                                      wide)
    t_out = tdct._build_hash_dict_dev(_tt(rows), n, start, S,
                                      wide)
    _assert_build_equal(t_out, j_out)


def test_build_drops_overflowing_keys():
    """A table far too small for its keys: bucket overflow must drop the
    same keys on both sides."""
    rows, n, windows = _rows(seed=8)
    S = 64
    j_out = jdct._build_hash_dict_dev(jnp.asarray(rows),
                                      jnp.asarray(n, jnp.int32),
                                      windows[0].start, S)
    t_out = tdct._build_hash_dict_dev(_tt(rows), n,
                                      windows[0].start, S)
    assert int(j_out[3]) > 0
    _assert_build_equal(t_out, j_out)


def test_build_hash_dicts_device_and_pairs():
    rows, n, windows = _rows(seed=9)
    jd = jdct.build_hash_dicts_device(jnp.asarray(rows), n, windows)
    td = tdct.build_hash_dicts_device(_tt(rows), n, windows)
    for a, b in zip(td, jd):
        got = convert.dict_to_numpy(a)
        np.testing.assert_array_equal(got["btab"], _np(b.btab))
        np.testing.assert_array_equal(got["rids"], _np(b.rids))
        np.testing.assert_array_equal(got["keys"], _np(b.keys_dev))
        assert got["dropped"] == int(b.dropped) and got["start"] == b.start
        np.testing.assert_array_equal(
            tdct.pairs_from_rids(a.rids).numpy(),
            _np(jdct.pairs_from_rids(b.rids)))


@pytest.mark.parametrize("wide", [False, True])
def test_probe_meta_groups(wide):
    rows, n, windows = _rows(seed=10)
    S = jdct.table_buckets(rows.shape[0])
    jt = [jdct._build_hash_dict_dev(jnp.asarray(rows),
                                    jnp.asarray(n, jnp.int32), w.start, S,
                                    wide) for w in windows]
    btab_all = np.concatenate([_np(t[0]) for t in jt], axis=0)
    # hitting queries (indexed window keys of either dict) mixed with
    # random ones, over a static group list of dictionaries
    rng = np.random.default_rng(11)
    hits = np.concatenate([_np(t[1]) * np.uint32(jdct._HASH_MULT_INV)
                           for t in jt])
    B, G = 64, 40
    q = rng.integers(0, 2**32, (B, G), dtype=np.uint64).astype(np.uint32)
    take = rng.random((B, G)) < 0.6
    q[take] = rng.choice(hits, int(take.sum()))
    dict_of_g = rng.integers(0, 2, G).astype(np.int32)
    js, jc = jdct.probe_meta_groups(jnp.asarray(btab_all), S, jnp.asarray(q),
                                    dict_of_g)
    ts, tc = tdct.probe_meta_groups(_tt(btab_all), S,
                                    _tt(q), dict_of_g)
    assert int((_np(jc) > 0).sum()) > B * G // 8
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    # single-table probe_meta on the same queries
    js1, jc1 = jdct.probe_meta(jt[0][0], jnp.asarray(q))
    ts1, tc1 = tdct.probe_meta(_tt(_np(jt[0][0])),
                               _tt(q))
    np.testing.assert_array_equal(ts1.numpy(), _np(js1))
    np.testing.assert_array_equal(tc1.numpy(), _np(jc1))


def _seq_words(rng, total=5000, pad_words=1, tail_words=9):
    seq = rng.integers(0, 4, total).astype(np.uint8)
    seq[total - 1000:total - 600] = seq[:400]    # repeated 16-mers
    pk = packing.pack_codes(np.concatenate(
        [np.zeros(16 * pad_words, np.uint8), seq,
         np.zeros(16 * tail_words, np.uint8)])[None, :])[0]
    nw = -(-len(pk) // 64) * 64
    out = np.zeros(nw, np.uint32)
    out[:len(pk)] = pk
    return out, seq


@pytest.mark.parametrize("mode", ["flat", "pairs", "wide_cands"])
def test_seq_dict_and_probe_hash(mode):
    rng = np.random.default_rng(12)
    seq_w, seq = _seq_words(rng)
    total = len(seq)
    npos = (len(seq_w) - 1) * 16
    S = max(jdct.table_buckets(npos) // 2, 64)
    j_out = jdct.build_hash_dict_seq_dev(jnp.asarray(seq_w),
                                         jnp.asarray(total, jnp.int32), 1, S)
    t_out = tdct.build_hash_dict_seq_dev(_tt(seq_w), total, 1,
                                         S)
    _assert_build_equal(t_out, j_out)
    # queries: 16-mers of the sequence (some repeated) and random keys
    p = rng.integers(0, total - 16, 300)
    keys = np.array([int(sum(int(seq[x + i]) << (2 * i) for i in range(16)))
                     for x in p], np.uint64).astype(np.uint32)
    q = np.concatenate([keys, rng.integers(0, 2**32, 100, dtype=np.uint64)
                        .astype(np.uint32)]).reshape(20, 20)
    jb, jr = j_out[0], j_out[2]
    tb, tr = t_out[0], t_out[2]
    mc = 8
    if mode == "pairs":
        jr, tr = jdct.pairs_from_rids(jr), tdct.pairs_from_rids(tr)
    elif mode == "wide_cands":
        mc = 12
    jc, jv = jdct.probe_hash(jb, jr, jnp.asarray(q), mc)
    tc, tv = tdct.probe_hash(tb, tr, _tt(q), mc)
    assert int(_np(jv).sum()) >= 300
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(tc.numpy(), _np(jc))


def test_seq_dict_segmented_build():
    rng = np.random.default_rng(13)
    seq_w, seq = _seq_words(rng, total=3000, tail_words=40)
    total = len(seq)
    S = 256
    for base, nw_seg in ((0, 66), (1024, 66), (2048, 66)):
        j_out = jdct.build_hash_dict_seq_seg(
            jnp.asarray(seq_w), jnp.asarray(total, jnp.int32),
            jnp.asarray(base, jnp.int32), 1, nw_seg, S)
        t_out = tdct.build_hash_dict_seq_seg(_tt(seq_w), total,
                                             base, 1, nw_seg, S)
        _assert_build_equal(t_out, j_out)


def test_device_dicts_carry_over():
    """convert.py: a JAX dictionary carried into the port and back keeps
    every bit."""
    rows, n, windows = _rows(seed=14)
    jd = jdct.build_hash_dicts_device(jnp.asarray(rows), n, windows)[0]
    td = convert.dict_to_torch(_np(jd.btab), _np(jd.rids), _np(jd.keys_dev),
                               jd.start, int(jd.dropped), device="cpu")
    back = convert.dict_to_numpy(td)
    np.testing.assert_array_equal(back["btab"], _np(jd.btab))
    np.testing.assert_array_equal(back["keys"], _np(jd.keys_dev))
    np.testing.assert_array_equal(back["rids"], _np(jd.rids))
    assert back["btab"].dtype == np.uint32 and back["rids"].dtype == np.int32
    assert torch.equal(_tt(rows),
                       _tt(convert.to_numpy(
                           _tt(rows), uint32=True)))
