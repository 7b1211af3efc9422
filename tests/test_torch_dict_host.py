"""The host half of the dictionary, the packed-bit helpers and the
byte-codes second-chance wrapper: spring_tpu_torch against spring_tpu
(JAX on the CPU), exactly. The host builders (compact, wide and classic
rows, with and without pow2 padding; the overflow message), both window
key functions, the stacked probe and pair rows, hamming_packed,
mismatch_mask, revcomp_codes, extract_key, pack_np and align_leftovers.
Follows tests/test_reorder.py."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from spring_tpu.encode import second_chance as jsc  # noqa: E402
from spring_tpu.io import packing  # noqa: E402
from spring_tpu.ops import bits as jbits  # noqa: E402
from spring_tpu.reorder import dictionary as jdct  # noqa: E402
from spring_tpu_torch import convert  # noqa: E402
from spring_tpu_torch.encode import second_chance as tsc  # noqa: E402
from spring_tpu_torch.ops import bits as tbits  # noqa: E402
from spring_tpu_torch.reorder import dictionary as tdct  # noqa: E402
from test_torch_second_chance import _case  # noqa: E402


def _tt(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _u32(t):
    return convert.to_numpy(t, uint32=True)


def _codes(seed, n, L):
    return np.random.default_rng(seed).integers(0, 4, size=(n, L),
                                                dtype=np.uint8)


def test_hamming_packed_and_pack_np():
    rng = np.random.default_rng(1)
    a = _codes(1, 20, 64)
    b = a.copy()
    for i, f in enumerate(rng.integers(0, 64, size=(20, 3))):
        b[i, f[: i % 4]] = (b[i, f[: i % 4]] + 1 + i % 3) % 4
    pa, pb = tbits.pack_np(a), tbits.pack_np(b)
    np.testing.assert_array_equal(pa, jbits.pack_np(a))
    want = np.asarray(jbits.hamming_packed(jnp.asarray(pa), jnp.asarray(pb)))
    got = tbits.hamming_packed(_tt(pa), _tt(pb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 1


def test_mismatch_mask_and_revcomp_codes():
    a, b = _codes(2, 6, 40).astype(np.int32), _codes(3, 6, 40).astype(
        np.int32)
    valid = np.arange(40)[None, :] < np.array([40, 33, 17, 1, 0, 20])[:, None]
    want = np.asarray(jbits.mismatch_mask(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(valid)))
    got = tbits.mismatch_mask(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    lens = np.array([40, 33, 17, 1, 0, 20], np.int32)
    want = np.asarray(jbits.revcomp_codes(jnp.asarray(a), jnp.asarray(lens)))
    got = tbits.revcomp_codes(torch.from_numpy(a), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [16, 9])
def test_extract_key(width):
    codes = _codes(4, 12, 50).astype(np.int32)
    for start in (0, 7, 34, 45):        # 45: clamped as a dynamic slice
        want = np.asarray(jbits.extract_key(jnp.asarray(codes), start, width))
        got = tbits.extract_key(torch.from_numpy(codes), start, width)
        np.testing.assert_array_equal(_u32(got), want)
    starts = np.array([0, 3, 16, 33, 40, 49, 2, 5, 8, 11, 30, 45], np.int32)
    want = np.asarray(jbits.extract_key(jnp.asarray(codes),
                                        jnp.asarray(starts), width))
    got = tbits.extract_key(torch.from_numpy(codes),
                            torch.from_numpy(starts), width)
    np.testing.assert_array_equal(_u32(got), want)


def test_window_keys():
    codes = _codes(8, 12, 96)
    pk = packing.pack_codes(codes)
    for st in (0, 16, 21, 80):
        want = jdct._window_keys_np(codes, st)
        np.testing.assert_array_equal(tdct._window_keys_np(codes, st), want)
        np.testing.assert_array_equal(tdct._window_keys_packed(pk, st),
                                      jdct._window_keys_packed(pk, st))
        np.testing.assert_array_equal(tdct._window_keys_packed(pk, st), want)


def _reads(seed=11, n=3000, L=100):
    codes = _codes(seed, n, L)
    codes[1000:1500] = codes[:500]          # multi-entry bins
    lengths = np.full(n, L, np.int32)
    lengths[:50] = 40                       # too short for the mid windows
    return codes, lengths


def _jax_build(fn, *args, wide=False, **kw):
    old = jdct.FORCE_WIDE
    jdct.FORCE_WIDE = wide
    try:
        jax.clear_caches()
        return fn(*args, **kw)
    finally:
        jdct.FORCE_WIDE = old
        jax.clear_caches()


def _equal_dicts(got, want, words):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.btab.shape[1] == words and g.nbuckets == w.nbuckets
        np.testing.assert_array_equal(_u32(g.btab), np.asarray(w.btab))
        np.testing.assert_array_equal(g.rids.numpy(), np.asarray(w.rids))
        np.testing.assert_array_equal(g.keys_sorted, w.keys_sorted)
        assert g.start == w.start


@pytest.mark.parametrize("kind,words", [
    ("compact", tdct.COMPACT_WORDS), ("wide", tdct.WIDE_WORDS),
    ("classic", 3 * tdct.SLOTS)])
@pytest.mark.parametrize("pad", [True, False])
def test_host_builders(kind, words, pad):
    codes, lengths = _reads()
    pk = packing.pack_codes(codes)
    wide, compact = kind == "wide", kind != "classic"
    windows = jdct.default_windows(100)
    want = _jax_build(jdct.build_hash_dicts, codes, lengths, wide=wide,
                      pad_to_pow2=pad, compact=compact)
    got = tdct.build_hash_dicts(codes, lengths, pad_to_pow2=pad,
                                compact=compact, device="cpu",
                                force_wide=wide)
    _equal_dicts(got, want, words)
    want = _jax_build(jdct.build_hash_dicts_packed, pk, lengths, windows,
                      wide=wide, pad_to_pow2=pad, compact=compact)
    got = tdct.build_hash_dicts_packed(pk, lengths, windows,
                                       pad_to_pow2=pad, compact=compact,
                                       device="cpu", force_wide=wide)
    _equal_dicts(got, want, words)


@pytest.mark.parametrize("wide", [False, True])
def test_device_build_equals_host_build(wide):
    """The device build gives the host build's tables bit for bit, in
    both row formats (tests/test_reorder.py's check, on the port)."""
    codes, lengths = _reads(seed=7)
    n, L = codes.shape
    pk = packing.pack_codes(codes)
    windows = tdct.default_windows(L)
    host = tdct.build_hash_dicts_packed(pk, lengths, windows, device="cpu",
                                        force_wide=wide)
    W = pk.shape[1]
    Np = max(1 << max(n - 1, 1).bit_length(), 64)
    rows = np.zeros((Np, W + 1), np.uint32)
    rows[:n, :W] = pk
    lp = np.zeros(Np, np.int32)
    lp[:n] = lengths
    rows[:, W] = lp.view(np.uint32)
    rows[n:, W] |= np.uint32(1 << 31)
    dev = tdct.build_hash_dicts_device(_tt(rows), n, windows, wide)
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h.btab.numpy(), d.btab.numpy())
        np.testing.assert_array_equal(h.rids.numpy(), d.rids.numpy())


def test_overflow_message_and_sentinel_drop(capfd):
    """Enough distinct keys that some buckets overflow: the classic build
    drops the same keys and prints the same count as JAX's."""
    n = 131_000                 # two keys a bucket; padded with rid -1
    codes = _codes(12, n, 20)
    lengths = np.full(n, 20, np.int32)
    lengths[::500] = 10                     # too short for the window
    windows = [jdct.DictSpec(0)]
    pk = packing.pack_codes(codes)
    want = jdct.build_hash_dicts_packed(pk, lengths, windows, compact=False)
    j_err = capfd.readouterr().err
    got = tdct.build_hash_dicts_packed(pk, lengths, windows, compact=False,
                                       device="cpu")
    t_err = capfd.readouterr().err
    _equal_dicts(got, want, 3 * tdct.SLOTS)
    assert "overflowed the hash table" in j_err and t_err == j_err


@pytest.mark.parametrize("wide", [False, True])
def test_probe_meta_split_stacked(wide):
    codes, lengths = _reads(seed=13)
    d = tdct.build_hash_dicts(codes, lengths, device="cpu", force_wide=wide)
    S = d[0].nbuckets
    stacked = torch.cat([x.btab for x in d], dim=0)
    rng = np.random.default_rng(14)
    q = np.stack([np.concatenate([x.keys_sorted[:200],
                                  rng.integers(0, 2**32, 56,
                                               dtype=np.uint32)])
                  for x in d]).reshape(len(d), 16, 16)
    want = jdct.probe_meta_split_stacked(jnp.asarray(_u32(stacked)), S,
                                         jnp.asarray(q))
    got = tdct.probe_meta_split_stacked(stacked, S, _tt(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1] > 0).sum() >= 2 * 150


def test_pairs_from_rids_stacked():
    rng = np.random.default_rng(15)
    for D, n in ((2, 64), (3, 128)):
        rids = rng.integers(-1, 5000, D * n).astype(np.int32)
        want = np.asarray(jdct.pairs_from_rids_stacked(jnp.asarray(rids), D))
        got = tdct.pairs_from_rids_stacked(torch.from_numpy(rids), D)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got[: n // 8].numpy(),
            tdct.pairs_from_rids(torch.from_numpy(rids[:n])).numpy())


def test_align_leftovers_byte_codes():
    seq, codes, lens = _case("mixed")
    want = jsc.align_leftovers(seq, codes, lens)
    got = tsc.align_leftovers(seq, codes, lens, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[2].sum() >= len(lens) // 2
