"""spring_tpu_torch.ops.bits against spring_tpu.ops.bits (JAX on CPU).

Same inputs, made from a seed with numpy, go through both; the tolerance
is exact equality (integer bit operations). Packed words include the top
bit set, which int32 carriage must keep as an unsigned pattern.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from spring_tpu.ops import bits as jbits  # noqa: E402
from spring_tpu_torch.ops import bits as tbits  # noqa: E402

W = 7
L = W * 16


def _words(rng, shape):
    a = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    a.reshape(-1)[::3] |= np.uint32(0x80000000)       # top bit set
    return a


def _t(a):
    a = np.array(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _eq(t, j):
    got = t.numpy()
    want = np.asarray(j)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _reads(rng, n):
    """Packed reads with zero bits beyond each read's length."""
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    codes = rng.integers(0, 4, (n, L)).astype(np.int32)
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0)
    return np.asarray(jbits.pack(jnp.asarray(codes))), lens, codes


def test_unpack_pack_roundtrip():
    rng = np.random.default_rng(0)
    pk = _words(rng, (40, W))
    _eq(tbits.unpack(_t(pk), 100), jbits.unpack(jnp.asarray(pk), 100))
    codes = rng.integers(0, 4, (40, 101)).astype(np.int32)
    _eq(tbits.pack(_t(codes)), jbits.pack(jnp.asarray(codes)))


@pytest.mark.parametrize("fn", ["left", "right"])
def test_dynamic_base_shifts(fn):
    rng = np.random.default_rng(1)
    pk = _words(rng, (64, W))
    s = rng.integers(0, L + 1, 64).astype(np.int32)
    s[:8] = [0, 1, 15, 16, 17, 31, 32, L]
    tf = getattr(tbits, f"shift_bases_{fn}")
    jf = getattr(jbits, f"shift_bases_{fn}")
    _eq(tf(_t(pk), _t(s), L), jf(jnp.asarray(pk), jnp.asarray(s), L))
    # a smaller max_shift leaves the word part of larger shifts undone
    _eq(tf(_t(pk), _t(s), 40), jf(jnp.asarray(pk), jnp.asarray(s), 40))


@pytest.mark.parametrize("fn", ["left", "right"])
def test_static_base_shifts(fn):
    rng = np.random.default_rng(2)
    pk = _words(rng, (16, W))
    tf = getattr(tbits, f"shift_bases_{fn}_static")
    jf = getattr(jbits, f"shift_bases_{fn}_static")
    for s in range(0, 40):
        _eq(tf(_t(pk), s), jf(jnp.asarray(pk), s))


def test_reverse_lanes():
    rng = np.random.default_rng(3)
    pk = _words(rng, (50, W))
    _eq(tbits._reverse_lanes(_t(pk)), jbits._reverse_lanes(jnp.asarray(pk)))


def test_revcomp_packed():
    rng = np.random.default_rng(4)
    pk, lens, _ = _reads(rng, 80)
    lens[:3] = [0, L, 16]
    _eq(tbits.revcomp_packed(_t(pk), _t(lens)),
        jbits.revcomp_packed(jnp.asarray(pk), jnp.asarray(lens)))
    # batched (B, M, W) rows, as the reorder round calls it
    pk3 = pk.reshape(8, 10, W)
    lens3 = lens.reshape(8, 10)
    _eq(tbits.revcomp_packed(_t(pk3), _t(lens3)),
        jbits.revcomp_packed(jnp.asarray(pk3), jnp.asarray(lens3)))


def test_extract_key_packed():
    rng = np.random.default_rng(5)
    pk = _words(rng, (30, 2, W))
    for st in range(0, L - 15):
        _eq(tbits.extract_key_packed(_t(pk), st),
            jbits.extract_key_packed(jnp.asarray(pk), st))


def test_popcount_and_prefix_word():
    rng = np.random.default_rng(6)
    w = _words(rng, (1000,))
    w[:3] = [0, 0xFFFFFFFF, 0x80000000]
    want = np.array([bin(int(x)).count("1") for x in w], np.int32)
    np.testing.assert_array_equal(tbits.popcount32(_t(w)).numpy(), want)
    nb = np.arange(-3, 20, dtype=np.int32)
    from spring_tpu.reorder import engine as jeng
    _eq(tbits.prefix_word(_t(nb)), jeng._prefix_word(jnp.asarray(nb)))
