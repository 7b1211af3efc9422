"""The reorder round's fused verify stage: kernels.verify_rows_ref (plain
PyTorch) against the JAX math of spring_tpu/reorder/engine.py ("verify:
ONE (B, M) row gather + masked popcounts"), restated here with jax.numpy
on the CPU because the JAX round keeps it inline. Exact equality: every
output is an integer or a bool.

The CUDA kernel itself runs only on the card: its tests skip without one.
They need no JAX, so on a machine with a card and no JAX they run as
    python -m pytest --noconftest -q tests/test_torch_verify.py -k cuda
and chip_smoke.py compares the kernel with verify_rows_ref at the main
path's shapes.
"""
import numpy as np
import pytest
import torch

from spring_tpu_torch.ops import kernels

THRESH = 4


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def make_inputs(seed, B, M, W, SC, Np, n_real=None):
    """Verify-stage inputs with every case the round can meet: candidates
    whose row matches the walker's frame over the slot's range (a few
    bases flipped), both orientations, claimed bits, candidates below 0 and
    at or past Np (the sentinel 2^31 - 1 included), padding rows (bit 31 of
    the length word), empty ranges (hi <= lo) and negative t."""
    rng = np.random.default_rng(seed)
    n_real = Np - 5 if n_real is None else n_real
    Lb = 16 * W
    F = 2 * SC

    def words(shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(
            np.uint32)

    rows_tab = np.zeros((Np, W + 1), np.uint32)
    rows_tab[:, :W] = words((Np, W))
    lens = rng.integers(Lb // 2, Lb + 1, Np).astype(np.uint32)
    lens[rng.integers(0, Np, max(Np // 16, 1))] = 0        # empty reads
    rows_tab[:, W] = lens
    rows_tab[n_real:, W] |= 0x80000000                     # padding rows
    frames = words((B, F, W))
    cand = rng.integers(0, Np, (B, M)).astype(np.int32)
    k_frame = rng.integers(0, F, (B, M)).astype(np.int32)
    # a third of the slots: the frame is the candidate's row, a few bases
    # flipped, so that some slots pass the threshold
    near = rng.random((B, M)) < 0.34
    for b, m in zip(*np.nonzero(near)):
        row = rows_tab[cand[b, m], :W].copy()
        for _ in range(rng.integers(0, 7)):
            row[rng.integers(0, W)] ^= np.uint32(
                rng.integers(1, 4) << (2 * rng.integers(0, 16)))
        frames[b, k_frame[b, m]] = row
    cand[rng.random((B, M)) < 0.05] = -1
    cand[rng.random((B, M)) < 0.05] = 2**31 - 1
    cand[rng.random((B, M)) < 0.03] = Np
    cand[rng.random((B, M)) < 0.03] = -(2**31)
    cand[0, 0], cand[0, 1] = 0, Np - 1
    valid = rng.random((B, M)) < 0.8
    nwords = Np // 32 + 2
    claimed = words((nwords,)) & words((nwords,))          # ~1/4 of the bits
    claimed[-1] = 0xFFFFFFFF
    ref_len = rng.integers(0, Lb + 1, B).astype(np.int32)
    ref_len[0] = 0
    shift_base = (SC * rng.integers(0, 3, B)).astype(np.int32)
    return dict(rows_tab=rows_tab, cand=cand, valid=valid, claimed=claimed,
                frames=frames, k_frame=k_frame, shift_base=shift_base,
                ref_len=ref_len)


def torch_inputs(inp, device="cpu"):
    return [_t(inp[k]).to(device) for k in (
        "rows_tab", "cand", "valid", "claimed", "frames", "k_frame",
        "shift_base", "ref_len")]


def _jax_verify(jnp, jax, inp, thresh):
    """The verify block of the JAX round (spring_tpu/reorder/engine.py),
    restated: same names, same order."""
    from spring_tpu.reorder.engine import _ODD, _prefix_word
    packed = jnp.asarray(inp["rows_tab"])
    claimed = jnp.asarray(inp["claimed"])
    cand_m = jnp.asarray(inp["cand"])
    valid_m = jnp.asarray(inp["valid"])
    frames = jnp.asarray(inp["frames"])
    k_frame_m = jnp.asarray(inp["k_frame"])
    shift_base = jnp.asarray(inp["shift_base"])
    ref_len = jnp.asarray(inp["ref_len"])
    Np, Wl = packed.shape[0], packed.shape[1] - 1
    B = cand_m.shape[0]
    k_o_m = k_frame_m & 1
    s_m = shift_base[:, None] + (k_frame_m >> 1)

    def claimed_bit(idx):
        w = claimed[idx >> 5]
        return ((w >> (idx & 31).astype(jnp.uint32)) & 1) == 1

    safe = jnp.clip(cand_m, 0, Np - 1)
    rows = packed[safe]
    lw = rows[..., Wl]
    claimed_row = claimed_bit(safe)
    clen = (lw & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    rl = ref_len[:, None]
    lo = jnp.where(k_o_m == 0, 0, s_m)
    hi = jnp.where(k_o_m == 0, jnp.minimum(rl - s_m, clen),
                   jnp.minimum(rl + s_m, clen))
    t = jnp.where(k_o_m == 0, s_m, rl + s_m - clen)
    fr2 = frames.reshape(B, -1, Wl)
    frow = jnp.take_along_axis(fr2, k_frame_m[:, :, None], axis=1)
    ham = jnp.zeros(cand_m.shape, jnp.int32)
    for w in range(Wl):
        d = frow[..., w] ^ rows[..., w]
        mm = (d | (d >> 1)) & _ODD
        mw = _prefix_word(jnp.clip(hi - 16 * w, 0, 16)) \
            & ~_prefix_word(jnp.clip(lo - 16 * w, 0, 16))
        ham = ham + jax.lax.population_count(mm & mw).astype(jnp.int32)
    ok = valid_m & ~claimed_row & (ham <= thresh) & (t >= 0) & (hi > lo)
    return (np.asarray(ok), np.asarray(t), np.asarray(clen),
            np.asarray(ham), np.asarray(lo), np.asarray(hi))


SHAPES = {
    # name: (seed, B, M, W, SC, Np)
    "round_w7": (21, 24, 16, 7, 16, 512),
    "w3_small_chunk": (22, 8, 6, 3, 4, 64),
    "w32_long_reads": (23, 9, 16, 32, 16, 256),
    "one_walker": (24, 1, 16, 7, 16, 64),
    # 64 walkers of 2 slots would fill a block, but their frames (4 KiB a
    # walker) would not fit its shared memory: the block takes fewer
    "w32_two_slots": (25, 70, 2, 32, 16, 256),
    # 151-base reads: 11 words a row, the kernel's generic (scalar) path
    "round_w10": (26, 24, 16, 10, 16, 512),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_verify_ref_matches_jax_math(name):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    seed, B, M, W, SC, Np = SHAPES[name]
    inp = make_inputs(seed, B, M, W, SC, Np)
    ok, t, clen, ham, lo, hi = _jax_verify(jnp, jax, inp, THRESH)
    got = kernels.verify_rows_ref(*torch_inputs(inp), THRESH)
    for g, w, what in zip(got, (ok, t, clen, ham),
                          ("ok", "t", "clen", "ham")):
        assert g.shape == (B, M) and g.numpy().dtype == w.dtype, what
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    if B == 1:
        return
    # the inputs do reach every case the round can meet
    o = inp["k_frame"] & 1
    assert ok.any() and (~ok & inp["valid"]).any()
    assert (o == 0).any() and (o == 1).any()
    assert (t < 0).any() and (hi <= lo).any()
    assert (inp["cand"] < 0).any() and (inp["cand"] >= Np).any()
    if name == "round_w7":
        assert (ok & (o == 0)).any() and (ok & (o == 1)).any()
        assert (ham[ok] > 0).any()


def test_verify_wrapper_takes_plain_path_on_cpu():
    """CPU tensors go through verify_rows_ref and count no launch; frames
    may come as (B, SC, 2, W), as the round stacks them."""
    seed, B, M, W, SC, Np = SHAPES["round_w7"]
    inp = make_inputs(seed, B, M, W, SC, Np)
    args = torch_inputs(inp)
    want = kernels.verify_rows_ref(*args, THRESH)
    before = kernels.verify_rows.launches
    got = kernels.verify_rows(*args, THRESH)
    args[4] = args[4].reshape(B, SC, 2, W)
    got4 = kernels.verify_rows(*args, THRESH)
    assert kernels.verify_rows.launches == before
    for g, g4, w in zip(got, got4, want):
        assert torch.equal(g, w) and torch.equal(g4, w)
    assert got[0].dtype == torch.bool
    assert all(g.dtype == torch.int32 for g in got[1:])


def test_non_winning_rows_do_not_reach_the_counts():
    """The round fetches the accepted rows by id after its sorts; a slot
    that did not win then holds another row than its candidate's. Such a
    slot's length is 0, so its lane increments are 0 whatever its row."""
    from spring_tpu_torch.ops import bits
    from spring_tpu_torch.reorder import engine as teng
    rng = np.random.default_rng(3)
    rows = _t(rng.integers(0, 2**32, (4, 5, 7), dtype=np.uint64)
              .astype(np.uint32))
    len_all = torch.zeros((4, 5), dtype=torch.int32)
    inc = teng._lane_inc(bits.unpack(rows, 112), len_all)
    assert int(inc.abs().sum()) == 0


BAD = {
    "cand_int64": (TypeError, lambda a: a.__setitem__(1, a[1].long())),
    "valid_int32": (TypeError, lambda a: a.__setitem__(2, a[2].int())),
    "rows_tab_int64": (TypeError, lambda a: a.__setitem__(0, a[0].long())),
    "frames_float": (TypeError, lambda a: a.__setitem__(4, a[4].float())),
    "cand_shape": (ValueError, lambda a: a.__setitem__(1, a[1][:, :-1])),
    "k_frame_shape": (ValueError, lambda a: a.__setitem__(5, a[5][:-1])),
    "frames_width": (ValueError, lambda a: a.__setitem__(
        4, a[4][..., :-1].contiguous())),
    "frames_walkers": (ValueError, lambda a: a.__setitem__(4, a[4][:-1])),
    "ref_len_shape": (ValueError, lambda a: a.__setitem__(7, a[7][:-1])),
    "claimed_short": (ValueError, lambda a: a.__setitem__(3, a[3][:4])),
    "claimed_2d": (ValueError, lambda a: a.__setitem__(3, a[3][:, None])),
    "cand_not_contiguous": (ValueError, lambda a: (
        a.__setitem__(1, a[1].T.contiguous().T))),
    "rows_tab_1d": (ValueError, lambda a: a.__setitem__(0, a[0][:, 0])),
    "meta_device": (ValueError, lambda a: a.__setitem__(
        6, a[6].to("meta"))),
    "all_meta_device": (ValueError, lambda a: [
        a.__setitem__(i, x.to("meta")) for i, x in enumerate(list(a))]),
}


@pytest.mark.parametrize("name", list(BAD))
def test_verify_wrapper_rejects(name):
    seed, B, M, W, SC, Np = SHAPES["round_w7"]
    args = torch_inputs(make_inputs(seed, B, M, W, SC, Np))
    exc, spoil = BAD[name]
    spoil(args)
    with pytest.raises(exc):
        kernels.verify_rows(*args, THRESH)


def test_device_ms_needs_the_card():
    """The timing entries never time the plain version."""
    seed, B, M, W, SC, Np = SHAPES["w3_small_chunk"]
    args = torch_inputs(make_inputs(seed, B, M, W, SC, Np))
    with pytest.raises(ValueError):
        kernels.verify_rows_device_ms(*args, THRESH)
    a = torch.zeros((3, 4, 4), dtype=torch.int32)
    lo = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.masked_hamming_device_ms(a, a, lo, lo)
    with pytest.raises(ValueError):
        kernels.launch_floor_device_ms("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py checks it on the H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_verify_kernel_matches_ref(cuda_device, name):
    seed, B, M, W, SC, Np = SHAPES[name]
    args = torch_inputs(make_inputs(seed, B, M, W, SC, Np), cuda_device)
    want = kernels.verify_rows_ref(*args, THRESH)
    before = kernels.verify_rows.launches
    got = kernels.verify_rows(*args, THRESH)
    torch.cuda.synchronize()
    assert kernels.verify_rows.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert kernels.launch_floor_device_ms(cuda_device, reps=3) > 0
    ms, got = kernels.verify_rows_device_ms(*args, THRESH, reps=3)
    assert ms > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
