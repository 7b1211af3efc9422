"""Masked-Hamming verify: the port's plain PyTorch reference and wrappers
against the Pallas kernel (interpret mode on CPU, as tests/test_pallas.py
runs it) and the engine's XLA form. Exact equality: integer counts.

The CUDA kernel itself runs only on the card: its tests skip without one.
They import no JAX, so on a machine with a card and no JAX they run as
    python -m pytest --noconftest -q tests/test_torch_kernels.py -k cuda
and chip_smoke.py compares the kernel with masked_hamming_ref at the main
path's shapes.
"""
import numpy as np
import pytest
import torch

from spring_tpu_torch.ops import kernels


@pytest.fixture
def jx():
    """(jax.numpy, pallas_kernels, engine) of the JAX reference."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from spring_tpu.ops import pallas_kernels
    from spring_tpu.reorder import engine
    return jnp, pallas_kernels, engine


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _inputs(seed, W, B, K, edge=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (W, B, K), dtype=np.uint64).astype(np.uint32)
    b = a.copy()
    nflip = W * B * K // 4
    b[rng.integers(0, W, nflip), rng.integers(0, B, nflip),
      rng.integers(0, K, nflip)] ^= rng.integers(
          1, 2**32, nflip, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 40, (B, K)).astype(np.int32)
    hi = rng.integers(30, 16 * W + 20, (B, K)).astype(np.int32)
    if edge:
        lo[0], hi[0] = 17, 17                  # empty range lo == hi
        lo[1], hi[1] = 0, 0                    # hi = 0
        lo[2], hi[2] = 5, 16 * W + 50          # hi past the last word
        lo[3], hi[3] = 40, 10                  # hi < lo
        a[:, 4], b[:, 4] = 0xFFFFFFFF, 0       # all bits set vs none
        lo[4], hi[4] = 0, 16 * W
        a[:, 5], b[:, 5] = 0xFFFFFFFF, 0xFFFFFFFF
    return a, b, lo, hi


@pytest.mark.parametrize("edge", [False, True])
def test_ref_matches_pallas_interpret(jx, edge):
    from jax.experimental.pallas import tpu as pltpu
    jnp, pk, _ = jx
    a, b, lo, hi = _inputs(3, 7, 16, 32, edge)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pk.masked_hamming(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(lo), jnp.asarray(hi),
            block=8))
    got = kernels.masked_hamming_ref(_t(a), _t(b), _t(lo), _t(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain path for CPU tensors, and counts nothing
    before = kernels.masked_hamming.launches
    got = kernels.masked_hamming(_t(a), _t(b), _t(lo), _t(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert kernels.masked_hamming.launches == before


@pytest.mark.parametrize("edge", [False, True])
def test_rows_layout_matches_engine_xla(jx, edge):
    """Row-major (B, M, W) frames and (B, M, W+1) rows, as the round
    gathers them, against engine._masked_hamming."""
    jnp, _, jeng = jx
    W, B, M = 7, 24, 16
    a, b, lo, hi = _inputs(4, W, B, M, edge)
    fr = np.moveaxis(a, 0, -1).copy()                       # (B, M, W)
    rows = np.concatenate(
        [np.moveaxis(b, 0, -1),
         np.full((B, M, 1), 0x80000064, np.uint32)], axis=-1)  # + len word
    want = np.asarray(jeng._masked_hamming(
        jnp.asarray(fr), jnp.asarray(rows[..., :W]), jnp.asarray(lo),
        jnp.asarray(hi)))
    got = kernels.masked_hamming_rows(_t(fr), _t(rows), _t(lo),
                                      _t(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        kernels.masked_hamming_ref(_t(a), _t(b), _t(lo), _t(hi)).numpy(),
        want)


def test_wrapper_rejects_bad_inputs():
    a, b, lo, hi = _inputs(5, 7, 8, 8)
    with pytest.raises(TypeError):
        kernels.masked_hamming(_t(a).to(torch.int64), _t(b), _t(lo), _t(hi))
    with pytest.raises(ValueError):
        kernels.masked_hamming(_t(a)[:, :4], _t(b), _t(lo), _t(hi))
    with pytest.raises(ValueError):
        kernels.masked_hamming(_t(a).transpose(1, 2), _t(b).transpose(1, 2),
                               _t(lo).T, _t(hi).T)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py checks it on the H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("layout", ["word_major", "rows"])
def test_cuda_kernel_matches_ref(cuda_device, layout):
    W, B, K = 7, 512, 16
    a, b, lo, hi = _inputs(6, W, B, K, edge=True)
    ta, tb, tlo, thi = (_t(x).to(cuda_device) for x in (a, b, lo, hi))
    want = kernels.masked_hamming_ref(ta, tb, tlo, thi)
    wrapper = (kernels.masked_hamming if layout == "word_major"
               else kernels.masked_hamming_rows)
    before = wrapper.launches
    if layout == "word_major":
        got = kernels.masked_hamming(ta, tb, tlo, thi)
    else:
        lw = torch.zeros((B, K, 1), dtype=torch.int32, device=cuda_device)
        got = kernels.masked_hamming_rows(
            ta.movedim(0, -1).contiguous(),
            torch.cat([tb.movedim(0, -1), lw], dim=-1).contiguous(),
            tlo, thi)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1       # each wrapper its own count
    assert torch.equal(got, want)
