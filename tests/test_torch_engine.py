"""Reorder round, flush and engine run: spring_tpu_torch.reorder.engine
against spring_tpu.reorder.engine (JAX on CPU). The port starts from
exactly the JAX state, carried over with spring_tpu_torch.convert; state,
emissions and stats must be equal."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from spring_tpu.io import packing  # noqa: E402
from spring_tpu.reorder import engine as jeng  # noqa: E402
from spring_tpu_torch import convert  # noqa: E402
from spring_tpu_torch.ops import kernels  # noqa: E402
from spring_tpu_torch.reorder import engine as teng  # noqa: E402


def _np_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _assert_state_equal(t_state, j_state):
    got = convert.state_to_numpy(t_state)
    for k, v in _np_state(j_state).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k


@pytest.fixture(scope="module")
def entry():
    """The JAX round and its args from __graft_entry__.entry(), and the
    port's round/flush for the same shape signature."""
    fn, args = __graft_entry__.entry()
    state, lengths, dkeys, pairs_all, seed_order, n_real, maxshift, rows = args
    Np = int(rows.shape[0])
    cfg = jeng.ReorderConfig(max_readlen=96)
    starts = tuple(w.start for w in jeng.dct.default_windows(96))
    t_round, t_flush, cap, _ = teng._flush_program(
        Np, cfg.candidates, cfg.shift_chunk, cfg.accept_slots, starts,
        cfg.thresh)
    t_args = [convert.to_torch(np.asarray(a), "cpu") for a in
              (lengths, dkeys, pairs_all, seed_order)] + [
        int(n_real), int(maxshift),
        convert.to_torch(np.asarray(rows), "cpu")]
    return fn, args, t_round, t_flush, cap, t_args


def test_round_fn_from_entry_state(entry):
    """Several consecutive rounds: each starts the port from the JAX
    state of that round (seeding first, then accepts and claims)."""
    fn, args, t_round, _, _, t_args = entry
    jround = jax.jit(fn)
    state = dict(args[0])
    accepted = 0
    for _ in range(6):
        t_state = convert.state_to_torch(_np_state(state), "cpu")
        j_new, j_emit = jround(state, *args[1:])
        t_new, t_emit = t_round(t_state, *t_args)
        _assert_state_equal(t_new, j_new)
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        accepted += int((np.asarray(j_emit)[:, 1:, 0] >= 0).sum())
        state = j_new
    assert accepted > 0


def test_flush_fn_from_entry_state(entry):
    fn, args, _, t_flush, cap, t_args = entry
    e_cap = jeng._flush_program(
        int(args[7].shape[0]), jeng.P.DICT_PROBE_CANDIDATES, 16, 16,
        tuple(w.start for w in jeng.dct.default_windows(96)),
        jeng.P.THRESH_REORDER)
    jflush = e_cap[1]
    assert e_cap[2] == cap
    state0 = _np_state(args[0])
    j_state, j_dense, j_cnt, j_stats = jflush(
        {k: jnp.asarray(v) for k, v in state0.items()}, *args[1:])
    t_state, t_dense, t_cnt, t_stats = t_flush(
        convert.state_to_torch(state0, "cpu"), *t_args)
    _assert_state_equal(t_state, j_state)
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_array_equal(t_stats.numpy(), np.asarray(j_stats))
    # the last dense row is the scatter sink of empty slots: not compared
    np.testing.assert_array_equal(t_dense.numpy()[:-1],
                                  np.asarray(j_dense)[:-1])
    assert int(np.asarray(j_stats)[3]) > 0


def _reads(n, L=100, seed=0, err=0.01, cover=20):
    """n noisy reads of both strands over a genome at ~cover coverage."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, max(n * L // cover, 2 * L)).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, n)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    flip = rng.random(codes.shape) < err
    codes = np.where(flip, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = 3 - codes[rc][:, ::-1]
    lengths = np.full(n, L, np.int32)
    lengths[::7] = rng.integers(60, L, len(lengths[::7]))
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0)
    return packing.pack_codes(codes.astype(np.uint8)), lengths


@pytest.mark.parametrize("n", [1000, 4000])
def test_engine_run_emissions_equal(n):
    packed, lengths = _reads(n, seed=n)
    cfg = jeng.ReorderConfig(max_readlen=100)
    j_em = jeng.ReorderEngine(packed, lengths, cfg).run()
    before = (kernels.masked_hamming.launches, kernels.verify_rows.launches)
    t_engine = teng.ReorderEngine(packed, lengths,
                                  teng.ReorderConfig(max_readlen=100),
                                  device="cpu")
    t_em = t_engine.run()
    assert (kernels.masked_hamming.launches,            # CPU: plain path
            kernels.verify_rows.launches) == before
    assert len(j_em) > n // 2
    np.testing.assert_array_equal(t_em, j_em)
    assert teng.LAST_RUN_STATS["rounds"] == jeng.LAST_RUN_STATS["rounds"]


def test_engine_run_with_select():
    """The clean-read subset gathered on the device (compress_short's
    call) gives the JAX engine's emissions."""
    packed, lengths = _reads(3000, seed=5)
    sel = np.nonzero(np.arange(3000) % 11 != 3)[0].astype(np.int32)
    buf = np.zeros((4096, packed.shape[1]), np.uint32)
    buf[:3000] = packed
    cfg = jeng.ReorderConfig(max_readlen=100)
    j_em = jeng.ReorderEngine(buf, lengths, cfg, select=sel).run()
    t_em = teng.ReorderEngine(buf, lengths,
                              teng.ReorderConfig(max_readlen=100),
                              select=sel, device="cpu").run()
    np.testing.assert_array_equal(t_em, j_em)
