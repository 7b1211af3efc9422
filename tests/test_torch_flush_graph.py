"""The flush runner (spring_tpu_torch.reorder.engine.FlushRunner) over its
static buffers, against spring_tpu (JAX on the CPU), exactly: the engine
through queue compactions (the branch that rewrites the static seed
queue), one flush from the JAX entry state with n_real and maxshift as
0-dim tensors, outputs that outlive the flushes after them, and the
distributed engine at world size 2 over gloo. On the CPU the runner calls
its steps; on a card it replays them as CUDA graphs. The card's cases
(CUDA graphs against the CPU runner) import no JAX, so that they run where
JAX is missing:

    python -m pytest --noconftest -q tests/test_torch_flush_graph.py -k cuda
"""
import numpy as np
import pytest
import torch

import test_torch_dist_ranks as ranks
from spring_tpu_torch import convert
from spring_tpu_torch.io import packing
from spring_tpu_torch.ops import graphs, kernels
from spring_tpu_torch.parallel import dist as tdist
from spring_tpu_torch.parallel import multihost as tmh
from spring_tpu_torch.reorder import engine as teng


def _jax():
    """The JAX package's engines (the CPU parity cases only)."""
    pytest.importorskip("jax")
    from spring_tpu.parallel import dist as jdist
    from spring_tpu.reorder import engine as jeng
    return jdist, jeng


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flush is captured into CUDA "
                    "graphs only there")
    return torch.device("cuda")


def _reads(n, seed, genome, short_every=0):
    """n noisy reads of 100 bases from both strands of a random genome;
    every 7th read 60-99 bases long, and with short_every every such read
    40 bases long (too short for either dictionary window)."""
    L = 100
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome).astype(np.uint8)
    starts = rng.integers(0, len(g) - L, n)
    codes = g[starts[:, None] + np.arange(L)[None, :]]
    flip = rng.random(codes.shape) < 0.01
    codes = np.where(flip, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = 3 - codes[rc][:, ::-1]
    lengths = np.full(n, L, np.int32)
    lengths[::7] = rng.integers(60, L, len(lengths[::7]))
    if short_every:
        lengths[::short_every] = 40
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0)
    return packing.pack_codes(codes.astype(np.uint8)), lengths


def _np(t):
    return t.cpu().numpy()


def _launch(fn, n, *args):
    return tmh.launch(fn, n, args, device="cpu", timeout=240.0,
                      num_threads=1)


@pytest.fixture(scope="module")
def entry():
    """The JAX flush and the entry state and args of
    __graft_entry__.entry(), and the port's runner for the same shapes."""
    _, jeng = _jax()
    import __graft_entry__
    _, args = __graft_entry__.entry()
    Np = int(args[7].shape[0])
    cfg = jeng.ReorderConfig(max_readlen=96)
    starts = tuple(w.start for w in jeng.dct.default_windows(96))
    j_flush = jeng._flush_program(Np, cfg.candidates, cfg.shift_chunk,
                                  cfg.accept_slots, starts, cfg.thresh)[1]
    t_runner = teng._flush_program(Np, cfg.candidates, cfg.shift_chunk,
                                   cfg.accept_slots, starts, cfg.thresh)[3]
    return args, j_flush, t_runner


def _runner(entry):
    """A new runner from the JAX entry state: n_real and maxshift as 0-dim
    int32 tensors, as the JAX program has them."""
    args, _, t_runner = entry
    state, lengths, dkeys, pairs_all, seed_order, n_real, maxshift, rows = \
        args
    t = [convert.to_torch(np.asarray(a), "cpu")
         for a in (lengths, dkeys, pairs_all, seed_order)]
    n_real = torch.tensor(int(n_real), dtype=torch.int32)
    maxshift = torch.tensor(int(maxshift), dtype=torch.int32)
    t_state = convert.state_to_torch(
        {k: np.asarray(v) for k, v in state.items()}, "cpu")
    return t_runner(t_state, *t, n_real, maxshift,
                    convert.to_torch(np.asarray(rows), "cpu"))


def test_one_flush_with_device_scalars_equals_jax(entry):
    import jax.numpy as jnp
    args, j_flush, _ = entry
    state0 = {k: np.asarray(v) for k, v in args[0].items()}
    j_state, j_dense, j_cnt, j_stats = j_flush(
        {k: jnp.asarray(v) for k, v in state0.items()}, *args[1:])
    runner = _runner(entry)
    dense, cnt, stats = runner.flush()
    got = convert.state_to_numpy(runner.state)
    for k, v in j_state.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(_np(cnt), np.asarray(j_cnt))
    np.testing.assert_array_equal(_np(stats), np.asarray(j_stats))
    # the last dense row is the scatter sink of empty slots: not compared
    np.testing.assert_array_equal(_np(dense)[:-1], np.asarray(j_dense)[:-1])
    assert int(np.asarray(j_stats)[3]) > 0
    assert runner.stats() == dict(flushes=1, graphed_flushes=0,
                                  round_replays=0, capture_s=None,
                                  graph_pool_bytes=None, warmup_s=None,
                                  ms_per_graphed_round=None)


def test_outputs_outlive_later_flushes(entry):
    """Flush k's outputs, read after flushes k+1 and k+2 ran on the same
    runner, equal flush k of a second runner read at once."""
    runner = _runner(entry)
    kept = [runner.flush() for _ in range(3)]
    fresh = _runner(entry)
    for k in range(3):
        now = [_np(t) for t in fresh.flush()]
        for got, want in zip(kept[k], now):
            np.testing.assert_array_equal(_np(got), want, err_msg=str(k))
    assert sum(int(s[3]) for _, _, s in kept) > 0


def test_engine_through_queue_compaction_equals_jax():
    """ReorderEngine.run on the runner gives the JAX engine's emissions
    and rounds through seed-queue compactions, which rewrite the static
    seed_order, n_real and queue_pos."""
    _, jeng = _jax()
    packed, lengths = _reads(2000, seed=2000, genome=10_000)
    j_em = jeng.ReorderEngine(packed, lengths,
                              jeng.ReorderConfig(max_readlen=100)).run()
    j_rounds = jeng.LAST_RUN_STATS["rounds"]
    t_em = teng.ReorderEngine(packed, lengths,
                              teng.ReorderConfig(max_readlen=100),
                              device="cpu").run()
    stats = teng.LAST_RUN_STATS
    np.testing.assert_array_equal(t_em, j_em)
    assert stats["rounds"] == j_rounds
    assert stats["queue_compactions"] >= 1
    assert stats["rounds_run"] == stats["rounds"] + teng.FLUSH_ROUNDS
    assert stats["flushes"] * teng.FLUSH_ROUNDS == stats["rounds_run"]
    assert stats["graphed_flushes"] == 0        # the CPU calls the steps


def test_dist_runner_two_ranks_through_compaction_equals_jax():
    """The distributed engine's runner at world size 2 over gloo gives the
    JAX DistReorderEngine's emissions on a mesh of 2, on both ranks,
    through a seed-queue compaction."""
    jdist, _ = _jax()
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    packed, lengths = _reads(900, seed=23, genome=4000, short_every=50)
    j_em = jdist.DistReorderEngine(
        packed, lengths, jdist.DistConfig(max_readlen=100),
        mesh=jdist.make_mesh(2)).run()
    for em, stats in _launch(ranks.engine_run, 2, packed, lengths, 100):
        np.testing.assert_array_equal(em, j_em)
        assert stats["queue_compactions"] >= 1
        assert stats["collectives_per_round"] == 7
        assert stats["graphed_flushes"] == 0
        assert stats["collective_host_s"] is not None


def test_count_outside_a_capture_adds_at_once():
    class Counted:
        launches = 0
        collectives = 3

    assert not graphs.capturing()
    graphs.count(Counted)
    graphs.count(Counted, "collectives")
    assert (Counted.launches, Counted.collectives) == (1, 4)


# ---------------- on the card ----------------

def test_cuda_graphed_engine_equals_cpu_runner(cuda_device):
    """At 4,000 reads the engine (a program-cache miss) calls one round,
    captures it and replays it: the emissions equal the CPU runner's, and
    verify_rows counted one launch a round run (the called round and
    every replay). A second engine on other reads of the same shape finds
    the runner in the cache: it calls no round, captures nothing, and
    equals the CPU runner too."""
    from spring_tpu_torch import api
    api.clear_program_cache()
    cfg = teng.ReorderConfig(max_readlen=100)
    for seed, cache in ((4000, "miss"), (4001, "hit")):
        packed, lengths = _reads(4000, seed=seed, genome=20_000)
        want = teng.ReorderEngine(packed, lengths, cfg, device="cpu").run()
        kernels.verify_rows.launches = 0
        got = teng.ReorderEngine(packed, lengths, cfg,
                                 device=cuda_device).run()
        torch.cuda.synchronize()
        stats = teng.LAST_RUN_STATS
        np.testing.assert_array_equal(got, want)
        called = 1 if cache == "miss" else 0
        assert stats["program_cache"] == cache
        assert stats["eager_rounds"] == called
        assert stats["graphed_flushes"] == stats["flushes"] - called
        assert stats["round_replays"] == stats["rounds_run"] - called
        assert kernels.verify_rows.launches == stats["rounds_run"]
        assert (stats["capture_s"] is not None) == (cache == "miss")
        assert stats["cached_program_bytes"] > stats["graph_pool_bytes"] > 0
    api.clear_program_cache()


def test_cuda_graphed_dist_engine_without_group(cuda_device):
    """The distributed engine at one rank with no group on the card: the
    emissions equal the CPU run's, and masked_hamming_rows counted one
    launch a round run."""
    packed, lengths = _reads(900, seed=23, genome=4000, short_every=50)
    cfg = tdist.DistConfig(max_readlen=100)
    want = tdist.DistReorderEngine(
        packed, lengths, cfg,
        world=tmh.World(None, 0, 1, torch.device("cpu"))).run()
    for cache in ("miss", "hit"):
        if cache == "miss":
            tmh.shutdown()          # no group; empties the program cache
        kernels.masked_hamming_rows.launches = 0
        got = tdist.DistReorderEngine(
            packed, lengths, cfg,
            world=tmh.World(None, 0, 1, cuda_device)).run()
        torch.cuda.synchronize()
        stats = teng.LAST_RUN_STATS
        np.testing.assert_array_equal(got, want)
        assert stats["program_cache"] == cache
        assert stats["graphed_flushes"] >= 1
        assert kernels.masked_hamming_rows.launches == stats["rounds_run"]


def test_cuda_graphed_engine_with_compaction_and_16_rounds(cuda_device):
    """The graphed single engine at flush_rounds 16 with dictionary
    compactions (pair rows rewritten in place between replays) equals the
    CPU runner, with one verify_rows launch a round run."""
    from spring_tpu_torch import api
    api.clear_program_cache()
    cfg = teng.ReorderConfig(max_readlen=100, flush_rounds=16,
                             rebuild_fraction=0.05)
    packed, lengths = _reads(4000, seed=4002, genome=12_000)
    want = teng.ReorderEngine(packed, lengths, cfg, device="cpu").run()
    cpu = dict(teng.LAST_RUN_STATS)
    kernels.verify_rows.launches = 0
    got = teng.ReorderEngine(packed, lengths, cfg, device=cuda_device).run()
    torch.cuda.synchronize()
    stats = teng.LAST_RUN_STATS
    np.testing.assert_array_equal(got, want)
    assert stats["dict_compactions"] == cpu["dict_compactions"] >= 1
    assert stats["rounds_run"] == 16 * stats["flushes"]
    assert stats["round_replays"] == stats["rounds_run"] - 1
    assert kernels.verify_rows.launches == stats["rounds_run"]
    api.clear_program_cache()


def test_cuda_graphed_dist_engine_with_compaction_and_16_rounds(cuda_device):
    """The graphed distributed engine (one rank, no group) at
    flush_rounds 16 with dictionary compactions equals the CPU run, with
    one masked_hamming_rows launch a round run."""
    packed, lengths = _reads(900, seed=24, genome=3000, short_every=50)
    cfg = tdist.DistConfig(max_readlen=100, flush_rounds=16,
                           rebuild_fraction=0.05)
    want = tdist.DistReorderEngine(
        packed, lengths, cfg,
        world=tmh.World(None, 0, 1, torch.device("cpu"))).run()
    cpu = dict(teng.LAST_RUN_STATS)
    tmh.shutdown()          # no group; empties the program cache
    kernels.masked_hamming_rows.launches = 0
    got = tdist.DistReorderEngine(
        packed, lengths, cfg, world=tmh.World(None, 0, 1, cuda_device)).run()
    torch.cuda.synchronize()
    stats = teng.LAST_RUN_STATS
    np.testing.assert_array_equal(got, want)
    assert stats["dict_compactions"] == cpu["dict_compactions"] >= 1
    assert stats["graphed_flushes"] == stats["flushes"] - 1
    assert kernels.masked_hamming_rows.launches == stats["rounds_run"]
    tmh.shutdown()
