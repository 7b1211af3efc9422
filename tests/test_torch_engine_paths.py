"""The reorder engine's tuning paths against spring_tpu (JAX on the CPU),
exactly: in-bin dictionary compaction (dictionary.compact_bins_dev, the
single engine's trigger and pair-row rebuild, the distributed engine's
local compact step), far-shift dictionary thinning
(ReorderConfig.far_near), the emission slots a round (cap_per_round), the
flush length (flush_rounds), and assemble_contigs.

The JAX package reads these settings from its environment and module
globals, so its side is set through monkeypatch: the variables its
engine reads at construction, and REBUILD_FRACTION and FLUSH_ROUNDS of
spring_tpu.reorder.engine, with the JAX program caches (not keyed on
FLUSH_ROUNDS) cleared before and after.
"""
import numpy as np
import pytest
import torch

import test_torch_dist_ranks as ranks
from spring_tpu_torch import api, convert
from spring_tpu_torch.parallel import dist as tdist
from spring_tpu_torch.parallel import multihost as tmh
from spring_tpu_torch.reorder import dictionary as tdct
from spring_tpu_torch.reorder import engine as teng
from test_torch_flush_graph import _launch, _np, _reads

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from spring_tpu.parallel import dist as jdist  # noqa: E402
from spring_tpu.reorder import dictionary as jdct  # noqa: E402
from spring_tpu.reorder import engine as jeng  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_programs():
    """No cached program of either package outlives a test: the JAX
    caches are not keyed on FLUSH_ROUNDS, which a test may patch."""
    def clear():
        jeng._flush_program.cache_clear()
        jdist._dist_programs.cache_clear()
        api.clear_program_cache()
    clear()
    yield
    clear()


def _jax_knobs(monkeypatch, knobs: dict) -> dict:
    """Set the JAX engines' counterparts of ReorderConfig knobs; returns
    the fields the JAX ReorderConfig takes itself."""
    cfg = {}
    for k, v in knobs.items():
        if k == "far_near":
            cfg[k] = v
        elif k == "cap_per_round":
            monkeypatch.setenv("SPRING_TPU_CAP_PER_ROUND", str(v))
        elif k == "rebuild_fraction":
            monkeypatch.setattr(jeng, "REBUILD_FRACTION", v)
        elif k == "flush_rounds":
            monkeypatch.setattr(jeng, "FLUSH_ROUNDS", v)
        else:
            raise KeyError(k)
    return cfg


# ---------------- compact_bins_dev ----------------

def _bins(seed, n, n_keys):
    """A dictionary's sorted bins as the build leaves them: keys (uint32,
    some with bit 31 set) in ascending order, rids ascending within a key,
    a tenth of the entries empty (-1) and a few other negative rids; a
    claimed bitmap of Np = 2n bits (words with bit 31 set) and its bools
    per rid."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                  0xFFFFFFFF], np.uint32),
        rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)])
    keys = rng.choice(pool, n)
    rids = rng.permutation(2 * n)[:n].astype(np.int32)
    order = np.lexsort((rids, keys))
    keys, rids = keys[order], rids[order]
    rids[rng.random(n) < 0.1] = -1
    rids[rng.random(n) < 0.01] = rng.integers(-2**31, -1)
    Np = 2 * n
    bools = rng.random(Np + 64) < 0.35
    claimed = np.packbits(bools, bitorder="little").view(np.uint32)
    return keys, rids, claimed, bools


@pytest.mark.parametrize("seed,n,n_keys", [(1, 4096, 40), (2, 1 << 14, 3000)])
def test_compact_bins_dev_equals_jax_and_numpy(seed, n, n_keys):
    keys, rids, claimed, bools = _bins(seed, n, n_keys)
    assert (claimed.view(np.int32) < 0).any()
    want = np.asarray(jdct.compact_bins_dev(
        jnp.asarray(keys), jnp.asarray(rids), jnp.asarray(claimed)))
    got = tdct.compact_bins_dev(torch.from_numpy(keys.view(np.int32)),
                                torch.from_numpy(rids),
                                torch.from_numpy(claimed.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdct.compact_bins(rids, keys, bools), want)
    np.testing.assert_array_equal(tdct.compact_bins(rids, keys, bools),
                                  jdct.compact_bins(rids, keys, bools))
    # live entries moved forward within their bins, and some died
    assert (want == -1).sum() > (rids < 0).sum()
    assert (want >= 0).sum() == ((rids >= 0) & ~bools[np.clip(rids, 0, None)]
                                 ).sum()


# ---------------- one flush from the JAX entry state ----------------

@pytest.fixture(scope="module")
def entry():
    import __graft_entry__
    _, args = __graft_entry__.entry()
    return args


@pytest.mark.parametrize("far_near,cap_per_round",
                         [(1, 3), (4, 3), (15, 3), (16, 3), (4, 6)])
def test_one_flush_thinned_equals_jax(entry, far_near, cap_per_round):
    """One flush at far_near (shifts past it probe one dictionary; 16,
    the shift chunk, thins nothing) and cap_per_round from the state of
    __graft_entry__.entry(): state, counts, stats and the dense emissions
    equal JAX's, and the emission buffer has the JAX program's size."""
    args = entry
    Np = int(args[7].shape[0])
    cfg = jeng.ReorderConfig(max_readlen=96)
    starts = tuple(w.start for w in jeng.dct.default_windows(96))
    sig = (Np, cfg.candidates, cfg.shift_chunk, cfg.accept_slots, starts,
           cfg.thresh, far_near, cap_per_round)
    _, j_flush, j_cap = jeng._flush_program(*sig)
    _, _, t_cap, t_runner = teng._flush_program(*sig)
    assert t_cap == j_cap
    state0 = {k: np.asarray(v) for k, v in args[0].items()}
    j_state, j_dense, j_cnt, j_stats = j_flush(
        {k: jnp.asarray(v) for k, v in state0.items()}, *args[1:])
    t = [convert.to_torch(np.asarray(a), "cpu") for a in args[1:5]]
    runner = t_runner(convert.state_to_torch(state0, "cpu"), *t,
                      int(args[5]), int(args[6]),
                      convert.to_torch(np.asarray(args[7]), "cpu"))
    dense, cnt, stats = runner.flush()
    got = convert.state_to_numpy(runner.state)
    for k, v in j_state.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(_np(cnt), np.asarray(j_cnt))
    np.testing.assert_array_equal(_np(stats), np.asarray(j_stats))
    np.testing.assert_array_equal(_np(dense)[:-1], np.asarray(j_dense)[:-1])
    assert int(np.asarray(j_stats)[3]) > 0


# ---------------- whole engine runs ----------------

def _engine_pair(monkeypatch, knobs, n=3000, seed=3000, genome=12_000):
    """The port's and the JAX engine's emissions and stats on one read
    set with these ReorderConfig knobs."""
    packed, lengths = _reads(n, seed=seed, genome=genome)
    jcfg = _jax_knobs(monkeypatch, knobs)
    want = jeng.ReorderEngine(packed, lengths, jeng.ReorderConfig(
        max_readlen=100, **jcfg)).run()
    j_stats = dict(jeng.LAST_RUN_STATS)
    got = teng.ReorderEngine(packed, lengths, teng.ReorderConfig(
        max_readlen=100, **knobs), device="cpu").run()
    return got, want, dict(teng.LAST_RUN_STATS), j_stats


@pytest.mark.parametrize("knobs", [
    dict(far_near=4), dict(cap_per_round=6), dict(flush_rounds=16),
    dict(rebuild_fraction=0.05)], ids=lambda k: next(iter(k)))
def test_engine_run_equals_jax(monkeypatch, knobs):
    got, want, stats, j_stats = _engine_pair(monkeypatch, knobs)
    np.testing.assert_array_equal(got, want)
    assert stats["rounds"] == j_stats["rounds"]
    fr = knobs.get("flush_rounds", teng.FLUSH_ROUNDS)
    assert stats["rounds_run"] == stats["flushes"] * fr
    assert stats["rounds"] % fr == 0
    if "rebuild_fraction" in knobs:
        assert stats["dict_compactions"] >= 2
        assert stats["queue_compactions"] >= 1
        assert stats["dict_compact_s"] > 0
    else:
        assert stats["dict_compactions"] == 0


def test_dict_compaction_changes_the_run(monkeypatch):
    """The compaction is not idle at this size: with every knob at once,
    the run still equals JAX's, and the emissions differ from the same
    run without compaction."""
    knobs = dict(far_near=4, cap_per_round=6, flush_rounds=16,
                 rebuild_fraction=0.05)
    got, want, stats, _ = _engine_pair(monkeypatch, knobs, n=4000,
                                       seed=3001, genome=8000)
    np.testing.assert_array_equal(got, want)
    assert stats["dict_compactions"] >= 2
    api.clear_program_cache()
    plain = teng.ReorderEngine(*_reads(4000, seed=3001, genome=8000),
                               teng.ReorderConfig(
                                   max_readlen=100, far_near=4,
                                   cap_per_round=6, flush_rounds=16),
                               device="cpu").run()
    assert not np.array_equal(plain, got)


# ---------------- the distributed engine ----------------

def _jax_dist(monkeypatch, packed, lengths, n, knobs):
    _jax_knobs(monkeypatch, knobs)
    return jdist.DistReorderEngine(packed, lengths,
                                   jdist.DistConfig(max_readlen=100),
                                   mesh=jdist.make_mesh(n)).run()


@pytest.mark.parametrize("knobs", [
    dict(rebuild_fraction=0.05),
    dict(rebuild_fraction=0.05, flush_rounds=16)],
    ids=["rebuild", "rebuild+flush16"])
def test_dist_world_size_1_equals_jax(monkeypatch, knobs):
    packed, lengths = _reads(900, seed=81, genome=3000, short_every=50)
    want = _jax_dist(monkeypatch, packed, lengths, 1, knobs)
    world = tmh.World(None, 0, 1, torch.device("cpu"))
    got = tdist.DistReorderEngine(
        packed, lengths, tdist.DistConfig(max_readlen=100, **knobs),
        world=world).run()
    stats = teng.LAST_RUN_STATS
    np.testing.assert_array_equal(got, want)
    assert stats["dict_compactions"] >= 2
    assert stats["collectives"] == 0          # one rank, no group
    fr = knobs.get("flush_rounds", teng.FLUSH_ROUNDS)
    assert stats["rounds_run"] == stats["flushes"] * fr


def test_dist_world_size_2_equals_jax(monkeypatch):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    knobs = dict(rebuild_fraction=0.05)
    packed, lengths = _reads(900, seed=82, genome=3000, short_every=50)
    want = _jax_dist(monkeypatch, packed, lengths, 2, knobs)
    for em, stats in _launch(ranks.engine_run, 2, packed, lengths, 100,
                             knobs):
        np.testing.assert_array_equal(em, want)
        assert stats["dict_compactions"] >= 2
        assert stats["collectives_per_round"] == 7


# ---------------- assemble_contigs ----------------

def test_assemble_contigs_ordered_equals_jax():
    """On the emissions of one engine run (a filtered walker-major
    stream, left-phase reads included)."""
    packed, lengths = _reads(2000, seed=91, genome=9000)
    em = teng.ReorderEngine(packed, lengths,
                            teng.ReorderConfig(max_readlen=100),
                            device="cpu").run()
    assert (em[:, 1] == 2).any()
    want = jeng.assemble_contigs(em, lengths=lengths, ordered=True)
    got = teng.assemble_contigs(em, lengths=lengths, ordered=True)
    _same_contigs(got, want)
    assert sum(len(c["rids"]) for c in got) == len(em)


def test_assemble_contigs_round_major_equals_jax():
    """On a round-major (R, walkers, slots) array with empty slots: each
    walker's column is seeds (flag 0) followed by forward (1) and left
    (2) reads."""
    rng = np.random.default_rng(92)
    R, B, S = 40, 6, 3
    lengths = rng.integers(60, 101, 1000).astype(np.int32)
    em = np.full((R, B, S, 4), -1, np.int32)
    rid = 0
    for w in range(B):
        flag = 0
        for r in range(R):
            for s in range(S):
                if rng.random() < 0.3:
                    continue
                f = 0 if rng.random() < 0.15 or rid == 0 else flag
                em[r, w, s] = (rid, f, rng.integers(0, 30), rng.integers(2))
                flag = 1 if f == 0 else (2 if rng.random() < 0.1 else f)
                rid += 1
        em[0, w, 0] = (rid, 0, 0, 0)
        rid += 1
    em = em.reshape(-1, 4)
    with pytest.raises(ValueError, match="lengths"):
        teng.assemble_contigs(em, num_walkers=B, slots=S)
    want = jeng.assemble_contigs(em, num_walkers=B, lengths=lengths,
                                 slots=S)
    got = teng.assemble_contigs(em, num_walkers=B, lengths=lengths, slots=S)
    _same_contigs(got, want)
    assert len(got) > B


def _same_contigs(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype, k
