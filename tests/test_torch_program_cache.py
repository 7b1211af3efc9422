"""The program cache (spring_tpu_torch/ops/graphs.py) and the flush runner
that an engine leaves there, against spring_tpu (JAX on the CPU),
exactly: engines of one shape on different reads, run one after another
on one cached runner, each give the JAX engine's emissions on the same
reads, as a run after clear_program_cache() does; an engine of another
shape evicts the runner; the same for the distributed engine at world
sizes 1 and 2 (gloo); and, through a CPU stand-in for ops/graphs.Graph
that records a body at capture and runs it at each replay, the card's
schedule of one called round and 31 replayed ones in the first flush.
Engines that differ only in far_near, cap_per_round or flush_rounds miss
the cache; a dictionary compaction rewrites the runner's pair rows in
place (their address pinned), on a miss and on a hit, exact against JAX.
"""
import numpy as np
import pytest
import torch

from spring_tpu_torch import api
from spring_tpu_torch.ops import graphs
from spring_tpu_torch.parallel import dist as tdist
from spring_tpu_torch.parallel import multihost as tmh
from spring_tpu_torch.reorder import engine as teng
from test_torch_flush_graph import _jax, _launch, _reads

import test_torch_dist_ranks as ranks


@pytest.fixture(autouse=True)
def empty_cache():
    api.clear_program_cache()
    yield
    api.clear_program_cache()


def _sets(n, seeds, genome, short_every=0):
    return [_reads(n, seed=s, genome=genome, short_every=short_every)
            for s in seeds]


def _jax_single(packed, lengths, max_readlen=100):
    _, jeng = _jax()
    return jeng.ReorderEngine(
        packed, lengths, jeng.ReorderConfig(max_readlen=max_readlen)).run()


def _single(packed, lengths, max_readlen=100):
    em = teng.ReorderEngine(packed, lengths,
                            teng.ReorderConfig(max_readlen=max_readlen),
                            device="cpu").run()
    return em, dict(teng.LAST_RUN_STATS)


def test_engines_of_one_shape_share_the_runner_and_equal_jax():
    """A, B, A, C (three read sets of one shape) on one cached runner:
    every run equals the JAX engine on its reads, and A equals itself
    after clear_program_cache()."""
    sets = _sets(2048, (31, 32, 33), genome=9000)   # Np = N: no padding
    want = [_jax_single(*s) for s in sets]
    order = [0, 1, 0, 2]
    for k, i in enumerate(order):
        em, stats = _single(*sets[i])
        np.testing.assert_array_equal(em, want[i], err_msg=f"run {k}")
        assert stats["program_cache"] == ("miss" if k == 0 else "hit")
        assert stats["eager_rounds"] == stats["rounds_run"]   # the CPU
        assert stats["cached_program_bytes"] > 0
    (_, runner), = graphs._programs.values()
    assert stats["cached_program_bytes"] == runner.nbytes()
    api.clear_program_cache()
    assert not graphs._programs
    em, stats = _single(*sets[0])
    np.testing.assert_array_equal(em, want[0])
    assert stats["program_cache"] == "miss"


def test_another_shape_evicts_the_runner():
    """Another padded read count, another word count W, or other
    dictionary windows at the same W and Np: each misses, frees the
    runner before it, and still equals the JAX engine."""
    a, = _sets(2000, (41,), genome=9000)
    b, = _sets(5000, (42,), genome=20000)           # Np 8192 against 2048
    short = a[0][:, :5].copy(), np.minimum(a[1], 80)   # W 5 against 7
    runs = [(a, 100, "miss"), (a, 100, "hit"), (b, 100, "miss"),
            (a, 100, "miss"), (a, 97, "miss"), (short, 80, "miss"),
            (short, 80, "hit")]
    for k, ((packed, lengths), ml, cache) in enumerate(runs):
        em, stats = _single(packed, lengths, ml)
        np.testing.assert_array_equal(
            em, _jax_single(packed, lengths, ml), err_msg=f"run {k}")
        assert stats["program_cache"] == cache, k
        assert len(graphs._programs) == 1


def test_bind_refuses_a_buffer_of_another_shape():
    packed, lengths = _reads(2000, seed=43, genome=9000)
    e = teng.ReorderEngine(packed, lengths,
                           teng.ReorderConfig(max_readlen=100), device="cpu")
    e.run()
    (_, runner), = graphs._programs.values()
    state = {k: v.clone() for k, v in runner.state.items()}
    inputs = dict(runner.inputs)
    inputs["seed_order"] = inputs["seed_order"][:-1]
    with pytest.raises(ValueError, match="seed_order"):
        runner.bind(state, inputs)


def _jax_dist(packed, lengths, n):
    jdist, _ = _jax()
    return jdist.DistReorderEngine(packed, lengths,
                                   jdist.DistConfig(max_readlen=100),
                                   mesh=jdist.make_mesh(n)).run()


def test_dist_engine_world_size_1_shares_the_runner_and_equals_jax():
    sets = _sets(900, (51, 52), genome=4000, short_every=50)
    world = tmh.World(None, 0, 1, torch.device("cpu"))
    caches = []
    for i in (0, 1, 0):
        em = tdist.DistReorderEngine(
            *sets[i], tdist.DistConfig(max_readlen=100), world=world).run()
        np.testing.assert_array_equal(em, _jax_dist(*sets[i], 1))
        caches.append(teng.LAST_RUN_STATS["program_cache"])
    assert caches == ["miss", "hit", "hit"]


def test_dist_engine_world_size_2_shares_the_runner_and_equals_jax():
    """Two ranks over gloo run A, B, A, then A again after
    clear_program_cache(): each run equals the JAX DistReorderEngine on a
    mesh of 2, on both ranks, with seven collectives a round."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    sets = _sets(900, (61, 62), genome=4000, short_every=50)
    want = [_jax_dist(*s, 2) for s in sets]
    order = [0, 1, 0, 0]
    for runs in _launch(ranks.engine_runs, 2, [sets[i] for i in order], 100,
                        (3,)):
        for k, (i, (em, (cache, eager, coll))) in enumerate(
                zip(order, runs)):
            np.testing.assert_array_equal(em, want[i], err_msg=f"run {k}")
            assert cache == ("miss" if k in (0, 3) else "hit"), k
            assert coll == 7


class StandInGraph:
    """ops/graphs.Graph on the CPU: the capture records the body and runs
    nothing; each replay runs it and rewrites the outputs."""
    captures = 0
    pool = None

    def __init__(self, body, device, pool=None):
        StandInGraph.captures += 1
        self.body = body
        self.outputs = None
        self.replays = 0

    def replay(self):
        self.outputs = self.body()
        self.replays += 1

    def recount(self, old, new):
        pass

    def reset(self):
        self.outputs = None


def test_one_called_round_then_replays_equals_jax(monkeypatch):
    """With graphs on (the stand-in), a miss calls one round, captures
    the round and replays it for the first flush's other 31, calls the
    compaction and captures it; every later flush replays both. The round
    counter, emission stack and counts give the JAX engine's emissions
    exactly, on the miss and on a hit after it, which captures nothing
    and calls no round."""
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(graphs, "Graph", StandInGraph)
    sets = _sets(2000, (71, 72), genome=9000)
    for i, cache in ((0, "miss"), (1, "hit"), (0, "hit")):
        StandInGraph.captures = 0
        em, s = _single(*sets[i])
        np.testing.assert_array_equal(em, _jax_single(*sets[i]))
        miss = cache == "miss"
        assert s["program_cache"] == cache
        assert s["eager_rounds"] == (1 if miss else 0)
        assert StandInGraph.captures == (2 if miss else 0)
        assert s["round_replays"] == s["rounds_run"] - s["eager_rounds"]
        assert s["graphed_flushes"] == s["flushes"] - (1 if miss else 0)
        assert (s["capture_s"] is None) == (not miss)
        assert s["flushes"] >= 3 and s["queue_compactions"] >= 1


# ---------------- the engine's knobs and dictionary compaction ----------

def _jax_knobbed(monkeypatch, packed, lengths, rebuild_fraction=None,
                 flush_rounds=None, **cfg):
    """The JAX engine under the module globals the port's ReorderConfig
    fields stand for; its program cache is cleared around the run (it is
    not keyed on FLUSH_ROUNDS)."""
    _, jeng = _jax()
    with monkeypatch.context() as m:
        if rebuild_fraction is not None:
            m.setattr(jeng, "REBUILD_FRACTION", rebuild_fraction)
        if flush_rounds is not None:
            m.setattr(jeng, "FLUSH_ROUNDS", flush_rounds)
        if "cap_per_round" in cfg:
            m.setenv("SPRING_TPU_CAP_PER_ROUND", str(cfg.pop("cap_per_round")))
        jeng._flush_program.cache_clear()
        try:
            return jeng.ReorderEngine(packed, lengths, jeng.ReorderConfig(
                max_readlen=100, **cfg)).run()
        finally:
            jeng._flush_program.cache_clear()


def _knobbed(packed, lengths, **knobs):
    em = teng.ReorderEngine(packed, lengths,
                            teng.ReorderConfig(max_readlen=100, **knobs),
                            device="cpu").run()
    return em, dict(teng.LAST_RUN_STATS)


def test_a_knob_of_the_program_misses_the_cache(monkeypatch):
    """Engines of one shape that differ only in far_near, cap_per_round
    or flush_rounds each miss the cache (rebuild_fraction, read by the
    host loop, hits it); a repeat hits, and equals JAX."""
    a, = _sets(2000, (101,), genome=9000)
    runs = [({}, "miss"), (dict(far_near=4), "miss"),
            (dict(far_near=4), "hit"), (dict(cap_per_round=6), "miss"),
            (dict(flush_rounds=16), "miss"),
            (dict(flush_rounds=16, rebuild_fraction=0.05), "hit")]
    for k, (knobs, cache) in enumerate(runs):
        em, stats = _knobbed(*a, **knobs)
        assert stats["program_cache"] == cache, k
        assert len(graphs._programs) == 1
    np.testing.assert_array_equal(
        em, _jax_knobbed(monkeypatch, *a, rebuild_fraction=0.05,
                         flush_rounds=16))
    assert stats["dict_compactions"] >= 1


def _record_pairs(monkeypatch, key):
    """Record, at each flush, the address of the runner's pair rows and,
    at the first flush, a copy of them."""
    seen = dict(ptrs=[], first=None)
    flush = teng.FlushRunner.flush

    def recorded(runner):
        pairs = runner.inputs[key]
        seen["ptrs"].append(pairs.data_ptr())
        if seen["first"] is None:
            seen["first"] = pairs.clone()
        seen["last"] = pairs
        return flush(runner)

    monkeypatch.setattr(teng.FlushRunner, "flush", recorded)
    return seen


def test_compaction_rewrites_pairs_all_in_place(monkeypatch):
    """A dictionary compaction writes the new pair rows into the runner's
    pairs_all buffer: its address stays through the run (the card's
    graphs read it there), and its contents change."""
    a, = _sets(3000, (102,), genome=9000)
    seen = _record_pairs(monkeypatch, "pairs_all")
    em, stats = _knobbed(*a, rebuild_fraction=0.05)
    assert stats["dict_compactions"] >= 2
    assert len(seen["ptrs"]) == stats["flushes"]
    assert len(set(seen["ptrs"])) == 1
    assert not torch.equal(seen["first"], seen["last"])
    np.testing.assert_array_equal(
        em, _jax_knobbed(monkeypatch, *a, rebuild_fraction=0.05))


def test_dist_compaction_rewrites_pairs_in_place(monkeypatch):
    """The same for the distributed engine's pairs buffer, at world size
    1, and the run equals JAX's."""
    jdist, jeng = _jax()
    packed, lengths = _reads(900, seed=103, genome=3000, short_every=50)
    seen = _record_pairs(monkeypatch, "pairs")
    world = tmh.World(None, 0, 1, torch.device("cpu"))
    em = tdist.DistReorderEngine(
        packed, lengths, tdist.DistConfig(max_readlen=100,
                                          rebuild_fraction=0.05),
        world=world).run()
    stats = teng.LAST_RUN_STATS
    assert stats["dict_compactions"] >= 2
    assert len(set(seen["ptrs"])) == 1
    assert not torch.equal(seen["first"], seen["last"])
    monkeypatch.setattr(jeng, "REBUILD_FRACTION", 0.05)
    np.testing.assert_array_equal(em, _jax_dist(packed, lengths, 1))


def test_a_hit_after_a_compacting_run_equals_jax(monkeypatch):
    """A compacting run leaves its runner in the cache with compacted
    pair rows; the next engine of the key binds its own (uncompacted)
    rows and compacts them in turn: both runs equal JAX."""
    sets = _sets(2500, (104, 105), genome=9000)
    for i, cache in ((0, "miss"), (1, "hit")):
        em, stats = _knobbed(*sets[i], rebuild_fraction=0.05)
        assert stats["program_cache"] == cache
        assert stats["dict_compactions"] >= 1
        np.testing.assert_array_equal(
            em, _jax_knobbed(monkeypatch, *sets[i], rebuild_fraction=0.05))


def test_card_schedule_with_compaction_and_16_rounds_equals_jax(monkeypatch):
    """The card's schedule (the stand-in Graph) at flush_rounds 16 with
    dictionary compactions: a miss calls one round and replays 15 in the
    first flush, the compactions rewrite the pairs between replays, and
    the emissions equal JAX's."""
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(graphs, "Graph", StandInGraph)
    a, = _sets(2500, (106,), genome=9000)
    StandInGraph.captures = 0
    em, s = _knobbed(*a, rebuild_fraction=0.05, flush_rounds=16)
    assert s["program_cache"] == "miss" and s["eager_rounds"] == 1
    assert StandInGraph.captures == 2
    assert s["round_replays"] == s["rounds_run"] - 1
    assert s["rounds_run"] == 16 * s["flushes"]
    assert s["dict_compactions"] >= 1
    np.testing.assert_array_equal(
        em, _jax_knobbed(monkeypatch, *a, rebuild_fraction=0.05,
                         flush_rounds=16))
