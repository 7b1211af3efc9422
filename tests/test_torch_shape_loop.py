"""Second chance's and contig stitching's matcher loops as one CUDA graph
each (spring_tpu_torch/ops/graphs.py::ShapeLoop): the card's schedule,
run on the CPU through the stand-in Graph of
tests/test_torch_program_cache.py (its capture records the body, each
replay runs it). A loop of more than one row chunk calls its first chunk,
captures it and replays it for every later chunk; a loop of one chunk,
and the CPU, call every chunk. Every result equals the eager call's, and
a compress whose matchers run in small chunks writes the eager CPU
compress's archive."""
import filecmp

import numpy as np
import pytest
import torch

from spring_tpu_torch import api
from spring_tpu_torch.encode import second_chance as tsc
from spring_tpu_torch.io import packing
from spring_tpu_torch.ops import graphs
from spring_tpu_torch.utils import synth
from test_torch_program_cache import StandInGraph


@pytest.fixture(autouse=True)
def empty_stats():
    graphs.LOOP_STATS.clear()
    yield
    graphs.LOOP_STATS.clear()


@pytest.fixture
def graphed(monkeypatch):
    """The card's schedule on the CPU."""
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(graphs, "Graph", StandInGraph)
    StandInGraph.captures = 0


def _case():
    rng = np.random.default_rng(5)
    total, n, L = 5000, 160, 100
    seq = rng.integers(0, 4, total).astype(np.uint8)
    pos = rng.integers(0, total - L, n)
    codes = seq[pos[:, None] + np.arange(L)[None, :]].copy()
    lens = np.full(n, L, np.int32)
    rc = rng.random(n) < 0.5
    codes[rc] = packing.revcomp_codes(codes[rc], lens[rc])
    codes[::3, 7] = (codes[::3, 7] + 1) % 4
    codes[::4, 40:45] = packing.N
    return seq, codes.astype(np.uint8), lens


def _eager(fn, *a, **k):
    """fn with every loop called chunk by chunk, at the default chunk."""
    real = graphs.enabled
    graphs.enabled = lambda device: False
    try:
        return fn(*a, **k)
    finally:
        graphs.enabled = real
        graphs.LOOP_STATS.clear()


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_second_chance_loop_replays_every_chunk_after_the_first(
        graphed, monkeypatch):
    """160 reads pad to k2 = 256, so 512 oriented rows: chunks of 64 are
    8 iterations, the first called, then one capture and 7 replays."""
    seq, codes, lens = _case()
    want = _eager(tsc.align_leftovers, seq, codes, lens, device="cpu")
    monkeypatch.setattr(tsc, "MATCH_CHUNK", 64)
    _equal(tsc.align_leftovers(seq, codes, lens, device="cpu"), want)
    assert graphs.LOOP_STATS == {"second_chance_match": dict(
        loops=1, iterations=8, captures=1, replays=7,
        capture_s=graphs.LOOP_STATS["second_chance_match"]["capture_s"],
        pool_bytes=0)}
    assert StandInGraph.captures == 1


def test_stitch_loop_with_exclude(graphed, monkeypatch):
    """The caller that passes exclude (contig stitching) has a loop of
    its own name; its self-placement veto is a chunked argument too."""
    seq, codes, lens = _case()
    pk = packing.pack_codes(codes)
    zero = np.zeros_like(pk)
    ex = np.where(np.arange(len(lens)) % 2 == 0, 0, -1).astype(np.int32)
    args = (seq, pk, zero, zero, lens)
    want = _eager(tsc.align_leftovers_packed, *args, thresh=4, exclude=ex,
                  device="cpu")
    monkeypatch.setattr(tsc, "MATCH_CHUNK", 128)
    _equal(tsc.align_leftovers_packed(*args, thresh=4, exclude=ex,
                                      device="cpu"), want)
    st = graphs.LOOP_STATS
    assert set(st) == {"stitch_match"}
    assert (st["stitch_match"]["iterations"], st["stitch_match"]["replays"]
            ) == (4, 3)
    assert StandInGraph.captures == 1


def test_one_chunk_is_called_not_captured(graphed):
    """At the default chunk the 512 rows are one chunk: a graph would be
    replayed no time, so the loop calls it and captures nothing."""
    seq, codes, lens = _case()
    want = _eager(tsc.align_leftovers, seq, codes, lens, device="cpu")
    _equal(tsc.align_leftovers(seq, codes, lens, device="cpu"), want)
    st = graphs.LOOP_STATS["second_chance_match"]
    assert (st["loops"], st["iterations"], st["captures"], st["replays"]
            ) == (1, 1, 0, 0)
    assert StandInGraph.captures == 0


def test_loop_refuses_an_argument_of_another_shape(graphed):
    """Replays copy into the first iteration's buffers: an argument of
    another shape or dtype raises; close() drops the graph."""
    base = torch.arange(8, dtype=torch.int32)
    loop = graphs.ShapeLoop("add", lambda a: a + base, 3, "cpu")
    a = torch.ones(8, dtype=torch.int32)
    np.testing.assert_array_equal(loop(a).numpy(), (base + 1).numpy())
    np.testing.assert_array_equal(loop(a * 5).numpy(), (base + 5).numpy())
    with pytest.raises(ValueError, match="loop of one shape"):
        loop(a[:4])
    with pytest.raises(ValueError, match="loop of one shape"):
        loop(a.to(torch.int64))
    loop.close()
    assert loop._graph is None and loop._var == ()
    assert graphs.LOOP_STATS["add"]["replays"] == 1


def test_cpu_loop_calls_every_iteration():
    """Without graphs (the CPU) every iteration calls the function."""
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    loop = graphs.ShapeLoop("double", fn, 3, "cpu")
    for k in range(3):
        assert int(loop(torch.tensor([k]))[0]) == 2 * k
    loop.close()
    assert len(calls) == 3
    assert graphs.LOOP_STATS["double"] == dict(
        loops=1, iterations=3, captures=0, replays=0, capture_s=0.0,
        pool_bytes=0)


def test_compress_with_small_chunks_writes_the_eager_archive(
        tmp_path, graphed, monkeypatch):
    """A whole compress with the card's schedule (flush runner and matcher
    loops through the stand-in Graph) and matcher chunks of 64 rows: both
    matchers replay their loops, and the archive is the eager CPU
    compress's, byte for byte (chip_smoke.py phase 4 holds the card to
    the same)."""
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 3000, read_len=100, genome_size=8000, seed=7,
                  n_rate=0.0005)
    opts = api.CompressOptions(num_threads=2, verbose=False)
    a_eager, a_graphed = str(tmp_path / "e.stpu"), str(tmp_path / "g.stpu")
    api.clear_program_cache()
    _eager(api.compress, [fq], a_eager, opts, device="cpu")
    api.clear_program_cache()
    monkeypatch.setattr(tsc, "MATCH_CHUNK", 64)
    try:
        api.compress([fq], a_graphed, opts, device="cpu")
    finally:
        api.clear_program_cache()
    st = graphs.LOOP_STATS
    assert set(st) == {"second_chance_match", "stitch_match"}, st
    assert all(v["replays"] == v["iterations"] - v["loops"] > 0
               for v in st.values()), st
    assert filecmp.cmp(a_eager, a_graphed, shallow=False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the loops are captured into CUDA "
                    "graphs only there")
    return torch.device("cuda")


def test_cuda_matcher_loops_equal_cpu(cuda_device, monkeypatch):
    """On the card, with chunks of 64 rows: both matchers capture their
    loop once and replay it, and give the CPU's results."""
    seq, codes, lens = _case()
    pk = packing.pack_codes(codes)
    zero = np.zeros_like(pk)
    ex = np.where(np.arange(len(lens)) % 2 == 0, 0, -1).astype(np.int32)
    want = tsc.align_leftovers(seq, codes, lens, device="cpu")
    want_ex = tsc.align_leftovers_packed(seq, pk, zero, zero, lens, thresh=4,
                                         exclude=ex, device="cpu")
    monkeypatch.setattr(tsc, "MATCH_CHUNK", 64)
    graphs.LOOP_STATS.clear()
    got = tsc.align_leftovers(seq, codes, lens, device="cuda")
    got_ex = tsc.align_leftovers_packed(seq, pk, zero, zero, lens, thresh=4,
                                        exclude=ex, device="cuda")
    _equal((*got, *got_ex), (*want, *want_ex))
    st = graphs.LOOP_STATS
    assert set(st) == {"second_chance_match", "stitch_match"}
    assert all(v["captures"] == 1 and v["replays"] == 7
               and v["pool_bytes"] >= 0 for v in st.values()), st
