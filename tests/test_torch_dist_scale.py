"""The distributed engine's program sizes at the JAX package's dist-bench
shapes (tools/bench_dist.py, DIST_BENCH.json): 1M reads (Np 2^20, B
4096), 10M (Np 2^24, B 8192) and 100M (Np 2^27, B 8192), 100 bp reads,
over 1, 2 and 4 ranks. spring_tpu_torch.parallel.dist._dist_programs
against spring_tpu.parallel.dist._dist_programs on a mesh of as many
virtual CPU devices; the JAX function's exchange capacities are read
from its frame as it returns (it does not return them). Neither side
traces, compiles or allocates anything of these shapes: both only size
their programs."""
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from spring_tpu.parallel import dist as jdist  # noqa: E402
from spring_tpu_torch.parallel import dist as tdist  # noqa: E402
from spring_tpu_torch.parallel import multihost as tmh  # noqa: E402
from spring_tpu_torch.reorder import dictionary as tdct  # noqa: E402

READ_LEN = 100
W = 7
SHAPES = {"1M": (1 << 20, 4096), "10M": (1 << 24, 8192),
          "100M": (1 << 27, 8192)}
CAPS = ("capk", "capq", "capc", "capr", "R", "S")


def _args(Np, B):
    cfg = tdist.DistConfig(max_readlen=READ_LEN)
    starts = tuple(w.start for w in tdct.default_windows(READ_LEN))
    return (Np, W, B, cfg.candidates, cfg.shift_chunk, cfg.accept_slots,
            starts, cfg.thresh, cfg.capacity_factor)


def _mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jdist.make_mesh(n)


def _jax_programs(n, Np, B):
    """JAX's programs for this shape (past its lru_cache) and the locals
    of its frame when it returned or raised."""
    fn = jdist._dist_programs.__wrapped__
    seen = {}

    def profile(frame, event, arg):
        if event == "return" and frame.f_code is fn.__code__:
            seen.update(frame.f_locals)

    old = sys.getprofile()
    sys.setprofile(profile)
    try:
        return fn(_mesh(n), *_args(Np, B)), seen
    except ValueError as e:
        return e, seen
    finally:
        sys.setprofile(old)


def _torch_programs(n, Np, B):
    """The port's programs for rank 0 of an n-rank world (no group: the
    sizing reads only the world's size and rank)."""
    world = tmh.World(None, 0, n, torch.device("cpu"))
    try:
        return tdist._dist_programs(world, *_args(Np, B))
    except ValueError as e:
        return e


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", ["1M", "10M"])
def test_dist_sizes_equal_jax(shape, n):
    Np, B = SHAPES[shape]
    jp, jl = _jax_programs(n, Np, B)
    tp = _torch_programs(n, Np, B)
    for k in ("CAP", "Bl", "Npl", "M"):
        assert tp[k] == jp[k], k
    assert tp["exchange"] == {k: int(jl[k]) for k in CAPS}
    assert tp["Bl"] == B // n and tp["Npl"] == Np // n


def test_dist_sizes_at_the_10M_shape_on_one_rank():
    """The tables one rank of a 10M-read input sizes: every key of its
    2^24 rows in both windows, 2^25 entries against the compact table's
    2^27, and the probe, candidate and row exchanges at B = 8192."""
    tp = _torch_programs(1, *SHAPES["10M"])
    ex = tp["exchange"]
    assert (tp["Bl"], tp["M"]) == (8192, 16)
    assert ex["capk"] == ex["R"] == 1 << 25
    assert tdct.MAX_COMPACT_ENTRIES == 1 << 27
    assert ex["capq"] == 8192 * 64 == 524_288
    assert ex["capc"] == 8192 * 8
    assert ex["capr"] == 8192 * (16 + 2) == 147_456
    assert ex["S"] == 1 << 24          # 8 slots a bucket, half of them used


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dist_100M_shape_needs_four_ranks(n):
    """At Np 2^27 a rank's merged table holds 2^28 entries at n = 1 and
    2: both packages refuse it. At n = 4 it holds 2^27 and both build."""
    Np, B = SHAPES["100M"]
    jp, jl = _jax_programs(n, Np, B)
    tp = _torch_programs(n, Np, B)
    assert int(jl["R"]) == (1 << 28 if n < 4 else 1 << 27)
    if n < 4:
        for e in (jp, tp):
            assert isinstance(e, ValueError)
            assert "exceeds the compact table" in str(e)
        return
    assert not isinstance(jp, Exception) and not isinstance(tp, Exception)
    for k in ("CAP", "Bl", "Npl", "M"):
        assert tp[k] == jp[k], k
    assert tp["exchange"] == {k: int(jl[k]) for k in CAPS}
    assert tp["exchange"]["R"] == tdct.MAX_COMPACT_ENTRIES


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", ["1M", "10M", "100M"])
def test_dist_flat_indices_fit_int32(shape, n):
    """Every flat index the round and the build take as int32 stays below
    2^31 at these shapes: the exchange tables (n * cap slots; the row
    replies n * capr * (W + 1) words, the candidate replies n * capc * C),
    the claimed bitmap's Np / 32 + 2 words, the global rids
    me * Npl + arange(Npl) and the merged table's flat words."""
    Np, B = SHAPES[shape]
    tp = _torch_programs(n, Np, B)
    if isinstance(tp, ValueError):
        assert shape == "100M" and n < 4
        return
    C = tdist.DistConfig(max_readlen=READ_LEN).candidates
    ex = tp["exchange"]
    top = max(n * ex["capk"], n * ex["capq"], n * ex["capc"] * C,
              n * ex["capr"] * (W + 1), Np // 32 + 2, Np, ex["R"],
              (ex["S"] + 1) * tdct.COMPACT_WORDS)
    assert top < 2**31, top


def test_dist_build_equal_jax_at_one_rank():
    """The build, which now drops its routing tables before the hash
    build, gives JAX's outputs on 3,000 noisy reads of both strands at
    world size 1 (one rank, no group; two ranks: tests/test_torch_dist.py)."""
    from spring_tpu.io import packing
    from spring_tpu.parallel import multihost as jmh
    from spring_tpu_torch import convert
    rng = np.random.default_rng(5)
    n, L = 3000, 100
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, n)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    flip = rng.random(codes.shape) < 0.01
    codes = np.where(flip, (codes + 1) % 4, codes).astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = 3 - codes[rc][:, ::-1]
    packed = packing.pack_codes(codes)
    lengths = np.full(n, L, np.int32)
    mesh = _mesh(1)
    je = jdist.DistReorderEngine(packed, lengths,
                                 jdist.DistConfig(max_readlen=L), mesh=mesh)
    want = dict(zip(convert.DIST_BUILD_FIELDS, (np.asarray(b) for b in
                    je._prog["build"](jmh.put_sharded(mesh, je.packed)))))
    world = tmh.World(None, 0, 1, torch.device("cpu"))
    te = tdist.DistReorderEngine(packed, lengths,
                                 tdist.DistConfig(max_readlen=L),
                                 world=world)
    out = te._prog["build"](tmh.put_sharded(world, te.packed))
    got = convert.dist_build_to_numpy(
        [dict(zip(convert.DIST_BUILD_FIELDS, out))])
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert got[k].dtype == w.dtype, k
    assert (want["rids"] >= 0).sum() == 2 * n
