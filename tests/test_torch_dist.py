"""The distributed reorder engine: spring_tpu_torch.parallel (gloo on the
CPU, ranks spawned by multihost.launch) against spring_tpu.parallel on a
virtual CPU mesh of the same size. Every comparison is exact. Whole
archives are compared in tests/test_torch_dist_archives.py."""
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_dist_ranks as ranks  # noqa: E402
from spring_tpu.io import packing  # noqa: E402
from spring_tpu.parallel import dist as jdist  # noqa: E402
from spring_tpu.parallel import multihost as jmh  # noqa: E402
from spring_tpu.reorder import dictionary as jdct  # noqa: E402
from spring_tpu_torch import convert  # noqa: E402
from spring_tpu_torch.ops import kernels  # noqa: E402
from spring_tpu_torch.parallel import dist as tdist  # noqa: E402
from spring_tpu_torch.parallel import multihost as tmh  # noqa: E402
from spring_tpu_torch.reorder import engine as teng  # noqa: E402

TIMEOUT = 240.0      # of one launch: the group's collectives and the wait


def launch(fn, n, *args):
    return tmh.launch(fn, n, args, device="cpu", timeout=TIMEOUT,
                      num_threads=1)


def _mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jdist.make_mesh(n)


def _reads_equal_len():
    """The 600 reads of 64 bases of tests/test_dist.py."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=2000).astype(np.uint8)
    L = 64
    starts = rng.integers(0, len(genome) - L, size=600)
    codes = np.stack([genome[s:s + L] for s in starts])
    return packing.pack_codes(codes), np.full(len(codes), L, np.int32), L


def _reads_unequal_len():
    """900 noisy reads of both strands, lengths 60..100, and every 50th
    read 40 bases long: too short for either dictionary window."""
    rng = np.random.default_rng(23)
    n, L = 900, 100
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, n)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    flip = rng.random(codes.shape) < 0.01
    codes = np.where(flip, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = 3 - codes[rc][:, ::-1]
    lengths = np.full(n, L, np.int32)
    lengths[::7] = rng.integers(60, L, len(lengths[::7]))
    lengths[::50] = 40
    assert max(w.start for w in jdct.default_windows(L)) + 16 > 40
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0)
    return packing.pack_codes(codes.astype(np.uint8)), lengths, L


READS = {"equal": _reads_equal_len, "unequal": _reads_unequal_len}


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


# ---------------- helpers of the exchange ----------------

def _keys(rng, q):
    """Raw 32-bit keys, half of them with the top bit set."""
    k = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32)
    k[::2] |= np.uint32(1 << 31)
    return k


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_owner_of_key(n):
    keys = _keys(np.random.default_rng(n), 4096)
    want = np.asarray(jdist._owner_of_key(jnp.asarray(keys), n))
    got = tdist._owner_of_key(_t(keys), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == n - 1


@pytest.mark.parametrize("case", ["spread", "over_capacity", "none_valid"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_dispatch_and_collect(n, case):
    """_dispatch's tables and slot map, and _collect of 1-D and 2-D
    replies through it: payloads with the top bit set, one destination
    over its capacity, nothing valid."""
    rng = np.random.default_rng(7 * n + len(case))
    Q = 500
    cap = 100 if case == "over_capacity" else 450
    keys = _keys(rng, Q)
    other = rng.integers(-2**31, 2**31, Q).astype(np.int32)
    owner = np.asarray(jdist._owner_of_key(jnp.asarray(keys), n))
    valid = rng.random(Q) < 0.8
    if case == "over_capacity":
        owner = np.where(rng.random(Q) < 0.9, n - 1, owner).astype(np.int32)
    if case == "none_valid":
        valid[:] = False
    payloads = (keys.view(np.int32), other)
    j_sends, j_slot = jdist._dispatch(
        tuple(jnp.asarray(p) for p in payloads), jnp.asarray(owner),
        jnp.asarray(valid), n, cap)
    t_sends, t_slot = tdist._dispatch(
        tuple(_t(p) for p in payloads), _t(owner), _t(valid), n, cap)
    for got, want in zip(t_sends, j_sends):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    dropped = int((np.asarray(j_slot)[valid] == n * cap).sum())
    assert (dropped > 0) == (case == "over_capacity")
    for shape in ((n * cap,), (n * cap, 3)):
        replies = rng.integers(0, 2**32, shape,
                               dtype=np.uint64).astype(np.uint32)
        want = np.asarray(jdist._collect(jnp.asarray(replies), j_slot))
        got = tdist._collect(_t(replies), t_slot)
        np.testing.assert_array_equal(
            convert.to_numpy(got, uint32=True), want)


def test_probe_meta_sc():
    """The packed (start | count) word of a compact table, for keys that
    are in it (top bit set or not) and keys that are not."""
    rng = np.random.default_rng(5)
    keys = np.repeat(_keys(rng, 700), rng.integers(1, 40, 700))
    ok = rng.random(len(keys)) < 0.9
    S = jdct.table_buckets(len(keys))
    btab = np.asarray(jdct._hash_build_core(
        jnp.asarray(keys), jnp.asarray(ok), S, compact=True)[0])
    probe = np.concatenate([keys[::3], _keys(rng, 500)])
    want = np.asarray(jdist._probe_meta_sc(jnp.asarray(btab),
                                           jnp.asarray(probe)))
    got = tdist._probe_meta_sc(_t(btab), _t(probe))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(convert.to_numpy(got, uint32=True), want)
    assert (want != 0).sum() > 200 and (want == 0).sum() > 400
    assert ((want & 31) > 1).any() and ((want >> 5) > 0).any()


# ---------------- the multihost helpers ----------------

def test_multihost_helpers_single_process():
    """put_replicated/put_sharded/to_host and both collectives with one
    rank and no group: the identity."""
    world = tmh.maybe_initialize("cpu")
    assert (world.group, world.rank, world.size) == (None, 0, 1)
    assert world.device == torch.device("cpu")
    assert not tmh.is_multiprocess(world)
    x = np.arange(16, dtype=np.uint32).reshape(4, 4) + np.uint32(2**31)
    xs = tmh.put_sharded(world, x)
    assert xs.dtype == torch.int32
    np.testing.assert_array_equal(tmh.to_host(world, xs, uint32=True), x)
    np.testing.assert_array_equal(
        convert.to_numpy(tmh.put_replicated(world, x), uint32=True), x)
    t = torch.arange(6, dtype=torch.int32)
    assert tmh.all_to_all(world, t) is t and tmh.all_gather(world, t) is t
    assert world.collectives == 0
    tmh.shutdown()                        # nothing is up: a no-op


def test_multihost_helpers_two_ranks():
    res = launch(ranks.helpers, 2)
    x = np.arange(16, dtype=np.int32).reshape(4, 4)
    for r, got in enumerate(res):
        assert (got["rank"], got["size"], got["multi"]) == (r, 2, True)
        assert got["again"] == r          # maybe_initialize is idempotent
        np.testing.assert_array_equal(got["sharded"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["gathered"], x)
        np.testing.assert_array_equal(got["replicated"], x)
        # tile j of rank s lands on rank j at position s
        np.testing.assert_array_equal(
            got["a2a"], [2 * r, 2 * r + 1, 100 + 2 * r, 101 + 2 * r])
        assert got["collectives"] == 2    # the gather and the all_to_all


def test_put_sharded_rejects_uneven_split():
    world = tmh.World(None, 0, 1, torch.device("cpu"))
    world.size = 4
    with pytest.raises(ValueError, match="does not split"):
        tmh.put_sharded(world, np.zeros((6, 2), np.int32))


def test_launcher_reports_the_rank_that_raised():
    """A rank that raises fails the call inside its timeout, with that
    rank's message, and no child is left behind."""
    t = time.time()
    with pytest.raises(RuntimeError, match="rank 1 failed") as info:
        tmh.launch(ranks.rank_one_raises, 2, device="cpu", timeout=60.0,
                   num_threads=1)
    assert "ValueError: rank 1 gives up" in str(info.value)
    assert time.time() - t < 60.0
    assert not multiprocessing.active_children()


# ---------------- build, flush, engine ----------------

def _jax_start(name, n):
    """The JAX engine on a mesh of n, its sharded build's outputs, and the
    start state, seed slices and max shift as run() sets them."""
    packed, lengths, L = READS[name]()
    mesh = _mesh(n)
    e = jdist.DistReorderEngine(packed, lengths,
                                jdist.DistConfig(max_readlen=L), mesh=mesh)
    rows = jmh.put_sharded(mesh, e.packed)
    build = e._prog["build"](rows)
    stride = max(e.N // e.B, 1)
    idx = np.arange(e.N, dtype=np.int32)
    queue = np.concatenate([idx[r::stride] for r in range(stride)])
    qslice, nq = e._queue_slices(queue)
    state = e.init_state()
    state["n_queue"] = jmh.put_sharded(mesh, nq)
    return (e, (packed, lengths, L), rows, build, state,
            jmh.put_sharded(mesh, qslice),
            jmh.put_replicated(mesh, np.int32(e.cfg.max_shift)))


def test_build_equal_at_two_ranks():
    """Each rank's table, sorted keys, rids, pairs and dropped count are
    the JAX build's shards."""
    _, reads, _, build, state, seeds, _ = _jax_start("unequal", 2)
    j_build = dict(zip(convert.DIST_BUILD_FIELDS,
                       (np.asarray(b) for b in build)))
    j_state = {k: np.asarray(v) for k, v in state.items()}
    res = launch(ranks.build_and_flush, 2, *reads, j_build, j_state,
                 np.asarray(seeds))
    got = convert.dist_build_to_numpy([r[0] for r in res])
    for k, want in j_build.items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
    assert (j_build["rids"] >= 0).sum() > 1000


@pytest.mark.parametrize("flushes_before", [0, 1])
def test_flush_equal_at_two_ranks(flushes_before):
    """One flush from the JAX engine's state (the start state, and the
    state one flush on): every state field, the emission buffer and the
    stats, carried both ways through convert."""
    e, reads, rows, build, state, seeds, maxshift = _jax_start("unequal", 2)
    btab, _, _, pairs, _ = build
    flush = e._prog["flush"]
    for _ in range(flushes_before):
        state, _, _ = flush(state, btab, pairs, rows, seeds, maxshift)
    # the flush donates its state argument: copy it out first
    j_state = {k: np.array(v) for k, v in state.items()}
    j_build = dict(zip(convert.DIST_BUILD_FIELDS,
                       (np.asarray(b) for b in build)))
    j_new, j_buf, j_stats = flush(state, btab, pairs, rows, seeds, maxshift)
    res = launch(ranks.build_and_flush, 2, *reads, j_build, j_state,
                 np.asarray(seeds))
    got = convert.dist_state_to_numpy([r[1] for r in res])
    for k, v in j_new.items():
        want = np.asarray(v)
        np.testing.assert_array_equal(got[k], want, err_msg=k)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
    np.testing.assert_array_equal(np.concatenate([r[2] for r in res]),
                                  np.asarray(j_buf))
    np.testing.assert_array_equal(np.concatenate([r[3] for r in res]),
                                  np.asarray(j_stats))
    assert int(np.asarray(j_stats)[:, 3].sum()) > 0


def test_round_verify_calls_the_kernel_wrapper(monkeypatch):
    """The distributed round's verify goes through
    kernels.masked_hamming_rows, once a round, on row-major rows that
    carry the length word."""
    calls = []
    real = kernels.masked_hamming_rows

    def counting(frames, rows, lo, hi):
        calls.append((tuple(frames.shape), tuple(rows.shape)))
        return real(frames, rows, lo, hi)

    monkeypatch.setattr(kernels, "masked_hamming_rows", counting)
    packed, lengths, L = _reads_equal_len()
    e = tdist.DistReorderEngine(packed, lengths,
                                tdist.DistConfig(max_readlen=L),
                                device="cpu")
    launches = real.launches
    e.run(max_rounds=teng.FLUSH_ROUNDS)
    assert len(calls) == 2 * teng.FLUSH_ROUNDS    # one flush in flight
    W = packed.shape[1]
    assert set(calls) == {((e.B, 16, W), (e.B, 16, W + 1))}
    assert real.launches == launches              # CPU: plain path
    e.release()
    with pytest.raises(RuntimeError, match="after release"):
        e.run()


@pytest.mark.parametrize("name", ["equal", "unequal"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_engine_emissions_equal(n, name):
    """Port emissions at world sizes 1 (no group), 2 and 4 (spawned
    ranks) are the JAX engine's on a mesh of the same size, on every
    rank."""
    packed, lengths, L = READS[name]()
    j_em = jdist.DistReorderEngine(
        packed, lengths, jdist.DistConfig(max_readlen=L),
        mesh=_mesh(n)).run()
    if n == 1:
        res = [ranks.engine_run(tmh.maybe_initialize("cpu"), packed,
                                lengths, L)]
    else:
        res = launch(ranks.engine_run, n, packed, lengths, L)
    assert len(j_em) == len(packed)
    for em, stats in res:
        np.testing.assert_array_equal(em, j_em)
        assert stats["world_size"] == n
        # six all_to_alls and one all_gather a round, none without a group
        assert stats["collectives_per_round"] == (7 if n > 1 else 0)


def test_per_device_dictionary_limit_raises(monkeypatch):
    monkeypatch.setattr(tdist.dct, "MAX_COMPACT_ENTRIES", 64)
    packed, lengths, L = _reads_equal_len()
    with pytest.raises(ValueError, match="exceeds the compact table"):
        tdist.DistReorderEngine(packed, lengths,
                                tdist.DistConfig(max_readlen=L),
                                device="cpu")


def test_parallel_runs_without_jax():
    """With jax and spring_tpu blocked from import, the port's parallel
    modules import and the distributed engine places every read."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['spring_tpu'] = None\n"
        "import numpy as np\n"
        "from spring_tpu_torch.io import packing\n"
        "from spring_tpu_torch.parallel import dist, multihost\n"
        "rng = np.random.default_rng(3)\n"
        "genome = rng.integers(0, 4, 1500).astype(np.uint8)\n"
        "starts = rng.integers(0, 1500 - 64, 400)\n"
        "codes = np.stack([genome[s:s + 64] for s in starts])\n"
        "e = dist.DistReorderEngine(\n"
        "    packing.pack_codes(codes), np.full(400, 64, np.int32),\n"
        "    dist.DistConfig(max_readlen=64),\n"
        "    world=multihost.maybe_initialize('cpu'))\n"
        "em = e.run()\n"
        "assert sorted(em[:, 0].tolist()) == list(range(400))\n"
        "assert not any(m == 'jaxlib' or m.startswith(('jax.',\n"
        "               'spring_tpu.')) for m in sys.modules)\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
