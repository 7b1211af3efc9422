"""Functions that tests/test_torch_dist.py and test_torch_dist_archives.py
run on spawned ranks through spring_tpu_torch.parallel.multihost.launch
(this file holds no test of its own). A rank imports this module by name,
so it imports neither JAX nor the JAX package; what a rank returns is
numpy, compared with the JAX side by the test in the parent."""
import numpy as np
import torch

from spring_tpu_torch import api, convert, params
from spring_tpu_torch.parallel import dist
from spring_tpu_torch.parallel import multihost as mh
from spring_tpu_torch.reorder import engine as eng


def helpers(world):
    """The multihost helpers and both collectives on a small array."""
    n = world.size
    x = np.arange(8 * n, dtype=np.int32).reshape(n * 2, 4)
    xs = mh.put_sharded(world, x)
    tiles = torch.arange(2 * n, dtype=torch.int32) + 100 * world.rank
    return dict(
        rank=world.rank, size=world.size, multi=mh.is_multiprocess(world),
        again=mh.maybe_initialize("cpu").rank,
        sharded=xs.numpy(), gathered=mh.to_host(world, xs),
        replicated=mh.put_replicated(world, x.view(np.uint32)).numpy(),
        a2a=mh.all_to_all(world, tiles).numpy(),
        collectives=world.collectives)


def engine_run(world, packed, lengths, max_readlen, knobs=None):
    """Emissions and run stats of the distributed engine on this rank;
    ``knobs`` are DistConfig fields."""
    e = dist.DistReorderEngine(packed, lengths,
                               dist.DistConfig(max_readlen=max_readlen,
                                               **(knobs or {})),
                               world=world)
    em = e.run()
    return em, dict(eng.LAST_RUN_STATS)


def build_and_flush(world, packed, lengths, max_readlen, j_build, j_state,
                    seed_slices):
    """This rank's sharded build from the reads, and one flush that starts
    from the JAX engine's state and build outputs (global arrays, carried
    across by convert). Returns numpy: build outputs, state after the
    flush, emission buffer, stats."""
    e = dist.DistReorderEngine(packed, lengths,
                               dist.DistConfig(max_readlen=max_readlen),
                               world=world)
    prog = e._prog
    rows = mh.put_sharded(world, e.packed)
    build = dict(zip(convert.DIST_BUILD_FIELDS, prog["build"](rows)))
    theirs = convert.dist_build_to_torch(j_build, world.rank, world.size,
                                         "cpu")
    state = convert.dist_state_to_torch(j_state, world.rank, world.size,
                                        "cpu")
    state, buf, stats = prog["flush"](
        state, theirs["btab"], theirs["pairs"], rows,
        mh.put_sharded(world, seed_slices), e.cfg.max_shift)
    return build, state, buf.numpy(), stats.numpy()


def compress(world, files, out, threads, cap=None):
    """api.compress with the distributed engine, as every rank calls it;
    ``cap`` lowers the super-shard read cap in this rank's process."""
    if cap:
        params.MAX_NUM_READS_SHORT = cap
    api.compress(files, out, api.CompressOptions(
        num_threads=threads, verbose=False, dist=True), device="cpu")
    return dict(eng.LAST_RUN_STATS)


def rank_one_raises(world):
    if world.rank == 1:
        raise ValueError("rank 1 gives up")
    # the other ranks wait in a collective for the one that left
    mh.all_gather(world, torch.zeros(4, dtype=torch.int32))
    return world.rank


def engine_runs(world, sets, max_readlen, clear_before=()):
    """The distributed engine on each (packed, lengths) of ``sets`` in
    turn on this rank, the program cache cleared before the runs whose
    index is in ``clear_before``. Returns, a run, its emissions and
    (program_cache, eager_rounds, collectives_per_round)."""
    out = []
    for i, (packed, lengths) in enumerate(sets):
        if i in clear_before:
            api.clear_program_cache()
        em = dist.DistReorderEngine(
            packed, lengths, dist.DistConfig(max_readlen=max_readlen),
            world=world).run()
        s = eng.LAST_RUN_STATS
        out.append((em, (s["program_cache"], s["eager_rounds"],
                         s["collectives_per_round"])))
    return out
