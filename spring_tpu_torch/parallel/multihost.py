"""Process groups for the distributed reorder: torch.distributed, NCCL on
cards and gloo on the CPU.

Port of spring_tpu/parallel/multihost.py. Where the JAX package spans a
device mesh from one process (or one process a host), the port runs one
process a device, and the mesh is a small explicit object, ``World``: the
process group (or none), this process's rank, the number of ranks, and the
device this rank computes on.

Run protocol (the same command on every rank, every rank loads the same
input, rank 0 writes the archive):

    torchrun --nproc-per-node 4 -m spring_tpu_torch.cli -c --dist \
        -i in.fastq -o out.stpu

``maybe_initialize`` picks up torch's launcher variables (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) and forms the group;
without them the world has one rank and no group. Device arrays enter a
world through the helpers below:

  * put_replicated — the same host value on every rank;
  * put_sharded    — this rank's block of dim 0 of a global host array;
  * to_host        — the full array on every rank (an all_gather on dim 0).

The two collectives of the distributed round are plain functions on
tensors: ``all_to_all`` (dim 0 split in ``size`` equal tiles) and
``all_gather`` (tiled on dim 0). With no group both are the identity; with
a group they call torch.distributed at every size, size 1 included, add
one to ``World.collectives`` and the call's host time to
``World.collective_s``. A call captured into a CUDA graph
(``ops/graphs.py``) counts at each replay and adds no host time.

``launch`` runs a function on n local ranks, one process each, for tests
and smoke runs on one machine.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as tdist

from ..ops import graphs

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass
class World:
    """The ranks one distributed reorder runs over."""
    group: object | None        # torch.distributed process group, or none
    rank: int
    size: int
    device: torch.device        # where this rank's tensors live
    collectives: int = 0        # collectives run so far (graph replays too)
    collective_s: float = 0.0   # host seconds inside the calls made eagerly


def _resolve_device(device, local_rank: int | None = None) -> torch.device:
    """``device`` with a card index: a rank's card is cuda:LOCAL_RANK."""
    dev = torch.device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"unsupported device {dev}: want cuda or cpu")
    if dev.type == "cuda" and dev.index is None:
        index = (torch.cuda.current_device() if local_rank is None
                 else local_rank)
        dev = torch.device("cuda", index)
    return dev


def initialize(rank: int, size: int, rendezvous: str, device="cuda",
               timeout: float = 600.0,
               local_rank: int | None = None) -> World:
    """Form the process group of ``size`` ranks and return this rank's
    World. ``rendezvous`` is a torch init method ("env://",
    "tcp://host:port") or, without "://", the path of a file store (no
    port needed). The backend follows the device: nccl for cuda, gloo for
    cpu. Every collective of the group fails after ``timeout`` seconds."""
    dev = _resolve_device(device, local_rank)
    if dev.type == "cuda":
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants {dev} but {torch.cuda.device_count()} "
                "card(s) are visible: one rank a card")
        torch.cuda.set_device(dev)
    kwargs = dict(backend=_BACKENDS[dev.type], rank=rank, world_size=size,
                  timeout=datetime.timedelta(seconds=timeout))
    if "://" in rendezvous:
        tdist.init_process_group(init_method=rendezvous, **kwargs)
    else:
        tdist.init_process_group(
            store=tdist.FileStore(rendezvous, size), **kwargs)
    return World(tdist.group.WORLD, rank, size, dev)


def maybe_initialize(device="cuda") -> World:
    """This process's World: the group that is already up, else the one
    torch's launcher variables describe (formed now), else one rank and
    no group. Idempotent."""
    if tdist.is_available() and tdist.is_initialized():
        dev = _resolve_device(device)
        backend = tdist.get_backend()
        if backend != _BACKENDS[dev.type]:
            raise ValueError(f"the process group runs {backend}, which "
                             f"does not serve device {dev}")
        return World(tdist.group.WORLD, tdist.get_rank(),
                     tdist.get_world_size(), dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        return initialize(rank, int(os.environ["WORLD_SIZE"]), "env://",
                          device,
                          local_rank=int(os.environ.get("LOCAL_RANK", rank)))
    return World(None, 0, 1, _resolve_device(device))


def shutdown() -> None:
    """Free the cached flush programs (their graphs hold the group's
    collectives) and destroy the process group, if one is up."""
    graphs.clear_program_cache()
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def is_multiprocess(world: World) -> bool:
    return world.size > 1


def _as_tensor(x, device) -> torch.Tensor:
    """Host array -> tensor; uint32 becomes int32 of the same bits."""
    a = np.array(x, order="C")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device)


def put_replicated(world: World, x) -> torch.Tensor:
    """Host value -> tensor on this rank's device (every rank passes the
    same value)."""
    return _as_tensor(x, world.device)


def put_sharded(world: World, x) -> torch.Tensor:
    """Global host array -> this rank's block of dim 0 on its device
    (every rank passes the same global array)."""
    x = np.asarray(x)
    if x.shape[0] % world.size:
        raise ValueError(f"dim 0 of {x.shape} does not split over "
                         f"{world.size} ranks")
    rows = x.shape[0] // world.size
    return _as_tensor(x[world.rank * rows:(world.rank + 1) * rows],
                      world.device)


def _counted(world: World, t0: float) -> None:
    """Count one collective of ``world`` that started at host time t0:
    under a CUDA graph's capture it counts at each replay, and its host
    time (the capture's, not a run's) is not added."""
    if not graphs.capturing():
        world.collective_s += time.perf_counter() - t0
    graphs.count(world, "collectives")


def all_to_all(world: World, x: torch.Tensor) -> torch.Tensor:
    """Tile j of dim 0 goes to rank j; the result holds, in rank order,
    the tiles the other ranks addressed to this one."""
    if world.group is None:
        return x
    if x.shape[0] % world.size:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {world.size} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    t = time.perf_counter()
    tdist.all_to_all_single(out, x, group=world.group)
    _counted(world, t)
    return out


def all_gather(world: World, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x, concatenated on dim 0 in rank order."""
    if world.group is None:
        return x
    x = x.contiguous()
    out = torch.empty((world.size * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    t = time.perf_counter()
    tdist.all_gather(list(out.chunk(world.size, dim=0)), x,
                     group=world.group)
    _counted(world, t)
    return out


def to_host(world: World, x: torch.Tensor,
            uint32: bool = False) -> np.ndarray:
    """A tensor sharded on dim 0 -> the full host array on every rank;
    ``uint32`` views int32 bit patterns as uint32."""
    a = all_gather(world, x).cpu().numpy()
    return a.view(np.uint32) if uint32 else a


# ---------------- local launcher ----------------

def _rank_main(fn, rank, size, workdir, device, timeout, num_threads, args):
    """One spawned rank: form the group through a file store in
    ``workdir``, run fn(world, *args), leave the result (or the failure)
    in ``workdir``."""
    err = open(os.path.join(workdir, f"stderr.{rank}"), "w")
    os.dup2(err.fileno(), 2)
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        world = initialize(rank, size, os.path.join(workdir, "store"),
                           device, timeout, local_rank=rank)
        out = fn(world, *args)
        with open(os.path.join(workdir, f"result.{rank}"), "wb") as f:
            pickle.dump(out, f)
        shutdown()
    except BaseException:
        # the other ranks may sit in a collective: say what happened and
        # go, the parent ends them
        with open(os.path.join(workdir, f"failed.{rank}"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _first_failure(workdir: str, codes: list) -> str:
    """The report of the rank that failed first: its traceback, else the
    end of its stderr."""
    failed = []
    for rank, code in enumerate(codes):
        if code in (None, 0):
            continue
        when, text = float("inf"), ""
        path = os.path.join(workdir, f"failed.{rank}")
        if os.path.exists(path):
            with open(path) as f:
                head, _, text = f.read().partition("\n")
            when = float(head)
        else:
            with open(os.path.join(workdir, f"stderr.{rank}")) as f:
                text = f.read()[-4000:]
        failed.append((when, rank, code, text))
    when, rank, code, text = min(failed)
    return f"rank {rank} failed (exit code {code}):\n{text}"


def launch(fn, n: int, args: tuple = (), device="cuda",
           timeout: float = 600.0, num_threads: int | None = None) -> list:
    """Run ``fn(world, *args)`` on n local ranks, one spawned
    process each (rank r on cuda:r when ``device`` is cuda), and return
    the n results in rank order. ``fn`` and ``args`` must pickle (a
    module-level function). The ranks meet through a file store in a
    temporary directory; the group's collectives and the wait here both
    end after ``timeout`` seconds. When a rank fails or the time is up,
    the remaining ranks are killed and RuntimeError or TimeoutError
    carries the first failure's report."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="stpu_ranks_") as workdir:
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, rank, n, workdir, str(device), timeout, num_threads,
                  args), daemon=True) for rank in range(n)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise RuntimeError(_first_failure(workdir, codes))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} ranks did not finish in {timeout} s; exit "
                        f"codes so far {codes}")
                time.sleep(0.05)
            results = []
            for rank in range(n):
                with open(os.path.join(workdir, f"result.{rank}"),
                          "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(30)
