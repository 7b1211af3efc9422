"""Profile the port's reorder engine on a CUDA card with torch.profiler.

    python tools/profile_torch_engine.py [--reads 1000000] [--out DIR]
                                         [--dist [--no-group]]

Builds SRR554369-class packed reads in memory (1% substitutions, both
strands, ~50x coverage, seed 42), runs spring_tpu_torch's ReorderEngine
once on cuda to warm up and once under torch.profiler, and prints: the
dictionary build and run wall times, rounds and ms/round, the device busy
share of the profiled run (sum of CUDA kernel time over wall time), the
round's hand-written kernel (calls, device us a call), the count of device
kernel launches a round, and the ops with the most CUDA time, under the
card's name and power limit (nvidia-smi). The full table goes to
DIR/engine_ops.txt.

The round's kernel, the fused verify_rows, is found by name in the trace,
one call a round. Launches a round are all of the run's device kernels
(dictionary build and flush compaction included) over the rounds run (the
speculative last flush included). Both are printed beside what the round
took before the verify was fused (BEFORE_FUSION, from PERF.md).
With --dist the engine is the distributed one (parallel/dist.py) at
world size 1 over NCCL: its round's kernel is masked_hamming_rows
(masked_hamming_kernel in the trace), and the NCCL kernels are listed.
With --no-group the same engine runs with one rank and no process group,
so that its collectives are the identity: the difference is what NCCL
costs a round. The warm-up run's ms/round (no profiler) is printed too.
Needs a CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# The round before its verify stage became one kernel (masked_hamming fed
# by eager gathers), by this script at 1M reads on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md section 6).
BEFORE_FUSION = {"kernel_us_a_call": 2.77, "launches_a_round": 1028.7}


def make_reads(n: int, L: int = 100, genome: int = 2_000_000, seed: int = 42):
    from spring_tpu_torch.io import packing
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome).astype(np.uint8)
    starts = rng.integers(0, genome - L, n)
    codes = g[starts[:, None] + np.arange(L)[None, :]]
    flip = rng.random(codes.shape) < 0.01
    codes = np.where(flip, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    rc = rng.random(n) < 0.5
    codes[rc] = 3 - codes[rc][:, ::-1]
    return packing.pack_codes(codes), np.full(n, L, np.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--dist", action="store_true",
                    help="profile the distributed engine at world size 1 "
                         "over NCCL")
    ap.add_argument("--no-group", action="store_true",
                    help="with --dist: one rank and no process group")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_engine: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)

    from spring_tpu_torch.ops import kernels
    from spring_tpu_torch.reorder import engine as eng

    packed, lengths = make_reads(args.reads)
    if args.dist:
        import tempfile
        from spring_tpu_torch.parallel import dist, multihost
        store = tempfile.TemporaryDirectory(prefix="profile_store_")
        if args.no_group:
            world = multihost.World(None, 0, 1, torch.device("cuda", 0))
        else:
            world = multihost.initialize(
                0, 1, os.path.join(store.name, "s"), device="cuda")
        dcfg = dist.DistConfig(max_readlen=100)
        dist.DistReorderEngine(packed, lengths, dcfg, world=world).run()
        torch.cuda.synchronize()
        e = dist.DistReorderEngine(packed, lengths, dcfg, world=world)
        rows = multihost.put_sharded(world, e.packed)
        torch.cuda.synchronize()
        t = time.time()
        e._prog["build"](rows)                # dictionary build alone
        torch.cuda.synchronize()
        build_s = time.time() - t
        del rows
        wrapper, kernel_name = kernels.masked_hamming_rows, "masked_hamming"
    else:
        cfg = eng.ReorderConfig(max_readlen=100)
        eng.ReorderEngine(packed, lengths, cfg, device="cuda").run()
        torch.cuda.synchronize()              # the warm-up run
        e = eng.ReorderEngine(packed, lengths, cfg, device="cuda")
        t = time.time()
        e.dicts                               # dictionary build alone
        torch.cuda.synchronize()
        build_s = time.time() - t
        e._dicts = None
        wrapper, kernel_name = kernels.verify_rows, "verify_rows"
    warm = dict(eng.LAST_RUN_STATS)
    wrapper.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        e.run()
        torch.cuda.synchronize()
        wall = time.time() - t
    stats = eng.LAST_RUN_STATS
    ka = prof.key_averages()
    # kernel rows only: an aten op's row repeats its kernels' time
    dev_rows = [k for k in ka if str(k.device_type).endswith("CUDA")]
    dev_us = sum(k.self_device_time_total for k in dev_rows)
    ours = [k for k in dev_rows if kernel_name in k.key]
    calls = sum(k.count for k in ours)
    ours_us = sum(k.self_device_time_total for k in ours)
    if calls != wrapper.launches or calls == 0:
        raise SystemExit(f"profile_torch_engine: the trace holds {calls} "
                         f"calls of the round's kernel, the wrapper "
                         f"counted {wrapper.launches}")
    n_dev = sum(k.count for k in dev_rows)
    which = "engine"
    if args.dist:
        which = ("distributed engine, world size 1 over NCCL"
                 if not args.no_group else
                 "distributed engine, one rank, no group")
    print(f"[engine] {which}; warm-up run without the profiler: "
          f"{warm['rounds']} rounds, {warm['ms_per_round']} ms/round"
          + (f"; host time inside the {warm['collectives']} collective "
             f"calls {warm['collective_host_s']} s of "
             f"{warm['flush_wall_s']} s" if args.dist else ""))
    print(f"[engine] {which}; {args.reads} reads: dict build {build_s:.3f} s; "
          f"run {wall:.3f} s, {stats['rounds']} rounds, "
          f"{stats['ms_per_round']} ms/round; kernel launches "
          f"{wrapper.launches}")
    print(f"[engine] device busy {dev_us / 1e6:.3f} s of {wall:.3f} s wall "
          f"({100 * dev_us / 1e6 / wall:.1f}%); the rest is host launch "
          f"overhead and syncs")
    print(f"[engine] round kernel {', '.join(k.key for k in ours)}: {calls} "
          f"calls, {ours_us:.3f} us device in all, {ours_us / calls:.3f} us "
          f"a call (before the fusion: masked_hamming alone, "
          f"{BEFORE_FUSION['kernel_us_a_call']} us a call)")
    print(f"[engine] device kernel launches: {n_dev} in the run, "
          f"{n_dev / calls:.1f} a round over {calls} rounds run (before "
          f"the fusion: {BEFORE_FUSION['launches_a_round']} a round)")
    table = ka.table(sort_by="self_device_time_total", row_limit=-1)
    os.makedirs(args.out, exist_ok=True)
    name = "dist_engine_ops.txt" if args.dist else "engine_ops.txt"
    with open(os.path.join(args.out, name), "w") as f:
        f.write(table)
    lines = table.splitlines()
    print("\n".join(lines[:25]))
    print("\n".join(ln for ln in lines
                    if kernel_name in ln or "nccl" in ln.lower()))
    if args.dist:
        nccl = [k for k in dev_rows if "nccl" in k.key.lower()]
        print(f"[engine] NCCL kernels: {sum(k.count for k in nccl)} calls, "
              f"{sum(k.self_device_time_total for k in nccl) / 1e3:.3f} ms "
              f"device in all; collectives counted by the world: "
              f"{stats['collectives']}")
        multihost.shutdown()
        store.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
