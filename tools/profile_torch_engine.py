"""Profile the port's reorder engine on a CUDA card with torch.profiler.

    python tools/profile_torch_engine.py [--reads 1000000] [--out DIR]

Builds SRR554369-class packed reads in memory (1% substitutions, both
strands, ~50x coverage, seed 42), runs spring_tpu_torch's ReorderEngine
once on cuda to warm up and once under torch.profiler, and prints: the
dictionary build and run wall times, rounds and ms/round, the device busy
share of the profiled run (sum of CUDA kernel time over wall time), and
the ops with the most CUDA time and the masked-Hamming rows, under the
card's name and power limit (nvidia-smi). The full table goes to
DIR/engine_ops.txt.
Needs a CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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
    cfg = eng.ReorderConfig(max_readlen=100)
    eng.ReorderEngine(packed, lengths, cfg, device="cuda").run()  # warm-up
    torch.cuda.synchronize()

    e = eng.ReorderEngine(packed, lengths, cfg, device="cuda")
    t = time.time()
    e.dicts                                   # dictionary build alone
    torch.cuda.synchronize()
    build_s = time.time() - t
    e._dicts = None
    kernels.masked_hamming.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        e.run()
        torch.cuda.synchronize()
        wall = time.time() - t
    stats = eng.LAST_RUN_STATS
    ka = prof.key_averages()
    # kernel rows only: an aten op's row repeats its kernels' time
    dev_us = sum(k.self_device_time_total for k in ka
                 if str(k.device_type).endswith("CUDA"))
    print(f"[engine] {args.reads} reads: dict build {build_s:.3f} s; "
          f"run {wall:.3f} s, {stats['rounds']} rounds, "
          f"{stats['ms_per_round']} ms/round; kernel launches "
          f"{kernels.masked_hamming.launches}")
    print(f"[engine] device busy {dev_us / 1e6:.3f} s of {wall:.3f} s wall "
          f"({100 * dev_us / 1e6 / wall:.1f}%); the rest is host launch "
          f"overhead and syncs")
    table = ka.table(sort_by="self_device_time_total", row_limit=-1)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "engine_ops.txt"), "w") as f:
        f.write(table)
    lines = table.splitlines()
    print("\n".join(lines[:25]))
    print("\n".join(ln for ln in lines if "masked_hamming" in ln))
    return 0


if __name__ == "__main__":
    sys.exit(main())
