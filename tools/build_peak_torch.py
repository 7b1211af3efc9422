#!/usr/bin/env python3
"""Peak device memory of the port's dictionary builds at the shapes of a
100M-read compress.

    python tools/build_peak_torch.py [--reads 100000000] [--root DIR]
                                     [--device cuda] [--seed 1]

On rows made on the device from --seed (random 16-base windows, each
drawn for ~50 reads, as at 50x coverage, length word 100, padding rows
past --reads as the engine marks them), it builds the engine's read
dictionary (window start 34) at Np = engine.padded_n(reads), compact
rows then wide rows, and one consensus segment dictionary (2^24 bases,
segment 5 of a 202,000,000-base consensus, as second chance and stitch
build 13 of them at 100M reads). For each: seconds (device
synchronised), the peak allocated bytes over what was allocated before
it (torch.cuda.max_memory_allocated after reset_peak_memory_stats), keys
dropped, and a SHA-256 of its outputs, so that the outputs of two trees
compare. ``--root DIR`` imports spring_tpu_torch from DIR (a ``git
archive`` of another commit). The card's name and power limit head the
output; the last line is one JSON object. ``--device cpu --reads 5000``
rehearses it here (peaks are null: the CPU keeps no such count).

``--dist-ranks N`` measures instead the distributed engine's build
(parallel/dist.py, ``_dist_programs(...)["build"]``) of rank 0 of N ranks
at that engine's Np (the power of two at or above --reads) and walkers,
on Np / N rows made as above, in a world of N ranks with no process
group: its two exchanges return what this rank sends, so that it builds
over as many entries (N * capk slots, D * Np / N keys) as a rank of a
real group would.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=100_000_000)
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dist-ranks", type=int, default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from spring_tpu_torch.reorder import dictionary as dct
    from spring_tpu_torch.reorder import engine as eng

    dev = torch.device(a.device)
    card = dev.type == "cuda"
    if card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)

    def run(name, fn):
        if card:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out = fn()
        if card:
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t
        sha = hashlib.sha256()
        for o in out:
            sha.update(o.cpu().numpy().tobytes())
        rec = dict(seconds=round(secs, 4),
                   peak_over_input_bytes=(torch.cuda.max_memory_allocated(
                       dev) - base if card else None),
                   dropped=int(out[3]), sha256=sha.hexdigest())
        print(f"{name}: {json.dumps(rec)}", flush=True)
        return rec

    def make_rows(n_rows, n_real):
        rows = torch.randint(-2**31, 2**31 - 1, (max(n // 50, 1), 8),
                             generator=g, dtype=torch.int32, device=dev)
        rows = rows[torch.randint(0, rows.shape[0], (n_rows,), generator=g,
                                  device=dev)]
        rows[:, 7] = 100
        rows[n_real:, 7] = -2**31
        return rows

    n = a.reads
    g = torch.Generator(device=dev).manual_seed(a.seed)
    if a.dist_ranks:
        from spring_tpu_torch.parallel import dist, multihost
        k = a.dist_ranks
        Np = max(1 << max(n - 1, 1).bit_length(), 64 * k)
        B = min(8192, max(8 * k, Np // 256)) // k * k
        cfg = dist.DistConfig(max_readlen=100)
        prog = dist._dist_programs(
            multihost.World(None, 0, k, dev), Np, 7, B, cfg.candidates,
            cfg.shift_chunk, cfg.accept_slots,
            tuple(w.start for w in dct.default_windows(100)), cfg.thresh,
            cfg.capacity_factor)
        rows = make_rows(Np // k, n)
        res = dict(reads=n, Np=Np, ranks=k, walkers=B,
                   exchange=prog.get("exchange"),
                   root=os.path.abspath(a.root), device=a.device)

        def build():        # dropped fourth, as run() reads it
            btab, keys, rids, pairs, dropped = prog["build"](rows)
            return btab, keys, rids, dropped, pairs

        res["dist_build"] = run(f"distributed build, rank 0 of {k}", build)
        print(json.dumps(res), flush=True)
        return 0
    Np = eng.padded_n(n)
    rows = make_rows(Np, n)
    S = dct.table_buckets(Np)
    res = dict(reads=n, Np=Np, buckets=S, root=os.path.abspath(a.root),
               device=a.device)
    for wide in (False, True):
        res["read_dict_wide" if wide else "read_dict"] = run(
            f"read dictionary (wide rows {wide})",
            lambda: dct._build_hash_dict_dev(rows, n, 34, S, wide))
    del rows
    total = 202_000_000
    seg = 1 << 24
    seq = torch.randint(-2**31, 2**31 - 1, (total // 16 + 64,),
                        generator=g, dtype=torch.int32, device=dev)
    res["consensus_segment"] = run(
        "consensus segment dictionary",
        lambda: dct.build_hash_dict_seq_seg(
            seq, total, 5 * seg, 1, seg // 16 + 2, dct.table_buckets(seg)))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
