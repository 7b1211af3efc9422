#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: end-to-end FASTQ compression
throughput (reads/s), the counterpart of bench.py.

    python3 bench_torch.py [--device cuda] [--reads 10000000]
                           [--reads-small 1000000]

Workload (bench.py's): a synthetic SRR554369-class dataset, 100 bp reads
at ~50x coverage of a genome of max(2 Mbp, reads * 100 / 50) bases, 1%
substitutions, both strands, Illumina-like qualities, seed 42
(spring_tpu_torch/utils/synth.py), run through
spring_tpu_torch.api.compress on ``--device`` and round-tripped through
the port's decompress with a byte compare that fails the run on a
mismatch. Two scales, as bench.py: the small one (one warm-up compress,
then the best of 4 timed passes) and the headline (best of 3 passes; its
first pass builds the flush program of the new shape, the later ones find
it in the program cache). The headline value is the large scale's rate.

Prints exactly one JSON line on stdout, with bench.py's keys (metric,
value, unit, vs_baseline, reads, small_scale, stage_s, engine, probe)
plus each pass's seconds, engine cache state and device peak at the end
of each stage (pipeline/short_mode.py), its peak reserved device memory
(torch.cuda.max_memory_reserved: it holds the cached programs' CUDA graph
pools, whose temporaries a replay does not allocate anew), the cached
programs' bytes and the matchers' loops (ops/graphs.py::LOOP_STATS),
decompress seconds,
archive bytes, peak device memory (torch.cuda.max_memory_allocated over
the timed passes, also a pass), and the card's name and power limit as
nvidia-smi gives them. The probe is CUDA's: the host's synchronize
latency after a small kernel, and host-to-device and device-to-host MB/s
from pinned buffers, before and after the runs. ``--device cpu`` runs
the same at a small scale here (the device numbers are then null); with
``--device cuda`` and no card it fails, it does not move to the CPU.
Imports neither JAX nor the JAX package.
"""
import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# keep big numpy temporaries on the brk heap so freed pages are reused
# instead of being returned to the OS and re-faulted (as bench.py); glibc
# reads these only at startup
if os.environ.get("MALLOC_MMAP_THRESHOLD_") is None and os.name == "posix":
    os.environ["MALLOC_MMAP_THRESHOLD_"] = str(1 << 30)
    os.environ["MALLOC_TRIM_THRESHOLD_"] = str(1 << 30)
    os.execv(sys.executable, [sys.executable] + sys.argv)

READ_LEN = 100
GENOME = 2_000_000
# CPU SPRING on SRR554369 (3.31M reads x 100 bp) in 22 s on 8 threads
# (BASELINE.md), as bench.py
BASELINE_READS_PER_S = 150_000.0
SMALL_PASSES = 4
PASSES = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_dataset(path: str, n: int) -> None:
    """bench.py's SRR554369-class profile at ~50x coverage."""
    from spring_tpu_torch.utils import synth
    synth.make_se(path, n, read_len=READ_LEN,
                  genome_size=max(GENOME, n * READ_LEN // 50), seed=42)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def probe_device(torch, device) -> dict:
    """Sync latency (ms, median of 5, each a one-kernel step ended by
    torch.cuda.synchronize) and pinned host-to-device and device-to-host
    rates (MB/s, best of 3 copies of 64 MB)."""
    if device.type != "cuda":
        return {"device": str(device), "sync_ms": None, "h2d_mbps": None,
                "d2h_mbps": None}
    x = torch.zeros(1024, dtype=torch.int32, device=device)
    x.add_(1)
    torch.cuda.synchronize(device)
    lats = []
    for _ in range(5):
        t0 = time.perf_counter()
        x.add_(1)
        torch.cuda.synchronize(device)
        lats.append((time.perf_counter() - t0) * 1e3)
    mb = 64
    host = torch.empty(mb << 20, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(mb << 20, dtype=torch.uint8, device=device)

    def rate(dst, src):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize(device)
            best = min(best, time.perf_counter() - t0)
        return round(mb * (1 << 20) / 1e6 / best, 1)

    return {"device": str(device),
            "sync_ms": round(sorted(lats)[len(lats) // 2], 4),
            "h2d_mbps": rate(dev, host), "d2h_mbps": rate(host, dev)}


def run_scale(torch, device, n: int, tmp: str, passes: int,
              warm: bool) -> dict:
    """Generate n reads, compress them (one warm-up pass if ``warm``,
    then ``passes`` timed ones), decompress the last archive and compare
    it with the input byte for byte; raises RuntimeError on a mismatch.
    Returns the best pass's seconds, stages and engine numbers, and each
    pass's."""
    from spring_tpu_torch import api
    from spring_tpu_torch.io.container import ArchiveReader
    from spring_tpu_torch.ops import graphs
    from spring_tpu_torch.pipeline import short_mode
    from spring_tpu_torch.reorder import engine as eng
    cuda = device.type == "cuda"
    fq = os.path.join(tmp, f"bench_{n}.fastq")
    arc = os.path.join(tmp, f"bench_{n}.stpu")
    out = os.path.join(tmp, f"bench_{n}.out.fastq")
    log(f"generating {n} synthetic reads ...")
    t0 = time.time()
    make_dataset(fq, n)
    log(f"input {os.path.getsize(fq) / 1e6:.1f} MB in "
        f"{time.time() - t0:.1f} s; compressing on {device} ...")
    opts = api.CompressOptions(num_threads=os.cpu_count() or 8,
                               verbose=False)

    def compress():
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize(device)
        t0 = time.time()
        api.compress([fq], arc, opts, device=device)
        if cuda:
            torch.cuda.synchronize(device)
        return (time.time() - t0,
                torch.cuda.max_memory_allocated(device) if cuda else None)

    def reserved():
        return torch.cuda.max_memory_reserved(device) if cuda else None

    if warm:
        dt, _ = compress()
        log(f"[{n}] warm-up compress {dt:.2f} s")
    best = dict(s=float("inf"))
    each = []
    for _ in range(passes):
        dt, peak = compress()
        stats = dict(eng.LAST_RUN_STATS)
        each.append(dict(compress_s=round(dt, 3),
                         reads_per_s=round(n / dt, 1), peak_device_bytes=peak,
                         peak_reserved_bytes=reserved(),
                         cached_program_bytes=graphs.cached_program_bytes(
                             device),
                         loops=dict(graphs.LOOP_STATS),
                         program_cache=stats.get("program_cache"),
                         eager_rounds=stats.get("eager_rounds"),
                         engine_s=stats.get("flush_wall_s"),
                         stage_peak_bytes=dict(
                             short_mode.LAST_STAGE_PEAK_BYTES)))
        log(f"[{n}] pass: {json.dumps(each[-1])}")
        if dt < best["s"]:
            best = dict(s=dt, stages=dict(short_mode.LAST_STAGE_SECONDS),
                        engine=stats)

    arc_bytes = os.path.getsize(arc)
    with ArchiveReader(arc) as r:
        sizes = r.size_by_prefix()
    for k in sorted(sizes, key=lambda k: -sizes[k]):
        log(f"  stream {k}: {sizes[k]} B")
    t1 = time.time()
    api.decompress(arc, [out], verbose=False,
                   num_threads=os.cpu_count() or 8)
    dec_s = time.time() - t1
    log(f"[{n}] decompressed in {dec_s:.2f} s")
    ok = filecmp.cmp(fq, out, shallow=False)
    for f in (fq, arc, out):
        os.unlink(f)
    if not ok:
        raise RuntimeError(f"round trip failed at n={n}")
    peaks = [p["peak_device_bytes"] for p in each]
    return dict(s=best["s"], stages=best["stages"], engine=best["engine"],
                passes=each, decompress_s=round(dec_s, 3),
                archive_bytes=arc_bytes,
                peak_device_bytes=max(peaks) if cuda else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the compress (default cuda)")
    ap.add_argument("--reads", type=int, default=10_000_000,
                    help="headline scale (default 10,000,000)")
    ap.add_argument("--reads-small", type=int, default=1_000_000,
                    help="small scale (default 1,000,000)")
    args = ap.parse_args()
    sys.modules["jax"] = None           # the port runs without JAX
    sys.modules["spring_tpu"] = None
    import torch
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_torch: no CUDA device; pass --device "
                             "cpu for a CPU run")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        card = card_line()
        kind = torch.cuda.get_device_name(device)
    else:
        card = kind = None
    log(f"device {device}: {kind}; nvidia-smi: {card}")
    tmp = tempfile.mkdtemp(prefix="spring_bench_torch_")
    probe0 = probe_device(torch, device)
    log(f"device probe (pre): {probe0}")
    try:
        small = run_scale(torch, device, args.reads_small, tmp,
                          SMALL_PASSES, warm=True)
        big = (run_scale(torch, device, args.reads, tmp, PASSES, warm=False)
               if args.reads != args.reads_small else small)
    except RuntimeError as e:
        log(f"ROUND TRIP FAILED: {e}")
        print(json.dumps({"metric": "compress_reads_per_s", "value": 0.0,
                          "unit": "reads/s", "vs_baseline": 0.0}))
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    probe1 = probe_device(torch, device)
    log(f"device probe (post): {probe1}")
    reads_per_s = args.reads / big["s"]
    print(json.dumps({
        "metric": "compress_reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        "reads": args.reads,
        "small_scale": {"reads": args.reads_small,
                        "value": round(args.reads_small / small["s"], 1),
                        "stage_s": small["stages"],
                        "engine": small["engine"],
                        "passes": small["passes"],
                        "decompress_s": small["decompress_s"],
                        "archive_bytes": small["archive_bytes"],
                        "peak_device_bytes": small["peak_device_bytes"]},
        "stage_s": big["stages"],
        "engine": big["engine"],
        "probe": {"pre": probe0, "post": probe1},
        "passes": big["passes"],
        "decompress_s": big["decompress_s"],
        "archive_bytes": big["archive_bytes"],
        "round_trip": "byte-exact",
        "peak_device_bytes": big["peak_device_bytes"],
        "device": str(device), "device_name": kind, "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
