#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernel library from spring_tpu_torch/csrc (nvcc) and
     spring_tpu's native host library (make);
  3. the masked-Hamming kernel against masked_hamming_ref on the card,
     exact equality, at the reorder round's shape (B=4096 walkers x M=16
     slots, W=7 words, rows of stride W+1) and at the word-major
     (W=7, B=16384, K=128) shape, with edge ranges; median CUDA-event
     times of both;
  4. a 16,384-read set compressed on the card and on the CPU: the two
     archives must be byte-equal (the CPU path is held to spring_tpu's
     JAX output by tests/test_torch_*.py); this also warms the card up;
  5. the main path: 1,000,000 single-end 100 bp reads
     (synth.make_se(genome_size=2_000_000, seed=42), ~50x coverage)
     compressed with spring_tpu_torch.api.compress(device="cuda"),
     decompressed and byte-compared with the input; the kernel's launch
     count over that compress must be at least the number of rounds.
Then one JSON line of kernel results and, last, the device line
{"ok": true, "device": {...}}. Any failure raises: the exit code is then
not 0 and no result line is printed. Needs a CUDA card; imports no JAX.
"""
import filecmp
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# the port runs without JAX: from here on any import of it fails
sys.modules["jax"] = None

N_READS = 1_000_000
GENOME = 2_000_000
SEED = 42
THREADS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 21, inner: int = 10) -> float:
    """Median over reps of the mean CUDA-event time of `inner` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_inputs(torch, shape, W, seed):
    """Near-matching packed words (a quarter of the words perturbed) and
    base ranges with edge cases: lo == hi, hi == 0, hi past 16*W, hi < lo,
    all bits set."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = (*shape, W)

    def words(sz):
        return torch.randint(-2**31, 2**31, sz, generator=g, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    a = words(full)
    flip = torch.rand(full, generator=g, device="cuda") < 0.25
    b = torch.where(flip, a ^ words(full), a)
    lo = torch.randint(0, 60, shape, generator=g, device="cuda",
                       dtype=torch.int32)
    hi = torch.randint(0, 16 * W + 20, shape, generator=g, device="cuda",
                       dtype=torch.int32)
    lo.view(-1)[:5] = torch.tensor([17, 0, 5, 40, 0], dtype=torch.int32)
    hi.view(-1)[:5] = torch.tensor([17, 0, 16 * W + 50, 10, 16 * W],
                                   dtype=torch.int32)
    a.view(-1, W)[4] = -1
    b.view(-1, W)[4] = 0
    return a, b, lo, hi


def check_kernel(torch, kernels):
    """Phase 3: (results, max_abs_err) at both shapes."""
    out = {}
    err = 0
    W = 7
    # the round's layout: (B, M, W) frames, (B, M, W+1) gathered rows
    B, M = 4096, 16
    fr, rw, lo, hi = kernel_inputs(torch, (B, M), W, SEED)
    lw = torch.full((B, M, 1), 100, dtype=torch.int32, device="cuda")
    rows = torch.cat([rw, lw], dim=-1).contiguous()
    got = kernels.masked_hamming_rows(fr, rows, lo, hi)
    want = kernels.masked_hamming_ref(fr.movedim(-1, 0),
                                      rows[..., :W].movedim(-1, 0), lo, hi)
    torch.cuda.synchronize()
    err = max(err, int((got - want).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError("masked_hamming_rows differs from the plain "
                             "version at the round shape")
    out["round"] = dict(
        shape=f"B={B} M={M} W={W} rows stride {W + 1}",
        ms=cuda_ms(torch, lambda: kernels.masked_hamming_rows(
            fr, rows, lo, hi)),
        plain_ms=cuda_ms(torch, lambda: kernels.masked_hamming_ref(
            fr.movedim(-1, 0), rows[..., :W].movedim(-1, 0), lo, hi)))
    # word-major (W, B, K), the JAX kernel's layout and microbench shape
    B2, K = 16384, 128
    a, b, lo2, hi2 = kernel_inputs(torch, (B2, K), W, SEED + 1)
    a = a.movedim(-1, 0).contiguous()
    b = b.movedim(-1, 0).contiguous()
    got = kernels.masked_hamming(a, b, lo2, hi2)
    want = kernels.masked_hamming_ref(a, b, lo2, hi2)
    torch.cuda.synchronize()
    err = max(err, int((got - want).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError("masked_hamming differs from the plain version "
                             "at the word-major shape")
    out["word_major"] = dict(
        shape=f"W={W} B={B2} K={K}",
        ms=cuda_ms(torch, lambda: kernels.masked_hamming(a, b, lo2, hi2)),
        plain_ms=cuda_ms(torch, lambda: kernels.masked_hamming_ref(
            a, b, lo2, hi2)))
    return out, err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); it runs only on a GPU")
    from spring_tpu_torch import api
    from spring_tpu_torch.ops import _build, kernels
    from spring_tpu_torch.pipeline import short_mode
    from spring_tpu_torch.reorder import engine
    from spring_tpu_torch.utils import synth

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"device {kind} | count {torch.cuda.device_count()}")

    t = time.time()
    _build.load()
    log(f"[build] masked_hamming library built+loaded in "
        f"{time.time() - t:.3f} s")
    t = time.time()
    api.load_host_library()
    log(f"[build] native host library built+loaded in "
        f"{time.time() - t:.3f} s")

    kres, max_err = check_kernel(torch, kernels)
    for name, r in kres.items():
        log(f"[kernel] masked_hamming {name} ({r['shape']}): equal to "
            f"masked_hamming_ref; kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms (median CUDA events) on {card}")

    opts = api.CompressOptions(num_threads=THREADS, verbose=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fq2 = os.path.join(tmp, "small.fastq")
        synth.make_se(fq2, 16384, read_len=100, genome_size=40_000, seed=7,
                      n_rate=0.0005)
        a_gpu = os.path.join(tmp, "gpu.stpu")
        a_cpu = os.path.join(tmp, "cpu.stpu")
        t = time.time()
        api.compress([fq2], a_gpu, opts, device="cuda")
        torch.cuda.synchronize()
        small_s = time.time() - t
        api.compress([fq2], a_cpu, opts, device="cpu")
        with open(a_gpu, "rb") as f1, open(a_cpu, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError("16k-read archive differs between "
                                     "the card and the CPU path")
        log(f"[check] 16384-read archive: card and CPU path byte-equal "
            f"(card compress {small_s:.3f} s)")

        fq = os.path.join(tmp, "in.fastq")
        t = time.time()
        synth.make_se(fq, N_READS, read_len=100, genome_size=GENOME,
                      seed=SEED)
        log(f"[data] {N_READS} SE reads x 100 bp, genome {GENOME}, seed "
            f"{SEED}: {os.path.getsize(fq)} bytes in {time.time() - t:.1f} s")
        arc = os.path.join(tmp, "in.stpu")
        out = os.path.join(tmp, "out.fastq")
        kernels.masked_hamming.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        api.compress([fq], arc, opts, device="cuda")
        torch.cuda.synchronize()
        comp_s = time.time() - t
        launches = kernels.masked_hamming.launches
        peak = torch.cuda.max_memory_allocated()
        stats = dict(engine.LAST_RUN_STATS)
        stages = dict(short_mode.LAST_STAGE_SECONDS)
        t = time.time()
        api.decompress(arc, [out], num_threads=THREADS, verbose=False)
        dec_s = time.time() - t
        if not filecmp.cmp(fq, out, shallow=False):
            raise AssertionError("1M-read round trip is not byte-exact")
        log(f"[main] compress {comp_s:.3f} s = {N_READS / comp_s:.1f} "
            f"reads/s; decompress {dec_s:.3f} s; round trip byte-exact; "
            f"archive {os.path.getsize(arc)} bytes; peak device memory "
            f"{peak} bytes")
        log(f"[main] stages_s {json.dumps(stages)}")
        log(f"[main] engine {json.dumps(stats)}")
        log(f"[main] masked_hamming launches {launches} over "
            f"{stats['rounds']} rounds")
        if launches <= 0 or launches < stats["rounds"]:
            raise AssertionError(
                f"the main path launched the kernel {launches} times in "
                f"{stats['rounds']} rounds")

    r = kres["round"]
    log(json.dumps({"kernels": [{
        "name": "masked_hamming", "route": "cuda",
        "source": "spring_tpu_torch/csrc/masked_hamming.cu",
        "replaces": "spring_tpu/ops/pallas_kernels.py:59",
        "launches": launches, "max_abs_err": max_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
