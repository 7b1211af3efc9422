#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build, side by side, the CUDA kernel library from
     spring_tpu_torch/csrc (nvcc) and the port's native host library from
     spring_tpu_torch/csrc/host (g++);
  3. the masked-Hamming kernel against masked_hamming_ref on the card,
     exact equality, at the reorder round's shape (B=4096 walkers x M=16
     slots, W=7 words, rows of stride W+1) and at the word-major
     (W=7, B=16384, K=128) shape, with edge ranges; median CUDA-event
     times of both;
  4. a 16,384-read set compressed on the card and on the CPU: the two
     archives must be byte-equal (the CPU path is held to the JAX
     package's output by tests/test_torch_*.py); this also warms the card
     up;
  5. the main path: 1,000,000 single-end 100 bp reads
     (synth.make_se(genome_size=2_000_000, seed=42), ~50x coverage)
     compressed with spring_tpu_torch.api.compress(device="cuda"),
     decompressed and byte-compared with the input; the kernel's launch
     count over that compress must be at least the number of rounds;
  6. paired-end with read reordering at full size: 500,000 pairs
     (synth.make_pe, same genome and seed), CompressOptions(reorder=True)
     on the card, decompressed by the port; the multiset of
     (read 1, read 2) record pairs must be preserved and mates must stay
     paired; launches at least the number of rounds;
  7. the other modes at 16,384 reads or pairs each: PE order-preserving,
     SE ill_bin, SE qvz, SE FASTA, SE gzip in and out, a super-shard run
     (cap lowered to 8,192 reads) and long mode, each compressed on the
     card and on the CPU to byte-equal archives, the lossless ones
     round-tripped byte-exact, plus one read range of the PE archive
     against the same slice of the input.
Then one JSON line of kernel results (launches summed over phases 5-7,
the kernel's time beside its bound on this card) and, last, the device
line {"ok": true, "device": {...}}. Any failure raises: the exit code is
then not 0 and no result line is printed. Needs a CUDA card; imports
neither JAX nor the JAX package.
"""
import filecmp
import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# the port runs without JAX and without the JAX package: from here on any
# import of either fails
sys.modules["jax"] = None
sys.modules["spring_tpu"] = None

N_READS = 1_000_000
GENOME = 2_000_000
SEED = 42
THREADS = 8
N_PAIRS = 500_000
N_SMALL = 16_384
SHARD_CAP = 8_192

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float32 rate outside the tensor cores, taken here as the rate of
# the kernel's 32-bit integer operations
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# masked Hamming, per packed word: xor, shift, or, and (fold); two prefix
# masks of a subtract, a clamp and a shift each, a not and an and; the
# final and, popcount and add
OPS_PER_WORD = 14


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


def kernel_bound(n_out: int, W: int) -> dict:
    """The least time the card could take for n_out masked-Hamming
    outputs over W words: each output reads W frame words, W row words,
    lo and hi, and writes one word; against the published peaks."""
    nbytes = n_out * (2 * W + 3) * 4
    ops = n_out * W * OPS_PER_WORD
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
        **kernel_bound(B * M, W),
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
        **kernel_bound(B2 * K, W),
        ms=cuda_ms(torch, lambda: kernels.masked_hamming(a, b, lo2, hi2)),
        plain_ms=cuda_ms(torch, lambda: kernels.masked_hamming_ref(
            a, b, lo2, hi2)))
    return out, err


def read_records(path: str, lines_per: int = 4) -> list:
    """The records of a FASTQ (4 lines) or FASTA (2 lines) file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [b"\n".join(lines[i:i + lines_per])
            for i in range(0, len(lines) - 1, lines_per)]


def same_bytes(a: str, b: str, what: str) -> None:
    if not filecmp.cmp(a, b, shallow=False):
        raise AssertionError(f"{what}: {a} and {b} differ")


def to_fasta(fq: str, out: str) -> None:
    with open(out, "wb") as o:
        for rec in read_records(fq):
            head, seq = rec.split(b"\n")[:2]
            o.write(b">" + head[1:] + b"\n" + seq + b"\n")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); it runs only on a GPU")
    from spring_tpu_torch import api, params
    from spring_tpu_torch.codecs import native
    from spring_tpu_torch.io.container import ArchiveReader
    from spring_tpu_torch.ops import _build, kernels
    from spring_tpu_torch.pipeline import short_mode
    from spring_tpu_torch.reorder import engine
    from spring_tpu_torch.utils import synth

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"device {kind} | count {torch.cuda.device_count()}")

    def timed(fn):
        t = time.time()
        fn()
        return time.time() - t

    t = time.time()
    with ThreadPoolExecutor(max_workers=2) as ex:
        f_kernel = ex.submit(timed, _build.load)
        f_host = ex.submit(timed, native.load)
        log(f"[build] masked_hamming library built+loaded in "
            f"{f_kernel.result():.3f} s")
        log(f"[build] native host library built+loaded in "
            f"{f_host.result():.3f} s")
    log(f"[build] both, side by side, in {time.time() - t:.3f} s")

    kres, max_err = check_kernel(torch, kernels)
    for name, r in kres.items():
        log(f"[kernel] masked_hamming {name} ({r['shape']}): equal to "
            f"masked_hamming_ref; kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms (median CUDA events); bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']} "
            f"bytes at {HBM_BYTES_PER_S:.3g} B/s, {r['ops']} operations "
            f"at {ALU_OPS_PER_S:.3g}/s) on {card}")

    launches_total = 0

    def on_card(files, arc, opts):
        """api.compress on the card with the launch count set to 0 just
        before and read just after: (seconds, launches, engine stats)."""
        nonlocal launches_total
        kernels.masked_hamming.launches = 0
        engine.LAST_RUN_STATS.clear()
        torch.cuda.synchronize()
        t = time.time()
        api.compress(files, arc, opts, device="cuda")
        torch.cuda.synchronize()
        secs = time.time() - t
        n = kernels.masked_hamming.launches
        launches_total += n
        return secs, n, dict(engine.LAST_RUN_STATS)

    def need_launches(what, n, rounds):
        if n <= 0 or n < rounds:
            raise AssertionError(f"{what} launched the kernel {n} times "
                                 f"in {rounds} rounds")

    opts = api.CompressOptions(num_threads=THREADS, verbose=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fq2 = os.path.join(tmp, "small.fastq")
        synth.make_se(fq2, N_SMALL, read_len=100, genome_size=40_000, seed=7,
                      n_rate=0.0005)
        a_gpu = os.path.join(tmp, "gpu.stpu")
        a_cpu = os.path.join(tmp, "cpu.stpu")
        t = time.time()
        api.compress([fq2], a_gpu, opts, device="cuda")
        torch.cuda.synchronize()
        small_s = time.time() - t
        api.compress([fq2], a_cpu, opts, device="cpu")
        same_bytes(a_gpu, a_cpu, "16k-read archive, card against CPU path")
        log(f"[check] {N_SMALL}-read archive: card and CPU path byte-equal "
            f"(card compress {small_s:.3f} s)")

        # ---- phase 5: 1M SE reads, order-preserving
        fq = os.path.join(tmp, "in.fastq")
        t = time.time()
        synth.make_se(fq, N_READS, read_len=100, genome_size=GENOME,
                      seed=SEED)
        log(f"[data] {N_READS} SE reads x 100 bp, genome {GENOME}, seed "
            f"{SEED}: {os.path.getsize(fq)} bytes in {time.time() - t:.1f} s")
        arc = os.path.join(tmp, "in.stpu")
        out = os.path.join(tmp, "out.fastq")
        torch.cuda.reset_peak_memory_stats()
        comp_s, launches, stats = on_card([fq], arc, opts)
        peak = torch.cuda.max_memory_allocated()
        stages = dict(short_mode.LAST_STAGE_SECONDS)
        t = time.time()
        api.decompress(arc, [out], num_threads=THREADS, verbose=False)
        dec_s = time.time() - t
        same_bytes(fq, out, "1M-read round trip")
        log(f"[main] compress {comp_s:.3f} s = {N_READS / comp_s:.1f} "
            f"reads/s; decompress {dec_s:.3f} s; round trip byte-exact; "
            f"archive {os.path.getsize(arc)} bytes; peak device memory "
            f"{peak} bytes")
        log(f"[main] stages_s {json.dumps(stages)}")
        log(f"[main] engine {json.dumps(stats)}")
        log(f"[main] masked_hamming launches {launches} over "
            f"{stats['rounds']} rounds")
        need_launches("the main path", launches, stats["rounds"])
        for f in (fq, arc, out):
            os.remove(f)

        # ---- phase 6: 500k pairs with read reordering
        p1, p2 = os.path.join(tmp, "r1.fastq"), os.path.join(tmp, "r2.fastq")
        t = time.time()
        synth.make_pe(p1, p2, N_PAIRS, read_len=100, genome_size=GENOME,
                      seed=SEED)
        log(f"[data] {N_PAIRS} read pairs x 100 bp, genome {GENOME}, seed "
            f"{SEED}: {os.path.getsize(p1) + os.path.getsize(p2)} bytes in "
            f"{time.time() - t:.1f} s")
        o1, o2 = os.path.join(tmp, "o1.fastq"), os.path.join(tmp, "o2.fastq")
        torch.cuda.reset_peak_memory_stats()
        comp_s, launches, stats = on_card(
            [p1, p2], arc, api.CompressOptions(
                reorder=True, num_threads=THREADS, verbose=False))
        peak = torch.cuda.max_memory_allocated()
        stages = dict(short_mode.LAST_STAGE_SECONDS)
        t = time.time()
        cp = api.decompress(arc, [o1, o2], num_threads=THREADS,
                            verbose=False)
        dec_s = time.time() - t
        # line i of output 1 pairs with line i of output 2, and the
        # multiset of pairs is the input's
        want = sorted(zip(read_records(p1), read_records(p2)))
        got = sorted(zip(read_records(o1), read_records(o2)))
        if cp.num_reads != 2 * N_PAIRS or len(got) != N_PAIRS or want != got:
            raise AssertionError("PE -r: the multiset of (read 1, read 2) "
                                 "record pairs changed")
        del want, got
        log(f"[pe-r] {N_PAIRS} pairs, reorder: compress {comp_s:.3f} s = "
            f"{2 * N_PAIRS / comp_s:.1f} reads/s; decompress {dec_s:.3f} s; "
            f"pairs preserved; archive {os.path.getsize(arc)} bytes; "
            f"unmatched fraction {stats['unmatched_frac']}; rounds "
            f"{stats['rounds']}; launches {launches}; peak device memory "
            f"{peak} bytes; on {card}")
        log(f"[pe-r] stages_s {json.dumps(stages)}")
        log(f"[pe-r] engine {json.dumps(stats)}")
        need_launches("the PE -r path", launches, stats["rounds"])
        for f in (p1, p2, o1, o2, arc):
            os.remove(f)

        # ---- phase 7: the other modes, card against CPU path
        s1, s2 = os.path.join(tmp, "s1.fastq"), os.path.join(tmp, "s2.fastq")
        synth.make_pe(s1, s2, N_SMALL, read_len=100, genome_size=60_000,
                      insert_mean=220.0, seed=11, n_rate=0.0005)
        fa = os.path.join(tmp, "small.fasta")
        to_fasta(fq2, fa)
        gz = fq2 + ".gz"
        with open(fq2, "rb") as f, gzip.open(gz, "wb", compresslevel=1) as o:
            o.write(f.read())
        modes = [
            # name, inputs, plain inputs, option fields, shard cap, gz out
            ("pe", [s1, s2], [s1, s2], {}, None, False),
            ("ill_bin", [fq2], None, {"quality_mode": "ill_bin"}, None,
             False),
            ("qvz", [fq2], None, {"quality_mode": "qvz", "qvz_ratio": 8.0},
             None, False),
            ("fasta", [fa], [fa], {"fasta_input": True}, None, False),
            ("gz", [gz], [fq2], {}, None, True),
            ("super-shard", [fq2], [fq2], {}, SHARD_CAP, False),
            ("long", [fq2], [fq2], {"long_mode": True}, None, False),
        ]
        full_cap = params.MAX_NUM_READS_SHORT
        for name, files, plain, fields, cap, gz_out in modes:
            mopts = api.CompressOptions(num_threads=THREADS, verbose=False,
                                        **fields)
            a_gpu = os.path.join(tmp, f"{name}.gpu.stpu")
            a_cpu = os.path.join(tmp, f"{name}.cpu.stpu")
            params.MAX_NUM_READS_SHORT = cap or full_cap
            try:
                secs, launches, stats = on_card(files, a_gpu, mopts)
                api.compress(files, a_cpu, mopts, device="cpu")
            finally:
                params.MAX_NUM_READS_SHORT = full_cap
            same_bytes(a_gpu, a_cpu, f"{name} archive, card against CPU")
            if not fields.get("long_mode"):
                need_launches(f"the {name} path", launches,
                              stats.get("rounds", 0))
            if cap:
                with ArchiveReader(a_gpu) as r:
                    if len(r.params.shard_reads) != N_SMALL // cap:
                        raise AssertionError(
                            f"expected {N_SMALL // cap} shards, got "
                            f"{r.params.shard_reads}")
            trip = "lossy, no round trip"
            if plain is not None:
                outs = [os.path.join(tmp, f"{name}.o{j}"
                                     + (".gz" if gz_out else ""))
                        for j in range(len(plain))]
                api.decompress(a_gpu, outs, gzipped=gz_out,
                               num_threads=THREADS, verbose=False)
                for pth, o in zip(plain, outs):
                    if gz_out:
                        if read_records(o) != read_records(pth):
                            raise AssertionError(f"{name}: gzip output "
                                                 f"differs from {pth}")
                    else:
                        same_bytes(pth, o, f"{name} round trip")
                trip = "round trip byte-exact"
            log(f"[mode] {name}: card and CPU archives byte-equal "
                f"({os.path.getsize(a_gpu)} bytes); {trip}; card compress "
                f"{secs:.3f} s; launches {launches}")
        # one read range of the PE archive, over the global index space
        # (file-1 reads, then file-2 reads), straddling the file boundary
        lo, hi = N_SMALL - 384, N_SMALL + 616
        part = os.path.join(tmp, "pe.range.fastq")
        api.decompress(os.path.join(tmp, "pe.gpu.stpu"), [part],
                       num_threads=THREADS, read_range=(lo, hi),
                       verbose=False)
        if read_records(part) != (read_records(s1)
                                  + read_records(s2))[lo:hi]:
            raise AssertionError("PE read range differs from the slice of "
                                 "the input")
        log(f"[mode] pe range [{lo}, {hi}): equal to the slice of the input")

    r = kres["round"]
    log(json.dumps({"kernels": [{
        "name": "masked_hamming", "route": "cuda",
        "source": "spring_tpu_torch/csrc/masked_hamming.cu",
        "replaces": "spring_tpu/ops/pallas_kernels.py:59",
        "launches": launches_total, "max_abs_err": max_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
