#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build, side by side, the CUDA kernel library from
     spring_tpu_torch/csrc (nvcc) and the port's native host library from
     spring_tpu_torch/csrc/host (g++);
  3. every entry of the kernel library (spring_tpu_torch/csrc/
     masked_hamming.cu) against its plain PyTorch version on the card,
     exact equality: the fused fetch-and-verify kernel verify_rows at the
     reorder round's shape (B=4096 walkers x M=16 slots, W=7 words, SC=16
     shifts, a 2^20-row table; claimed bits, candidates below 0 and past
     the table, padding rows, empty ranges, negative offsets, both
     orientations), the same at the round's shape of bench_torch.py's
     10M reads (B=8192 walkers, a 2^24-row table) and at that of
     tools/rss_check_torch.py's 100M reads (B=8192 walkers, the engine's
     1/8-octave table of 6 * 2^24 = 100,663,296 rows), and masked_hamming
     at the row-major round shape (4096 walkers, and the 2048 and 1024 that a
     rank of 2 or 4 holds, and the 8192 of the distributed round at 10M
     reads on one rank) and the word-major (W=7, B=16384, K=128) shape
     with edge ranges. A kernel's time is the device's: CUDA events around
     the replay of a CUDA graph of 200 launches, captured inside the
     library (an empty kernel timed the same way is printed as the floor);
     the wrapper's time over Python calls is printed beside it as its
     enqueue time;
  4. a 16,384-read set compressed on the card and on the CPU: the two
     archives must be byte-equal (the CPU path is held to the JAX
     package's output by tests/test_torch_*.py), and the card's engine
     must have replayed its captured round at least twice and compacted
     its seed queue at least once; this also warms the card up;
  5. the main path: 1,000,000 single-end 100 bp reads
     (synth.make_se(genome_size=2_000_000, seed=42), ~50x coverage)
     compressed with spring_tpu_torch.api.compress(device="cuda"),
     decompressed and byte-compared with the input; the fused kernel's
     launch count over that compress must equal the rounds run, and the
     flush program must be a cache miss (phase 4's shape differs) with one
     round called;
  6. paired-end with read reordering at full size: 500,000 pairs
     (synth.make_pe, same genome and seed), CompressOptions(reorder=True)
     on the card, decompressed by the port; the multiset of
     (read 1, read 2) record pairs must be preserved and mates must stay
     paired; launches equal to the rounds run;
  7. the other modes at 16,384 reads or pairs each: PE order-preserving,
     SE ill_bin, SE qvz, SE FASTA, SE gzip in and out, a super-shard run
     (cap lowered to 8,192 reads) and long mode, each compressed on the
     card and on the CPU to byte-equal archives, the lossless ones
     round-tripped byte-exact, plus one read range of the PE archive
     against the same slice of the input;
  8. the distributed reorder engine (spring_tpu_torch/parallel) at world
     size 1 over NCCL, the group formed through the port's
     multihost.initialize: both collectives against the identity at the
     round's sizes, then phase 5's 1,000,000 reads through
     api.compress(CompressOptions(dist=True), device="cuda"): round trip
     byte-exact, the archive within 5% + 10,240 bytes of phase 5's (the
     distributed round differs from the single-device round by design),
     seven collectives a round, and one launch of the masked-Hamming
     kernel (masked_hamming_rows) for every round run;
  9. only where more than one card is visible: the same compress on the
     largest power of two of ranks up to 4, one process and one card
     each, through multihost.launch: the emissions equal on every rank,
     round trip byte-exact, the same numbers as phase 8, every rank's
     flushes replayed as CUDA graphs with its collectives inside. With one
     card it prints one line saying so. It never puts two ranks on one
     card and never moves to the CPU. ``multi_card_phase()`` runs phase 5's
     single-engine compress and this phase alone;
 10. the large-input path: 2,000,000 SE reads (bench.py's profile,
     genome 4,000,000, seed 42) compressed twice in this process with the
     default options: the first call must stage its rows on the card
     while it parses and prewarm the dictionary build, and miss the
     program cache; the second must hit it, call no round and capture
     nothing; the two archives byte-equal, the round trip byte-exact;
 11. the engine's tuning paths (CompressOptions.engine): far-shift
     dictionary thinning (far_near 4), 6 emission slots a round, flushes
     of 16 rounds and in-bin dictionary compaction (rebuild_fraction).
     11a: phase 4's set at rebuild_fraction 0.05, card against CPU, byte-
     equal archives, at least one dictionary compaction in each, the
     card's round replayed; 11b: phase 5's reads at rebuild_fraction
     0.22: round trip byte-exact, at least one compaction, a program-cache
     miss with one round called, launches equal to the rounds run, the
     archive and unmatched fraction printed beside phase 5's; 11c: the
     distributed engine at world size 1 over NCCL, as in phase 8, at
     rebuild_fraction 0.22 and flushes of 16 rounds: round trip byte-
     exact, at least one compaction, seven collectives a round (a
     compaction adds none), launches equal to the rounds run;
 12. the rest of the port: 12a, wide dictionary rows on demand
     (CompressOptions.engine force_wide) on phase 4's set, card against
     CPU, byte-equal archives, both engines' tables 14 words a bucket;
     12b, force_wide on phase 5's reads: a program-cache miss with one
     round called (the wide-row probe inside the graphed round), round
     trip byte-exact, launches equal to the rounds run, rounds and
     archive printed beside phase 5's; 12c, the entry points
     (spring_tpu_torch/entry.py): entry()'s round on the card equal to
     the same round on the CPU, state and emissions, one launch of the
     fused kernel; 12d, dryrun_multichip over NCCL on the largest power
     of two of ranks (up to 4) that the visible cards give, one card a
     rank: every read placed once, every rank's emissions equal, one
     launch a round run on every rank; 12e, phase 10's 2M reads with
     CompressOptions(stager=False): rows not staged, the prewarm run, the
     archive byte-equal to phase 10's;
 13. the multi-segment consensus match (second chance and stitching past
     a 2^25-base consensus, as at 100M reads): align_leftovers_packed on
     the card against the port's CPU path, exactly equal, on a consensus
     of 2^25 + 2^20 bases (three segment dictionaries) and 20,000 reads,
     without and with stitching's exclude, each segment's matcher loop
     replayed (segments_phase);
 14. the engine-sweep tools on phase 4's 16,384 reads (sweep_phase):
     tools/knob_sweep_torch.py's flushes of baseline and shift_chunk=8 on
     the card equal to the same on the CPU (each flush's stats, the
     claimed reads), and tools/sweep_probe_torch.py on the card with
     base= and fn4=far_near:4, two passes each and its default check:
     every archive byte-equal to the CPU path's with the same engine
     dict, round trips byte-exact. Its launches stay out of the kernels
     line.
Every engine run on the card (phases 4-11) runs its flushes on the flush
runner (spring_tpu_torch/reorder/engine.py) from the program cache
(spring_tpu_torch/ops/graphs.py): on a miss the first round called, then
captured with the flush's compaction and replayed, on a hit every round
replayed from the first flush on. Its line gives rounds, rounds run, the
cache's state, rounds called, graphed flushes, round replays,
capture+instantiate seconds, the graph pool, ms a round, engine seconds
and the cache's bytes; a run with a second round called, a round or a
compaction not replayed (but a miss's first compaction), a launch count
other than the rounds run, or a capture on a hit fails. Launch counts and
collectives are counted at each replay of a graph that holds them. Second
chance's and stitching's matchers run their loop over row chunks of one
shape as one CUDA graph when it has more than one chunk
(ops/graphs.py::ShapeLoop; phase 4 lowers the chunk so that both do,
card against CPU); phases 4, 5, 10 and 12b print each matcher's loops,
iterations, captures, replays, capture seconds and pool bytes, and a
loop whose iterations after the first were not all replayed fails.
Then one JSON line of kernel results (launches summed over phases 5-11,
each entry's device time beside its bound on this card; phase 13's
numbers under "multi_segment_match") and, last, the device
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
# phase 10: bench.py's profile at 2M reads, the large-input path
N_LARGE = 2_000_000
GENOME_LARGE = 4_000_000
# phase 11: the engine's tuning paths, the knob values of the JAX
# package's own records (PROFILE.md); rebuild_fraction set per part
TUNED = dict(far_near=4, cap_per_round=6, flush_rounds=16)

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float32 rate outside the tensor cores, taken here as the rate of
# the kernel's 32-bit integer operations
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# masked Hamming, per packed word: xor, shift, or, and (fold); two prefix
# masks of a subtract, a clamp and a shift each, a not and an and; the
# final and, popcount and add
OPS_PER_WORD = 14
# the fused verify, per slot beside its words: clamp the id, the row's
# address, the bitmap test, the length mask, the shift, lo/hi/t, the accept
OPS_PER_SLOT = 22


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


def _bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take to move nbytes and do ops
    integer operations, against the published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_bound(n_out: int, W: int) -> dict:
    """Bound of n_out masked-Hamming outputs over W words: each output
    reads W frame words, W row words, lo and hi, and writes one word."""
    return _bound(n_out * (2 * W + 3) * 4, n_out * W * OPS_PER_WORD)


def verify_bound(torch, args) -> dict:
    """Bound of one fused verify on these inputs. Every input is read once
    and every output written once: per output its row (W + 1 words), the
    candidate id, the frame index, one bitmap word, the valid byte in; ham,
    t, clen and the ok byte out; per walker ref_len, shift_base and those of
    its 2*SC frames that a slot of this run names (counted from k_frame;
    the kernel itself stages all 2*SC, which the function does not
    need)."""
    rows_tab, cand, _, _, frames, k_frame, shift_base, ref_len = args
    n = cand.numel()
    B, W = cand.shape[0], rows_tab.shape[1] - 1
    F = frames.numel() // (B * W)
    walker = torch.arange(B, device=k_frame.device)[:, None]
    named = int(torch.unique(walker * F + k_frame.clamp(0, F - 1)).numel())
    nbytes = (n * ((W + 1) * 4 + 4 + 4 + 4 + 1 + 3 * 4 + 1)
              + (named * W + shift_base.numel() + ref_len.numel()) * 4)
    return _bound(nbytes, n * (W * OPS_PER_WORD + OPS_PER_SLOT))


def verify_inputs(torch, B, M, W, SC, Np, n_real, seed):
    """Inputs of the fused verify at the round's shape, made on the card:
    a random row table (length word 100; padding rows past n_real carry
    bit 31 and length 0), candidates spread over the table in pairs that
    share a frame (as the round's C = 2 candidates a probe group do), a
    third of the slots matching their frame up to a few flipped bases, a
    quarter of the bitmap claimed, and the edge cases: cand < 0,
    cand >= Np (the sentinel 2^31 - 1 included), padding rows, walkers
    with ref_len 0 (hi <= lo), negative t, both orientations."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    i32 = torch.int32

    def words(sz):
        return torch.randint(-2**31, 2**31, sz, generator=g, device="cuda",
                             dtype=torch.int64).to(i32)

    def rnd(lo, hi, sz):
        return torch.randint(lo, hi, sz, generator=g, device="cuda",
                             dtype=i32)

    def chance(p, sz):
        return torch.rand(sz, generator=g, device="cuda") < p

    F = 2 * SC
    rows_tab = words((Np, W + 1))
    rows_tab[:, W] = 100
    rows_tab[n_real:, W] = -2**31
    cand = rnd(0, n_real, (B, M))
    k_frame = rnd(0, F, (B, M // 2)).repeat_interleave(2, dim=1).contiguous()
    frames = words((B, F, W))
    bi, mi = torch.nonzero(chance(0.34, (B, M)), as_tuple=True)
    near = rows_tab[cand[bi, mi].long(), :W].clone()
    nflip = rnd(0, 7, (len(bi),))
    for j in range(6):
        bit = (rnd(1, 4, (len(bi),)) << (2 * rnd(0, 16, (len(bi),))))
        wi = rnd(0, W, (len(bi),)).long()
        rowsel = torch.arange(len(bi), device="cuda")
        near[rowsel, wi] ^= torch.where(nflip > j, bit, 0).to(i32)
    frames[bi, k_frame[bi, mi].long()] = near
    cand[chance(0.03, (B, M))] = -1
    cand[chance(0.03, (B, M))] = 2**31 - 1
    cand[chance(0.02, (B, M))] = Np
    pad = chance(0.02, (B, M))
    cand[pad] = rnd(n_real, Np, (B, M))[pad]
    cand.view(-1)[:3] = torch.tensor([0, Np - 1, -2**31], dtype=i32)
    valid = chance(0.8, (B, M))
    nwords = Np // 32 + 2
    claimed = words((nwords,)) & words((nwords,))
    ref_len = rnd(60, 16 * W + 1, (B,))
    ref_len[chance(0.02, (B,))] = 0
    shift_base = SC * rnd(0, 3, (B,))
    return (rows_tab, cand, valid, claimed, frames, k_frame, shift_base,
            ref_len)


def check_kernel(torch, kernels, thresh):
    """Phase 3: every entry of the kernel library against its plain
    version, exact equality, with its times; thresh is the round's accept
    limit. Returns (entries by name, max_abs_err)."""
    out = {}
    err = 0
    W = 7

    def same(what, got, want):
        nonlocal err
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g.to(torch.int32) - w.to(torch.int32))
                               .abs().max()))
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"{what} differs from its plain "
                                     "version")

    # ---- the fused verify at the round's shape: 4096 walkers x 16 slots
    # over the 2^20-row table of a 1M-read run
    B, M, SC, Np = 4096, 16, 16, 1 << 20
    vargs = verify_inputs(torch, B, M, W, SC, Np, N_READS, SEED + 2)
    want = kernels.verify_rows_ref(*vargs, thresh)
    same("verify_rows", kernels.verify_rows(*vargs, thresh), want)
    ok, t, clen, _ = want
    rows_tab, cand, _, _, _, k_frame, shift_base, ref_len = vargs
    o = k_frame & 1
    s = shift_base[:, None] + (k_frame >> 1)
    lo = torch.where(o == 0, 0, s)
    hi = torch.minimum(ref_len[:, None] + torch.where(o == 0, -s, s), clen)
    pad_row = rows_tab[cand.clamp(0, Np - 1).long(), W] < 0
    for what, hit in (("accepts forward", ok & (o == 0)),
                      ("accepts reverse", ok & (o == 1)),
                      ("t < 0", t < 0), ("cand < 0", cand < 0),
                      ("cand >= Np", cand >= Np), ("hi <= lo", hi <= lo),
                      ("a padding row", pad_row),
                      ("a claimed row", ~ok & (
                          kernels.verify_rows_ref(
                              *vargs[:3], torch.zeros_like(vargs[3]),
                              *vargs[4:], thresh)[0]))):
        if not bool(hit.any()):
            raise AssertionError(f"verify inputs hold no case of {what}")
    ms, got = kernels.verify_rows_device_ms(*vargs, thresh)
    same("verify_rows (timed launches)", got, want)
    out["verify_rows"] = dict(
        shape=f"B={B} M={M} W={W} SC={SC} Np={Np}",
        **verify_bound(torch, vargs), ms=ms,
        enqueue_ms=cuda_ms(torch, lambda: kernels.verify_rows(*vargs,
                                                              thresh)),
        plain_ms=cuda_ms(torch, lambda: kernels.verify_rows_ref(*vargs,
                                                                thresh)),
        accepted=int(ok.sum()))
    del vargs, want, got
    # ---- the fused verify at the round's shape of bench_torch.py's 10M
    # reads: 8192 walkers (the REORDER_BATCH cap) over a 2^24-row table,
    # and of tools/rss_check_torch.py's 100M reads: the same walkers over
    # the engine's 1/8-octave table of 6 * 2^24 rows
    from spring_tpu_torch.reorder.engine import padded_n
    B8 = 8192
    for key, n_big, seed in (("at_10M_reads", 10_000_000, SEED + 3),
                             ("at_100M_reads", 100_000_000, SEED + 4)):
        Np_big = padded_n(n_big)
        vargs = verify_inputs(torch, B8, M, W, SC, Np_big, n_big, seed)
        want = kernels.verify_rows_ref(*vargs, thresh)
        same(f"verify_rows {key}", kernels.verify_rows(*vargs, thresh),
             want)
        ms, got = kernels.verify_rows_device_ms(*vargs, thresh)
        same(f"verify_rows {key} (timed launches)", got, want)
        out["verify_rows"][key] = dict(
            shape=f"B={B8} M={M} W={W} SC={SC} Np={Np_big}",
            **verify_bound(torch, vargs), ms=ms,
            enqueue_ms=cuda_ms(torch, lambda: kernels.verify_rows(
                *vargs, thresh)),
            plain_ms=cuda_ms(torch, lambda: kernels.verify_rows_ref(
                *vargs, thresh)),
            accepted=int(want[0].sum()))
        del vargs, want, got
    # ---- masked Hamming, row-major: (B, M, W) frames, (B, M, W+1) rows
    fr, rw, lo, hi = kernel_inputs(torch, (B, M), W, SEED)
    lw = torch.full((B, M, 1), 100, dtype=torch.int32, device="cuda")
    rows = torch.cat([rw, lw], dim=-1).contiguous()

    def plain_rows():
        return kernels.masked_hamming_ref(
            fr.movedim(-1, 0), rows[..., :W].movedim(-1, 0), lo, hi)

    same("masked_hamming_rows",
         [kernels.masked_hamming_rows(fr, rows, lo, hi)], [plain_rows()])
    # a rank of 2 or 4 (phase 9) holds 2048 or 1024 of the walkers
    for Bl in (B // 2, B // 4):
        same(f"masked_hamming_rows at B={Bl}",
             [kernels.masked_hamming_rows(fr[:Bl], rows[:Bl], lo[:Bl],
                                          hi[:Bl])],
             [kernels.masked_hamming_ref(
                 fr[:Bl].movedim(-1, 0), rows[:Bl, :, :W].movedim(-1, 0),
                 lo[:Bl], hi[:Bl])])
    out["masked_hamming_rows"] = dict(
        shape=f"B={B} M={M} W={W} rows stride {W + 1}",
        **kernel_bound(B * M, W),
        ms=kernels.masked_hamming_device_ms(fr, rows, lo, hi,
                                            row_major=True),
        enqueue_ms=cuda_ms(torch, lambda: kernels.masked_hamming_rows(
            fr, rows, lo, hi)),
        plain_ms=cuda_ms(torch, plain_rows))
    del fr, rw, lo, hi, lw, rows
    # ---- the same at the distributed round's shape of a 10M-read input
    # at world size 1 (tools/bench_dist_torch.py): 8192 walkers
    fr, rw, lo, hi = kernel_inputs(torch, (B8, M), W, SEED + 5)
    lw = torch.full((B8, M, 1), 100, dtype=torch.int32, device="cuda")
    rows = torch.cat([rw, lw], dim=-1).contiguous()
    same("masked_hamming_rows at_10M_dist_round",
         [kernels.masked_hamming_rows(fr, rows, lo, hi)], [plain_rows()])
    out["masked_hamming_rows"]["at_10M_dist_round"] = dict(
        shape=f"B={B8} M={M} W={W} rows stride {W + 1}",
        **kernel_bound(B8 * M, W),
        ms=kernels.masked_hamming_device_ms(fr, rows, lo, hi,
                                            row_major=True),
        enqueue_ms=cuda_ms(torch, lambda: kernels.masked_hamming_rows(
            fr, rows, lo, hi)),
        plain_ms=cuda_ms(torch, plain_rows))
    # ---- a rank's quarter of those walkers, the round's shape on four
    # ranks at 10M and at 100M reads (tools/bench_dist_torch.py ranks 4)
    Bq = B8 // 4
    fr, rows, lo, hi = (fr[:Bq].contiguous(), rows[:Bq].contiguous(),
                        lo[:Bq].contiguous(), hi[:Bq].contiguous())
    same("masked_hamming_rows at_100M_dist_round_4_ranks",
         [kernels.masked_hamming_rows(fr, rows, lo, hi)], [plain_rows()])
    out["masked_hamming_rows"]["at_100M_dist_round_4_ranks"] = dict(
        shape=f"B={Bq} M={M} W={W} rows stride {W + 1}",
        **kernel_bound(Bq * M, W),
        ms=kernels.masked_hamming_device_ms(fr, rows, lo, hi,
                                            row_major=True),
        enqueue_ms=cuda_ms(torch, lambda: kernels.masked_hamming_rows(
            fr, rows, lo, hi)),
        plain_ms=cuda_ms(torch, plain_rows))
    del fr, rw, lo, hi, lw, rows
    # ---- word-major (W, B, K), the JAX kernel's layout and microbench
    # shape
    B2, K = 16384, 128
    a, b, lo2, hi2 = kernel_inputs(torch, (B2, K), W, SEED + 1)
    a = a.movedim(-1, 0).contiguous()
    b = b.movedim(-1, 0).contiguous()
    same("masked_hamming", [kernels.masked_hamming(a, b, lo2, hi2)],
         [kernels.masked_hamming_ref(a, b, lo2, hi2)])
    out["masked_hamming"] = dict(
        shape=f"W={W} B={B2} K={K}",
        **kernel_bound(B2 * K, W),
        ms=kernels.masked_hamming_device_ms(a, b, lo2, hi2),
        enqueue_ms=cuda_ms(torch, lambda: kernels.masked_hamming(
            a, b, lo2, hi2)),
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


KERNEL_NAMES = ("verify_rows", "masked_hamming_rows", "masked_hamming")


def engine_line(stats: dict) -> str:
    """One engine run's numbers from engine.LAST_RUN_STATS."""
    return (f"rounds {stats['rounds']} ({stats['rounds_run']} run); "
            f"{stats.get('dict_compactions')} dictionary compactions "
            f"({stats.get('dict_compact_s')} s); "
            f"program cache {stats['program_cache']}, "
            f"{stats['eager_rounds']} rounds called; "
            f"{stats['graphed_flushes']} of {stats['flushes']} flushes "
            f"replayed as CUDA graphs, {stats['round_replays']} round "
            f"replays; capture+instantiate {stats['capture_s']} s; graph "
            f"pool {stats['graph_pool_bytes']} bytes; "
            f"{stats['queue_compactions']} queue compactions; "
            f"{stats['ms_per_round']} ms a round ({stats['warmup_s']} s to "
            f"the capture, {stats['ms_per_graphed_round']} ms a replayed "
            f"round after it); engine {stats['flush_wall_s']} s; cached "
            f"program {stats['cached_program_bytes']} bytes")


def need_graphs(what: str, stats: dict, replays: int = 1,
                compactions: int = 0) -> None:
    """The flush runner's schedule of an engine run on the card: on a
    program-cache miss one round called, then captured (with the
    compaction) and replayed, on a hit no round called and nothing
    captured; every other round and every compaction but a miss's first
    replayed; the round replayed at least ``replays`` times and the seed
    queue compacted at least ``compactions`` times."""
    miss = stats["program_cache"] == "miss"
    called = 1 if miss else 0
    if (stats["flushes"] < 2 or stats["eager_rounds"] != called
            or stats["round_replays"] != stats["rounds_run"] - called
            or stats["graphed_flushes"] != stats["flushes"] - called
            or (stats["capture_s"] is not None) != miss
            or stats["round_replays"] < replays
            or stats["queue_compactions"] < compactions):
        raise AssertionError(
            f"{what}: want {called} round called, every other round and "
            f"{stats['flushes'] - called} compactions replayed as CUDA "
            f"graphs, a capture only on a cache miss, at least {replays} "
            f"round replays and {compactions} queue compactions; engine "
            f"{stats}")


def need_loops(what: str, loops: dict, replayed: bool = False) -> None:
    """The matchers' loops on the card (ops/graphs.py::LOOP_STATS): a
    loop of one chunk calls it, a loop of more captures once and replays
    every chunk after the first, so replays = iterations - loops and
    captures <= loops; ``replayed`` asks for a replay in every matcher."""
    for name, st in loops.items():
        if (st["replays"] != st["iterations"] - st["loops"]
                or st["captures"] > st["loops"]
                or (replayed and not st["replays"])):
            raise AssertionError(f"{what}: the {name} loops were not "
                                 f"replayed as one graph each: {loops}")
    if replayed and set(loops) != {"second_chance_match", "stitch_match"}:
        raise AssertionError(f"{what}: want both matchers' loops; {loops}")


def zero_counts(kernels) -> None:
    """Set every wrapper's launch count to 0."""
    for name in KERNEL_NAMES:
        getattr(kernels, name).launches = 0


def read_counts(kernels, path: str) -> dict:
    """Every wrapper's launch count by name; a launch of another wrapper
    than the driven path's raises."""
    counts = {name: getattr(kernels, name).launches for name in KERNEL_NAMES}
    if any(n for name, n in counts.items() if name != path):
        raise AssertionError(f"launches off the {path} path: {counts}")
    return counts


def dist_rank(world, fq, arc, threads):
    """Phase 9, one rank: the distributed compress on this rank's card,
    with the launch counts set to 0 just before and read just after.
    Returns (seconds, launch counts by wrapper, peak device memory, engine
    stats)."""
    import torch
    from spring_tpu_torch import api
    from spring_tpu_torch.ops import kernels
    from spring_tpu_torch.reorder import engine
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    torch.cuda.synchronize()
    t = time.time()
    api.compress([fq], arc, api.CompressOptions(
        num_threads=threads, verbose=False, dist=True), device="cuda")
    torch.cuda.synchronize()
    return (time.time() - t, read_counts(kernels, "masked_hamming_rows"),
            torch.cuda.max_memory_allocated(), dict(engine.LAST_RUN_STATS))


def dist_report(tag, n, secs, launches, peak, stats, fq, arc, out, single,
                card):
    """Check one distributed compress of phase 5's reads (its archive is
    at ``arc``; ``out`` takes the decompressed reads) against the single
    engine's numbers in ``single``, and print its numbers."""
    from spring_tpu_torch import api
    api.decompress(arc, [out], num_threads=THREADS, verbose=False)
    same_bytes(fq, out, f"{tag} round trip")
    size = os.path.getsize(arc)
    if abs(size - single["archive"]) > 0.05 * single["archive"] + 10240:
        raise AssertionError(
            f"{tag}: archive {size} bytes against the single "
            f"engine's {single['archive']}")
    if (launches != stats["rounds_run"]
            or stats["collectives_per_round"] != 7
            or stats["world_size"] != n):
        raise AssertionError(
            f"{tag}: {launches} launches of masked_hamming_rows, "
            f"engine {stats}")
    need_graphs(tag, stats)
    log(f"[{tag}] world size {n} over NCCL: compress {secs:.3f} s = "
        f"{N_READS / secs:.1f} reads/s; round trip byte-exact; "
        f"rounds {stats['rounds']} ({stats['rounds_run']} run); "
        f"{stats['ms_per_round']} ms a round; unmatched fraction "
        f"{stats.get('unmatched_frac')}; archive {size} bytes "
        f"(single engine {single['archive']}); peak device memory "
        f"{peak} bytes; collectives a round "
        f"{stats['collectives_per_round']} ({stats['collectives']} "
        f"in all, counted at each replay; host time inside them not "
        f"measured: graphs replay them with no host call); "
        f"masked_hamming_rows launches {launches}; engine "
        f"{stats['flush_wall_s']} s = "
        f"{stats['flush_wall_s'] / single['engine_s']:.3f} of the "
        f"single engine's {single['engine_s']} s; engine: "
        f"{engine_line(stats)}; on {card}")
    os.remove(arc)
    os.remove(out)


def dist_ranks_phase(fq, arc, out, single, card, total) -> None:
    """Phase 9: phase 5's compress on the distributed engine over 4 ranks
    (2 where two or three cards are visible), one spawned process and one
    card each, checked as phase 8 (dist_report) and with the emissions
    equal on every rank; each rank's launches are added to ``total``.
    With one card it prints that it was skipped."""
    import torch
    from spring_tpu_torch.parallel import multihost
    cards = torch.cuda.device_count()
    if cards < 2:
        log("[dist-n] skipped: one card is visible, and the ranks of a "
            "world take one card each")
        return
    n = 4 if cards >= 4 else 2
    res = multihost.launch(dist_rank, n, (fq, arc, THREADS),
                           device="cuda", timeout=900.0)
    digests = {r[3]["emissions_sha256"] for r in res}
    if len(digests) != 1:
        raise AssertionError(f"emissions differ between the {n} ranks")
    log(f"[dist-n] emissions equal on all {n} ranks (each a fresh "
        "process: its compress seconds include CUDA and NCCL start-up)")
    for rank, r in enumerate(res):
        if r[1]["masked_hamming_rows"] != r[3]["rounds_run"]:
            raise AssertionError(
                f"a rank launched masked_hamming_rows "
                f"{r[1]['masked_hamming_rows']} times in "
                f"{r[3]['rounds_run']} rounds")
        need_graphs(f"dist-n rank {rank}", r[3])
        for name, k in r[1].items():
            total[name] += k
    secs, counts, peak, stats = res[0]
    dist_report("dist-n", n, secs, counts["masked_hamming_rows"], peak,
                stats, fq, arc, out, single, card)


def multi_card_phase() -> int:
    """Phase 9 alone, for a machine with several cards: phase 5's reads,
    their compress on the single engine on the first card (what phase 9
    is held against), then phase 9. Prints the card line first and the
    device line last.

        python -c "import chip_smoke, sys; sys.exit(chip_smoke.multi_card_phase())"
    """
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if torch.cuda.device_count() < 2:
        raise SystemExit("chip_smoke: phase 9 needs two cards or more")
    from spring_tpu_torch import api
    from spring_tpu_torch.ops import kernels
    from spring_tpu_torch.reorder import engine
    from spring_tpu_torch.utils import synth
    card = card_line()
    log(card)
    total = dict.fromkeys(KERNEL_NAMES, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fq = os.path.join(tmp, "in.fastq")
        synth.make_se(fq, N_READS, read_len=100, genome_size=GENOME,
                      seed=SEED)
        arc = os.path.join(tmp, "in.stpu")
        out = os.path.join(tmp, "out.fastq")
        zero_counts(kernels)
        api.compress([fq], arc, api.CompressOptions(
            num_threads=THREADS, verbose=False), device="cuda")
        read_counts(kernels, "verify_rows")
        stats = dict(engine.LAST_RUN_STATS)
        single = dict(archive=os.path.getsize(arc),
                      engine_s=stats["flush_wall_s"])
        log(f"[main] single engine on one card: archive {single['archive']} "
            f"bytes; engine: {engine_line(stats)}")
        os.remove(arc)
        dist_ranks_phase(fq, arc, out, single, card, total)
    log(json.dumps({"phase_9_launches": total}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def need_compactions(what: str, stats: dict) -> None:
    if not stats.get("dict_compactions"):
        raise AssertionError(f"{what}: want at least one dictionary "
                             f"compaction; engine {stats}")


def tuning_phase(tmp, fq_small, fq, single, on_card, need_launches, card):
    """Phase 11: far_near, cap_per_round, flush_rounds and dictionary
    compaction through CompressOptions.engine. fq_small is phase 4's set,
    fq phase 5's reads; single holds phase 5's and 8's numbers; on_card
    and need_launches are main()'s."""
    import torch
    from spring_tpu_torch import api
    from spring_tpu_torch.parallel import multihost

    def tuned(rebuild, **fields):
        return api.CompressOptions(
            num_threads=THREADS, verbose=False,
            engine=dict(TUNED, rebuild_fraction=rebuild), **fields)

    # ---- 11a: the small set, card against CPU
    a_gpu = os.path.join(tmp, "tuned.gpu.stpu")
    a_cpu = os.path.join(tmp, "tuned.cpu.stpu")
    secs, launches, stats = on_card([fq_small], a_gpu, tuned(0.05))
    from spring_tpu_torch.reorder import engine
    api.compress([fq_small], a_cpu, tuned(0.05), device="cpu")
    cpu = dict(engine.LAST_RUN_STATS)
    same_bytes(a_gpu, a_cpu, "11a: tuned 16k-read archive, card against CPU")
    need_compactions("11a on the card", stats)
    need_compactions("11a on the CPU", cpu)
    need_launches("11a", launches, stats)
    log(f"[tuned] 11a {N_SMALL} reads, {json.dumps(TUNED)}, "
        f"rebuild_fraction 0.05: card and CPU archives byte-equal "
        f"({os.path.getsize(a_gpu)} bytes); card compress {secs:.3f} s; "
        f"verify_rows launches {launches}; CPU {cpu['dict_compactions']} "
        f"dictionary compactions; card engine: {engine_line(stats)}")

    # ---- 11b: phase 5's reads on the single engine
    arc = os.path.join(tmp, "tuned.stpu")
    out = os.path.join(tmp, "tuned.fastq")
    secs, launches, stats = on_card([fq], arc, tuned(0.22))
    api.decompress(arc, [out], num_threads=THREADS, verbose=False)
    same_bytes(fq, out, "11b: tuned 1M-read round trip")
    need_compactions("11b", stats)
    need_launches("11b", launches, stats)
    if stats["program_cache"] != "miss" or stats["eager_rounds"] != 1:
        raise AssertionError("11b: want a program-cache miss (a new key) "
                             f"with one round called; engine {stats}")
    log(f"[tuned] 11b {N_READS} reads, {json.dumps(TUNED)}, "
        f"rebuild_fraction 0.22: compress {secs:.3f} s = "
        f"{N_READS / secs:.1f} reads/s; round trip byte-exact; archive "
        f"{os.path.getsize(arc)} bytes (phase 5: {single['archive']}); "
        f"unmatched fraction {stats['unmatched_frac']} (phase 5: "
        f"{single['unmatched']}); rounds {stats['rounds']} (phase 5: "
        f"{single['rounds']}); engine {stats['flush_wall_s']} s (phase 5: "
        f"{single['engine_s']}); {stats['dict_compactions']} dictionary "
        f"compactions, {stats['dict_compact_s']} s; verify_rows launches "
        f"{launches}; on {card}")
    log(f"[tuned] 11b engine {json.dumps(stats)}")
    log(f"[tuned] 11b engine: {engine_line(stats)}")
    os.remove(arc)
    os.remove(out)

    # ---- 11c: the distributed engine, world size 1 over NCCL
    world = multihost.initialize(0, 1, os.path.join(tmp, "store11"),
                                 device="cuda", timeout=600.0)
    try:
        opts = api.CompressOptions(
            num_threads=THREADS, verbose=False, dist=True,
            engine=dict(rebuild_fraction=0.22, flush_rounds=16))
        secs, launches, stats = on_card([fq], arc, opts)
    finally:
        multihost.shutdown()
    api.decompress(arc, [out], num_threads=THREADS, verbose=False)
    same_bytes(fq, out, "11c: distributed round trip")
    need_compactions("11c", stats)
    need_graphs("11c", stats)
    if (launches != stats["rounds_run"]
            or stats["collectives_per_round"] != 7
            or stats["rounds_run"] != 16 * stats["flushes"]):
        raise AssertionError(f"11c: {launches} launches of "
                             f"masked_hamming_rows, engine {stats}")
    log(f"[tuned] 11c world size 1 over NCCL, flush_rounds 16, "
        f"rebuild_fraction 0.22: compress {secs:.3f} s; round trip "
        f"byte-exact; archive {os.path.getsize(arc)} bytes (phase 8: "
        f"{single['dist_archive']}); unmatched fraction "
        f"{stats.get('unmatched_frac')}; collectives a round "
        f"{stats['collectives_per_round']}; {stats['dict_compactions']} "
        f"dictionary compactions, {stats['dict_compact_s']} s; "
        f"masked_hamming_rows launches {launches}; engine: "
        f"{engine_line(stats)}; on {card}")
    os.remove(arc)
    os.remove(out)


def last_phase(tmp, fq_small, fq, fq_large, a_large, single, on_card,
               need_launches, card, total):
    """Phase 12: force_wide at 16,384 reads card against CPU and at 1M
    reads, entry()'s round card against CPU, dryrun_multichip over the
    visible cards, and phase 10's reads without the row stager. fq_small,
    fq and fq_large are phases 4, 5 and 10's inputs, a_large phase 10's
    archive; single holds phase 5's numbers; on_card and need_launches
    are main()'s, total its launch counts."""
    import torch
    from spring_tpu_torch import api, entry
    from spring_tpu_torch.ops import graphs, kernels
    from spring_tpu_torch.pipeline import short_mode
    from spring_tpu_torch.reorder import dictionary as dct
    from spring_tpu_torch.reorder import engine

    wide = api.CompressOptions(num_threads=THREADS, verbose=False,
                               engine=dict(force_wide=True))

    def need_wide(what, stats):
        if stats["dict_row_words"] != dct.WIDE_WORDS:
            raise AssertionError(f"{what}: dictionary rows of "
                                 f"{stats['dict_row_words']} words, want "
                                 f"the wide {dct.WIDE_WORDS}")

    # ---- 12a: the small set, card against CPU
    a_gpu = os.path.join(tmp, "wide.gpu.stpu")
    a_cpu = os.path.join(tmp, "wide.cpu.stpu")
    secs, launches, stats = on_card([fq_small], a_gpu, wide)
    api.compress([fq_small], a_cpu, wide, device="cpu")
    same_bytes(a_gpu, a_cpu, "12a: force_wide 16k-read archive, card "
               "against CPU")
    need_wide("12a on the card", stats)
    need_wide("12a on the CPU", engine.LAST_RUN_STATS)
    need_launches("12a", launches, stats)
    log(f"[wide] 12a {N_SMALL} reads, force_wide: card and CPU archives "
        f"byte-equal ({os.path.getsize(a_gpu)} bytes); card compress "
        f"{secs:.3f} s; verify_rows launches {launches}; engine: "
        f"{engine_line(stats)}")
    for f in (a_gpu, a_cpu):
        os.remove(f)

    # ---- 12b: phase 5's reads with wide rows
    arc = os.path.join(tmp, "wide.stpu")
    out = os.path.join(tmp, "wide.fastq")
    torch.cuda.reset_peak_memory_stats()
    secs, launches, stats = on_card([fq], arc, wide)
    peak = torch.cuda.max_memory_allocated()
    api.decompress(arc, [out], num_threads=THREADS, verbose=False)
    same_bytes(fq, out, "12b: force_wide 1M-read round trip")
    need_wide("12b", stats)
    need_launches("12b", launches, stats)
    if stats["program_cache"] != "miss" or stats["eager_rounds"] != 1:
        raise AssertionError("12b: want a program-cache miss (the row "
                             "format is a key) with one round called; "
                             f"engine {stats}")
    log(f"[wide] 12b {N_READS} reads, force_wide: compress {secs:.3f} s = "
        f"{N_READS / secs:.1f} reads/s; round trip byte-exact; archive "
        f"{os.path.getsize(arc)} bytes (phase 5: {single['archive']}); "
        f"rounds {stats['rounds']} ({stats['rounds_run']} run; phase 5: "
        f"{single['rounds']}); unmatched fraction "
        f"{stats['unmatched_frac']} (phase 5: {single['unmatched']}); "
        f"engine {stats['flush_wall_s']} s (phase 5: {single['engine_s']}); "
        f"peak device memory {peak} bytes; verify_rows launches "
        f"{launches}; on {card}")
    log(f"[wide] 12b stages_s {json.dumps(short_mode.LAST_STAGE_SECONDS)}")
    log(f"[wide] 12b matcher loops {json.dumps(graphs.LOOP_STATS)}")
    log(f"[wide] 12b engine: {engine_line(stats)}")
    for f in (arc, out):
        os.remove(f)

    # ---- 12c: entry()'s round, card against CPU
    zero_counts(kernels)
    fn, args = entry.entry("cuda")
    torch.cuda.synchronize()
    t = time.time()
    new, emit = fn(*args)
    torch.cuda.synchronize()
    secs = time.time() - t
    counts = read_counts(kernels, "verify_rows")
    fn_c, args_c = entry.entry("cpu")
    new_c, emit_c = fn_c(*args_c)
    if not torch.equal(emit.cpu(), emit_c):
        raise AssertionError("12c: entry()'s round emits other rows on "
                             "the card than on the CPU")
    for k, v in new_c.items():
        if not torch.equal(new[k].cpu(), v):
            raise AssertionError(f"12c: entry()'s round state {k} differs "
                                 "between card and CPU")
    if counts["verify_rows"] != 1:
        raise AssertionError(f"12c: one round, {counts} launches")
    total["verify_rows"] += 1
    log(f"[entry] 12c entry()'s round ({entry.N_READS} reads of "
        f"{entry.READ_LEN} bases): state and emissions equal card and CPU "
        f"({int((emit[:, :, 0] >= 0).sum())} rows emitted); one verify_rows "
        f"launch; {1000 * secs:.3f} ms on the host clock (a first call); "
        f"on {card}")

    # ---- 12d: dryrun_multichip on the visible cards
    cards = torch.cuda.device_count()
    n = 4 if cards >= 4 else 2 if cards >= 2 else 1
    t = time.time()
    em, ranks = entry.dryrun_multichip(n, "cuda", timeout=600.0)
    for r in ranks:
        if r["launches"] != r["rounds_run"]:
            raise AssertionError(f"12d: a rank launched masked_hamming_rows "
                                 f"{r['launches']} times in "
                                 f"{r['rounds_run']} rounds")
        total["masked_hamming_rows"] += r["launches"]
    log(f"[entry] 12d dryrun_multichip({n}) over NCCL: every read placed "
        f"once ({len(em)} emissions), every rank's emissions equal; "
        f"launches a rank {[r['launches'] for r in ranks]} in "
        f"{[r['rounds_run'] for r in ranks]} rounds run; "
        f"{time.time() - t:.1f} s with the ranks' start-up; on {card}")

    # ---- 12e: phase 10's reads without the row stager
    arc = os.path.join(tmp, "nostager.stpu")
    opts = api.CompressOptions(num_threads=THREADS, verbose=False,
                               stager=False)
    secs, launches, stats = on_card([fq_large], arc, opts)
    need_launches("12e", launches, stats)
    if stats["staged_rows"] or stats.get("dict_prewarm_s") is None:
        raise AssertionError(f"12e: want no staged rows and the prewarm; "
                             f"engine {stats}")
    same_bytes(a_large, arc, "12e: the 2M-read archive without the stager "
               "against phase 10's")
    log(f"[stager] 12e {N_LARGE} reads, stager off: archive byte-equal to "
        f"phase 10's ({os.path.getsize(arc)} bytes); compress {secs:.3f} s; "
        f"prewarm {stats['dict_prewarm_s']} s; verify_rows launches "
        f"{launches}; engine: {engine_line(stats)}; on {card}")
    os.remove(arc)


def segments_phase(card) -> dict:
    """Phase 13: the multi-segment consensus match on the card against the
    port's CPU path. A consensus of 2^25 + 2^20 bases (past the single
    dictionary's 2^25: one dictionary a 2^24-base segment, three here,
    their matches min-folded, as at 100M reads) with a 4,000-base stretch
    of segment 0 repeated in segment 2; 20,000 reads of it, both
    orientations, a third with 1-3 substitutions, 1 in 20 with an N run,
    200 across the segment boundaries and 200 in the repeat. Second
    chance's call (no exclude) and stitching's (a third of the reads
    vetoed at their own start), each in chunks of 2^14 oriented rows so
    that every segment's loop replays its graph: (gpos, rc, placed)
    exactly equal, three segments, and each loop replayed."""
    import numpy as np
    import torch
    from spring_tpu_torch.encode import second_chance as sc
    from spring_tpu_torch.io import packing
    from spring_tpu_torch.ops import graphs

    total, n, L = sc.SINGLE_MAX + (1 << 20), 20_000, 100
    rng = np.random.default_rng(SEED + 13)
    seq = rng.integers(0, 4, total).astype(np.uint8)
    rep0, rep2 = 1_000_000, 2 * sc.SEG_BASES + 500_000
    seq[rep2:rep2 + 4000] = seq[rep0:rep0 + 4000]
    pos = rng.integers(0, total - L, n)
    edges = np.array([sc.SEG_BASES, 2 * sc.SEG_BASES])
    pos[:200] = np.repeat(edges, 100) - rng.integers(1, L, 200)
    pos[200:400] = rep0 + rng.integers(0, 4000 - L, 200)
    codes = seq[pos[:, None] + np.arange(L)[None, :]].copy()
    lens = np.full(n, L, np.int32)
    sub = np.arange(1, n, 3)
    for _ in range(3):
        pick = sub[rng.random(len(sub)) < 0.6]
        col = rng.integers(0, L, len(pick))
        codes[pick, col] = (codes[pick, col]
                            + rng.integers(1, 4, len(pick))) % 4
    nrow = np.arange(7, n, 20)
    start = rng.integers(0, L - 8, len(nrow))
    for j in range(6):
        codes[nrow, start + j] = packing.N
    rc = rng.random(n) < 0.5
    codes[rc] = packing.revcomp_codes(codes[rc], lens[rc])
    pk = packing.pack_codes(codes)
    ind = (codes == packing.N).astype(np.uint8)
    nm_f = packing.pack_codes(ind)
    nm_r = packing.pack_codes(ind[:, ::-1].copy())   # all reads length L
    ex = np.where(np.arange(n) % 3 == 0, pos, -1).astype(np.int32)
    out = {}
    default_chunk = sc.MATCH_CHUNK
    sc.MATCH_CHUNK = 1 << 14
    try:
        for name, kw in (("second_chance_match", {}),
                         ("stitch_match", dict(exclude=ex))):
            graphs.LOOP_STATS.clear()
            torch.cuda.synchronize()
            t = time.time()
            got = sc.align_leftovers_packed(seq, pk, nm_f, nm_r, lens,
                                            device="cuda", **kw)
            torch.cuda.synchronize()
            card_s = time.time() - t
            loops = json.loads(json.dumps(graphs.LOOP_STATS))
            segs = sc.SEGMENTS[name]
            t = time.time()
            want = sc.align_leftovers_packed(seq, pk, nm_f, nm_r, lens,
                                             device="cpu", **kw)
            cpu_s = time.time() - t
            for g, w, what in zip(got, want, ("gpos", "rc", "placed")):
                if g.dtype != w.dtype or not np.array_equal(g, w):
                    raise AssertionError(f"phase 13 {name}: {what} on the "
                                         "card differs from the CPU path")
            st = loops[name]
            need_loops(f"phase 13 {name}", loops, replayed=False)
            if segs != 3 or st["loops"] != 3 or not st["replays"]:
                raise AssertionError(f"phase 13 {name}: want 3 segments, "
                                     f"one replayed loop each; segments "
                                     f"{segs}, loops {loops}")
            placed = int(want[2].sum())
            log(f"[segments] {name}: consensus {total} bases in {segs} "
                f"dictionaries, {n} reads: card equal to the CPU path "
                f"(placed {placed}); card {card_s:.3f} s, CPU {cpu_s:.3f} "
                f"s; loops {json.dumps(st)}; on {card}")
            out[name] = dict(segments=segs, reads=n, placed=placed,
                             card_s=card_s, cpu_s=cpu_s, loops=st)
    finally:
        sc.MATCH_CHUNK = default_chunk
    return out


def sweep_phase(card) -> None:
    """Phase 14: the engine-sweep tools (tools/knob_sweep_torch.py,
    tools/sweep_probe_torch.py) on phase 4's 16,384 reads. The knob
    tool's flushes of baseline and shift_chunk=8 on the card (the first
    captured, the others replayed) against the same on the CPU: each
    flush's stats and the claimed reads equal. Then the sweep tool on the
    card, configs base= and fn4=far_near:4, two passes each, with its
    default check (a fresh process's default compress): exit 0, every
    round trip byte-exact, and each archive byte-equal to the CPU path's
    compress with the same CompressOptions.engine."""
    import hashlib
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import knob_sweep_torch as knob
    import sweep_probe_torch as sweep
    from spring_tpu_torch import api
    from spring_tpu_torch.io import fastq_native
    from spring_tpu_torch.utils import synth

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp:
        fq = os.path.join(tmp, "small.fastq")
        synth.make_se(fq, N_SMALL, read_len=100, genome_size=40_000, seed=7,
                      n_rate=0.0005)
        arrs = fastq_native.load_file(fq, want_quals=False)
        packed = fastq_native.pack_2bit(arrs.codes, THREADS)
        for spec in ("baseline", "shift_chunk=8"):
            kw = knob.parse_variant(spec)
            got = knob.flush_variant(packed, arrs.lengths, arrs.maxlen, kw,
                                     "cuda")
            want = knob.flush_variant(packed, arrs.lengths, arrs.maxlen, kw,
                                      "cpu")
            if (got["stats"], got["claimed"]) != (want["stats"],
                                                  want["claimed"]):
                raise AssertionError(
                    f"phase 14 knob {spec}: card stats {got['stats']} "
                    f"claimed {got['claimed']}, CPU {want['stats']} "
                    f"claimed {want['claimed']}")
            if got["capture_s"] is None:
                raise AssertionError(f"phase 14 knob {spec}: the card's "
                                     "flush captured nothing")
            log(f"[sweep] knob {spec}: B {got['B']} SC {got['SC']} M "
                f"{got['M']} C {got['C']}: card equal to the CPU path "
                f"(stats {got['stats']}, claimed {got['claimed']}); "
                f"{got['ms_a_round']} ms a replayed round, capture "
                f"{got['capture_s']} s; on {card}")
        out = os.path.join(tmp, "sweep.jsonl")
        configs = ("base=", "fn4=far_near:4")
        rc = sweep.main([fq, *configs, "--device", "cuda", "--passes", "2",
                         "--threads", str(THREADS), "--check-default",
                         "--work", os.path.join(tmp, "w"), "--out", out])
        with open(out) as f:
            lines = [json.loads(x) for x in f]
        recs, summary = lines[1:-1], lines[-1]
        if rc or not summary["ok"] or len(recs) != len(configs):
            raise AssertionError(f"phase 14 sweep: exit {rc}, failures "
                                 f"{summary['failures']}")
        for r in recs:
            ref = os.path.join(tmp, "cpu.stpu")
            api.compress([fq], ref, api.CompressOptions(
                num_threads=THREADS, verbose=False, engine=r["engine"]),
                device="cpu")
            with open(ref, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != r[
                        "archive_sha256"]:
                    raise AssertionError(
                        f"phase 14 sweep {r['config']}: the card's archive "
                        "differs from the CPU path's")
            os.remove(ref)
            log(f"[sweep] probe {r['config']} {r['engine']}: archive "
                f"{r['archive_bytes']} bytes byte-equal to the CPU path's, "
                f"round trip {r['round_trip']}; best {r['best_s']} s, "
                f"passes {[p['program_cache'] for p in r['passes']]}; "
                f"rounds {r['run']['rounds']}, "
                f"{r['run']['ms_per_graphed_round']} ms a replayed round; "
                f"on {card}")
        log(f"[sweep] default check {json.dumps(summary['default_check'])}")


def kernel_phases():
    """Phases 1-3: the card, the builds, every kernel entry against its
    plain version. Returns (card line, device name, kernel entries)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); it runs only on a GPU")
    from spring_tpu_torch import params
    from spring_tpu_torch.codecs import native
    from spring_tpu_torch.ops import _build, kernels

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
        log(f"[build] kernel library (masked_hamming.cu) built+loaded in "
            f"{f_kernel.result():.3f} s")
        log(f"[build] native host library built+loaded in "
            f"{f_host.result():.3f} s")
    log(f"[build] both, side by side, in {time.time() - t:.3f} s")

    kres, max_err = check_kernel(torch, kernels, params.THRESH_REORDER)
    for name, r in kres.items():
        log(f"[kernel] {name} ({r['shape']}): equal to its plain version; "
            f"device {r['ms']:.5f} ms a launch (CUDA events around the "
            f"replay of a graph of 200 launches), wrapper enqueue "
            f"{r['enqueue_ms']:.5f} ms, plain {r['plain_ms']:.5f} ms "
            f"(median CUDA events over Python calls); bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']} "
            f"bytes at {HBM_BYTES_PER_S:.3g} B/s, {r['ops']} operations "
            f"at {ALU_OPS_PER_S:.3g}/s) on {card}")
    for name, key in (("verify_rows", "at_10M_reads"),
                      ("verify_rows", "at_100M_reads"),
                      ("masked_hamming_rows", "at_10M_dist_round"),
                      ("masked_hamming_rows", "at_100M_dist_round_4_ranks")):
        r = kres[name][key]
        accepted = (f"; accepted {r['accepted']} of {8192 * 16} slots"
                    if "accepted" in r else "")
        log(f"[kernel] {name} {key} ({r['shape']}): equal to its "
            f"plain version; device {r['ms']:.5f} ms a launch, wrapper "
            f"enqueue {r['enqueue_ms']:.5f} ms, plain {r['plain_ms']:.5f} "
            f"ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes, {r['ops']} operations){accepted}; on "
            f"{card}")
    log(f"[kernel] an empty kernel timed the same way: "
        f"{kernels.launch_floor_device_ms():.5f} ms a launch on {card}")
    log(f"[kernel] verify_rows accepted "
        f"{kres['verify_rows']['accepted']} of 65536 slots")
    for r in kres.values():
        r["max_abs_err"] = max_err
    return card, kind, kres


def main() -> int:
    card, kind, kres = kernel_phases()
    import torch
    from spring_tpu_torch import api, params
    from spring_tpu_torch.encode import second_chance
    from spring_tpu_torch.io.container import ArchiveReader
    from spring_tpu_torch.ops import graphs, kernels
    from spring_tpu_torch.parallel import multihost
    from spring_tpu_torch.pipeline import short_mode
    from spring_tpu_torch.reorder import engine
    from spring_tpu_torch.utils import synth

    # launches on the main paths, phases 5-10: the fused verify (the
    # single-device round), masked_hamming_rows (the distributed round),
    # and the word-major masked_hamming (on no path)
    total = dict.fromkeys(KERNEL_NAMES, 0)

    def on_card(files, arc, opts):
        """api.compress on the card with the launch counts set to 0 just
        before and read just after: (seconds, launches of the path's
        kernel, engine stats). The path's kernel is masked_hamming_rows
        with opts.dist, else verify_rows."""
        zero_counts(kernels)
        engine.LAST_RUN_STATS.clear()
        torch.cuda.synchronize()
        t = time.time()
        api.compress(files, arc, opts, device="cuda")
        torch.cuda.synchronize()
        secs = time.time() - t
        path = "masked_hamming_rows" if opts.dist else "verify_rows"
        counts = read_counts(kernels, path)
        for name, n in counts.items():
            total[name] += n
        return secs, counts[path], dict(engine.LAST_RUN_STATS)

    def need_launches(what, n, stats, engines=1):
        """One launch a round run; a compress of several engines (super-
        shards) more than the last one's rounds run."""
        rr = stats["rounds_run"]
        if not (n == rr if engines == 1 else n > rr):
            raise AssertionError(f"{what} launched the kernel {n} times "
                                 f"in {stats['rounds_run']} rounds run")
        need_graphs(what, stats)

    def loops_line() -> str:
        return (f"{json.dumps(graphs.LOOP_STATS)} (matcher: loops, "
                f"iterations, captures, replays, capture seconds, largest "
                f"pool bytes)")

    opts = api.CompressOptions(num_threads=THREADS, verbose=False)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- phase 4: a small set, card against CPU path
        fq2 = os.path.join(tmp, "small.fastq")
        synth.make_se(fq2, N_SMALL, read_len=100, genome_size=40_000, seed=7,
                      n_rate=0.0005)
        a_gpu = os.path.join(tmp, "gpu.stpu")
        a_cpu = os.path.join(tmp, "cpu.stpu")
        engine.LAST_RUN_STATS.clear()
        # chunks of 64 oriented rows: the matchers' loops replay their
        # graphs here, where one chunk of the default size holds them all
        default_chunk = second_chance.MATCH_CHUNK
        second_chance.MATCH_CHUNK = 64
        try:
            t = time.time()
            api.compress([fq2], a_gpu, opts, device="cuda")
            torch.cuda.synchronize()
            small_s = time.time() - t
            stats = dict(engine.LAST_RUN_STATS)
            loops = json.loads(json.dumps(graphs.LOOP_STATS))
            api.compress([fq2], a_cpu, opts, device="cpu")
        finally:
            second_chance.MATCH_CHUNK = default_chunk
        same_bytes(a_gpu, a_cpu, "16k-read archive, card against CPU path")
        need_graphs("phase 4", stats, replays=2, compactions=1)
        need_loops("phase 4", loops, replayed=True)
        log(f"[check] {N_SMALL}-read archive: card and CPU path byte-equal "
            f"(card compress {small_s:.3f} s); card engine: "
            f"{engine_line(stats)}; matchers in chunks of 64 rows: "
            f"{json.dumps(loops)}")

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
        reserved = torch.cuda.max_memory_reserved()
        stages = dict(short_mode.LAST_STAGE_SECONDS)
        t = time.time()
        api.decompress(arc, [out], num_threads=THREADS, verbose=False)
        dec_s = time.time() - t
        same_bytes(fq, out, "1M-read round trip")
        log(f"[main] compress {comp_s:.3f} s = {N_READS / comp_s:.1f} "
            f"reads/s; decompress {dec_s:.3f} s; round trip byte-exact; "
            f"archive {os.path.getsize(arc)} bytes; peak device memory "
            f"{peak} bytes allocated, {reserved} reserved (the cached "
            f"programs' graph pools are reserved)")
        log(f"[main] stages_s {json.dumps(stages)}")
        log(f"[main] device peak at each stage's end "
            f"{json.dumps(short_mode.LAST_STAGE_PEAK_BYTES)}")
        log(f"[main] engine {json.dumps(stats)}")
        log(f"[main] engine: {engine_line(stats)}; verify_rows launches "
            f"{launches} on {card}")
        log(f"[main] matcher loops {loops_line()}")
        need_launches("the main path", launches, stats)
        need_loops("the main path", graphs.LOOP_STATS)
        if stats["program_cache"] != "miss" or stats["eager_rounds"] != 1:
            raise AssertionError("the main path: want a program-cache miss "
                                 "(phase 4's shape differs) with one round "
                                 f"called; engine {stats}")
        single = dict(archive=os.path.getsize(arc),
                      engine_s=stats["flush_wall_s"],
                      unmatched=stats["unmatched_frac"],
                      rounds=stats["rounds"], stages=stages)
        for f in (arc, out):        # phase 8 compresses fq again
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
        log(f"[pe-r] engine: {engine_line(stats)}")
        need_launches("the PE -r path", launches, stats)
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
                need_launches(f"the {name} path", launches, stats,
                              engines=N_SMALL // cap if cap else 1)
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
                f"{secs:.3f} s; launches {launches}"
                + (f"; engine: {engine_line(stats)}" if stats else ""))
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

        # ---- phases 8 and 9: the distributed engine over NCCL
        world = multihost.initialize(0, 1, os.path.join(tmp, "store"),
                                     device="cuda", timeout=600.0)
        try:
            g = torch.Generator(device=world.device).manual_seed(SEED + 8)
            for shape in ((4096 * 64,), (4096 * 18, 8)):
                x = torch.randint(-2**31, 2**31, shape, generator=g,
                                  device=world.device,
                                  dtype=torch.int64).to(torch.int32)
                for fn in (multihost.all_to_all, multihost.all_gather):
                    got = fn(world, x)
                    torch.cuda.synchronize()
                    if got is x or not torch.equal(got, x):
                        raise AssertionError(
                            f"{fn.__name__} at world size 1 is not an "
                            "identity made by the group")
            if world.collectives != 4:
                raise AssertionError("the collectives did not reach NCCL")
            log(f"[dist] all_to_all and all_gather over NCCL at world size "
                f"1: equal to their input at {4096 * 64} words and "
                f"{4096 * 18} rows of 8 words")
            torch.cuda.reset_peak_memory_stats()
            comp_s, launches, stats = on_card(
                [fq], arc, api.CompressOptions(
                    num_threads=THREADS, verbose=False, dist=True))
            single["dist_archive"] = os.path.getsize(arc)
            dist_report("dist", 1, comp_s, launches,
                        torch.cuda.max_memory_allocated(), stats, fq, arc,
                        out, single, card)
        finally:
            multihost.shutdown()
        dist_ranks_phase(fq, arc, out, single, card, total)

        # ---- phase 10: 2M reads, compressed twice in this process: the
        # first call stages its rows and prewarms the dictionary build,
        # the second finds its flush program in the cache
        fq_large = os.path.join(tmp, "large.fastq")
        t = time.time()
        synth.make_se(fq_large, N_LARGE, read_len=100,
                      genome_size=GENOME_LARGE, seed=SEED)
        log(f"[data] {N_LARGE} SE reads x 100 bp, genome {GENOME_LARGE}, "
            f"seed {SEED}: {os.path.getsize(fq_large)} bytes in "
            f"{time.time() - t:.1f} s")
        calls = []
        for k in (1, 2):
            arc = os.path.join(tmp, f"large{k}.stpu")
            torch.cuda.reset_peak_memory_stats()
            secs, launches, stats = on_card([fq_large], arc, opts)
            peak = torch.cuda.max_memory_allocated()
            reserved = torch.cuda.max_memory_reserved()
            need_launches(f"large call {k}", launches, stats)
            log(f"[large] call {k}: device peak at each stage's end "
                f"{json.dumps(short_mode.LAST_STAGE_PEAK_BYTES)}")
            log(f"[large] call {k}: stages_s "
                f"{json.dumps(short_mode.LAST_STAGE_SECONDS)}")
            log(f"[large] call {k}: matcher loops {loops_line()}")
            need_loops(f"large call {k}", graphs.LOOP_STATS)
            calls.append((arc, secs, stats))
            log(f"[large] call {k}: compress {secs:.3f} s = "
                f"{N_LARGE / secs:.1f} reads/s; rows staged "
                f"{stats['staged_rows']}; dictionary prewarm "
                f"{stats.get('dict_prewarm_s')} s; engine "
                f"{stats['flush_wall_s']} s; cached program "
                f"{stats['cached_program_bytes']} bytes; peak device memory "
                f"{peak} bytes allocated, {reserved} reserved; unmatched "
                f"fraction "
                f"{stats['unmatched_frac']}; verify_rows launches {launches}; "
                f"engine: {engine_line(stats)}; on {card}")
        (a1, _, s1), (a2, _, s2) = calls
        if not (s1["staged_rows"] and s1.get("dict_prewarm_s") is not None
                and s1["program_cache"] == "miss"):
            raise AssertionError(f"large call 1: want the staged rows, the "
                                 f"prewarm and a cache miss; engine {s1}")
        if (s2["program_cache"] != "hit" or s2["eager_rounds"]
                or s2["capture_s"] is not None):
            raise AssertionError(f"large call 2: want a cache hit, no round "
                                 f"called and no capture; engine {s2}")
        same_bytes(a1, a2, "the two 2M-read archives")
        api.decompress(a2, [out], num_threads=THREADS, verbose=False)
        same_bytes(fq_large, out, "2M-read round trip")
        log(f"[large] the two archives byte-equal ({os.path.getsize(a2)} "
            f"bytes); round trip byte-exact")
        for f in (a1, out):
            os.remove(f)

        # ---- phase 11: the engine's tuning paths
        tuning_phase(tmp, fq2, fq, single, on_card, need_launches, card)

        # ---- phase 12: wide rows, the entry, the stager switch
        last_phase(tmp, fq2, fq, fq_large, a2, single, on_card,
                   need_launches, card, total)
        for f in (fq, fq_large, a2):
            os.remove(f)

    # ---- phase 13: the multi-segment consensus match
    segments = segments_phase(card)

    # ---- phase 14: the engine-sweep tools (their launches are not the
    # main path's and stay out of the kernels line)
    sweep_phase(card)

    def entry(name, launches):
        r = kres[name]
        out = {
            "name": name, "route": "cuda",
            "source": "spring_tpu_torch/csrc/masked_hamming.cu",
            "replaces": "spring_tpu/ops/pallas_kernels.py:59",
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "enqueue_ms": r["enqueue_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None}
        for key in ("at_10M_reads", "at_100M_reads", "at_10M_dist_round",
                    "at_100M_dist_round_4_ranks"):
            if key in r:
                out[key] = {k: r[key][k] for k in (
                    "shape", "ms", "enqueue_ms", "plain_ms", "bound_ms",
                    "bound_by")}
        return out

    # the fused entry carries the single-device round (phases 5-7, 10, 11a
    # and 11b) and masked_hamming_rows the distributed round (phases 8-9,
    # 11c); the
    # word-major entry (the Pallas kernel's own signature) is checked and
    # timed in phase 3 and launched by no phase after it
    if not (total["verify_rows"] and total["masked_hamming_rows"]):
        raise AssertionError(f"a kernel of the main paths never ran: "
                             f"{total}")
    log(json.dumps({"kernels": [entry(name, n)
                                for name, n in total.items()],
                    "multi_segment_match": segments}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
