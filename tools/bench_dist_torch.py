#!/usr/bin/env python3
"""Benchmark of the port's distributed reorder engine beside its default one.

    python tools/bench_dist_torch.py chip [FASTQ] [--reads N] [--seed S]
        [--cache DIR] [--work DIR] [--device cuda|cpu] [--threads T]
        [--passes P] [--out FILE]
    python tools/bench_dist_torch.py ranks N [FASTQ] [same options]

The PyTorch port's counterpart of tools/bench_dist.py. Without FASTQ the
input is bench.py's profile at --reads reads (default 1,000,000): 100 bp
reads at ~50x coverage of a genome of max(2,000,000, reads * 100 / 50)
bases, --seed 42 (spring_tpu_torch/utils/synth.py; --seed 5 gives
tools/rss_check_torch.py's input, the one behind SCALE_100M.json), made
once into --cache (default bench_dist_torch_data under the temporary
directory) by synth.make_se_fast and kept there for later runs. Archives
and decompressed files go to --work (default: a new temporary directory,
removed at the end). ``df`` and ``free -g`` are printed first.

``chip``: spring_tpu_torch.api.compress on one device, the default engine
first, then the distributed engine (CompressOptions(dist=True)) at world
size 1 over a process group formed with multihost.initialize (NCCL on
the card, gloo with --device cpu), so that its collectives are real
calls. Each engine compresses the input --passes times (default 3) in
this process: the first pass builds the flush program of the shape (a
program-cache miss), the best of the others is the engine's ``best_s``
(the first pass's time when it is the only one). The last archive of
each engine is decompressed and compared with the input. Reported a
engine: best_s, every pass (seconds, program cache, rounds called,
capture seconds, launches of the engine's kernel, the allocated and
reserved device peaks over the pass and at each stage's end,
short_mode.LAST_STAGE_PEAK_BYTES and _RESERVED_BYTES, the host RSS
sampled each second by stage), the best pass's stage seconds, archive
bytes, round trip, and from engine.LAST_RUN_STATS rounds, rounds run,
unmatched fraction, Np, walkers B (and Bl a rank) and keys dropped; the
distributed engine adds its collectives a round, the host seconds inside
the calls made eagerly (World.collective_s) and its exchange capacities
(parallel/dist.py::_dist_programs: capk, capq, capc, capr, R, S). Then
``dist_over_default``, the ratio of the two best_s.

``ranks N``: the distributed compress on N ranks, one spawned process
and one card each (multihost.launch; RANK_TIMEOUT seconds for the
group's collectives and the wait), --passes passes a rank as above,
--threads a rank defaulting to the host's cores over N. Reported a rank:
seconds and device peaks a pass, the engine's numbers, the host RSS by
stage, the host's peak RSS (VmHWM where /proc has it, and ru_maxrss);
and whether the emissions of every pass are equal on every rank, the
round trip of rank 0's archive, and ``best_s``, the slowest rank's best
pass. Each rank rewrites its sampled host peaks beside --out
(FILE.rank<r>.progress) each second, so that a killed run leaves them.
It refuses more ranks than cards and never moves to the CPU; --device
cpu runs the ranks on gloo.

The round trip compares input and output byte for byte where the work
directory has room for the output beside the input, else by SHA-256 sums
of 1 GiB chunks (tools/rss_check_torch.py's chunk_sums): the input is
hashed before the decompress writes the output, and a made input is
deleted from the cache first where the two share a file system without
room for both.

Every check fails the run with a non-zero exit: a round trip that is not
byte-exact, a launch count other than one a round run on the card, a
flush schedule other than one round called and captured on a miss and
none on a hit (on the card), a pass after the first that misses the
program cache, emissions that differ between ranks, a distributed
archive more than 5% + 10,240 bytes from the default engine's. The last
line of standard output is one JSON object (also appended to --out FILE)
with the card's name and power limit as nvidia-smi gives them; progress
goes to stderr. Imports neither JAX nor the JAX package.
"""
import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from rss_check_torch import CHUNK, chunk_sums, show  # noqa: E402

READ_LEN = 100
GENOME = 2_000_000
SEED = 42
PASSES = 3
RANK_TIMEOUT = 1200.0
KERNEL = {False: "verify_rows", True: "masked_hamming_rows"}


class BenchFailure(Exception):
    """A check of the run failed."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def default_threads(mode, n):
    """Threads a compress: the host's cores, shared by the ranks."""
    cores = os.cpu_count() or 8
    return max(1, cores // n) if mode == "ranks" else cores


def input_path(fastq, reads, cache, seed=SEED):
    """FASTQ, else bench.py's profile at ``reads`` reads and ``seed`` in
    ``cache`` (made on the first call)."""
    if fastq:
        return fastq, None
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"bench_{reads}_seed{seed}.fastq")
    if os.path.exists(path):
        return path, None
    from spring_tpu_torch.utils import synth
    t = time.time()
    tmp = path + ".part"
    synth.make_se_fast(tmp, reads, read_len=READ_LEN,
                       genome_size=max(GENOME, reads * READ_LEN // 50),
                       seed=seed, workers=os.cpu_count() or 4)
    os.replace(tmp, path)
    return path, round(time.time() - t, 3)


def same_file(a, b):
    """Whether two files hold the same bytes (read in 64 MiB blocks)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 26), fb.read(1 << 26)
            if x != y:
                return False
            if not x:
                return True


def count_records(path):
    """FASTQ records in the file: its lines over 4 (read in 64 MiB
    blocks)."""
    lines = 0
    with open(path, "rb") as f:
        while b := f.read(1 << 26):
            lines += b.count(b"\n")
    return lines // 4


def host_peak():
    """This process's peak RSS: VmHWM in kB (None where /proc has none)
    and ru_maxrss in kB."""
    hwm = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM"):
                    hwm = int(line.split()[1])
    except OSError:
        pass
    return dict(vmhwm_kb=hwm,
                ru_maxrss_kb=resource.getrusage(resource.RUSAGE_SELF)
                .ru_maxrss)


def host_rss():
    """This process's resident bytes now (statm; the running ru_maxrss
    where there is none)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10


class HostSampler:
    """The host RSS sampled each second, its maximum kept by the stage of
    the compress in progress (the index into
    short_mode.LAST_STAGE_SECONDS) and, with ``path``, rewritten there at
    each sample, so that a killed run leaves the peaks so far."""

    def __init__(self, path=None):
        from spring_tpu_torch.pipeline import short_mode
        self.stages = short_mode.LAST_STAGE_SECONDS
        self.path = path
        self.lock = threading.Lock()
        self.done = []          # the finished passes' peaks by stage
        self.peaks = {}
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def sample(self):
        rss = host_rss()
        with self.lock:
            i = len(self.stages)
            self.peaks[i] = max(self.peaks.get(i, 0), rss)
            self._write()

    def _write(self):
        if self.path:
            with open(self.path, "w") as f:
                json.dump(dict(passes=self.done, stages=list(self.stages),
                               peaks=self.peaks), f)

    def _loop(self):
        while not self.stop.wait(1.0):
            self.sample()

    def start_pass(self):
        with self.lock:
            self.stages.clear()
            self.peaks = {}

    def end_pass(self):
        """The pass's peaks, GB by stage name (past the last stage that
        ended: "after" it)."""
        self.sample()
        with self.lock:
            names = list(self.stages)
            out = {(names[i] if i < len(names) else
                    "after " + (names[-1] if names else "start")):
                   round(r / 1e9, 3) for i, r in sorted(self.peaks.items())}
            self.done.append(out)
            self._write()
            return out

    def close(self):
        self.stop.set()
        self.thread.join()


def graph_schedule(stats):
    """What is wrong with an engine run's flush schedule on the card, or
    None: on a program-cache miss one round called, captured once and
    every other round and compaction replayed; on a hit no round called,
    nothing captured, everything replayed."""
    miss = stats["program_cache"] == "miss"
    called = 1 if miss else 0
    if (stats["flushes"] >= 2 and stats["eager_rounds"] == called
            and stats["round_replays"] == stats["rounds_run"] - called
            and stats["graphed_flushes"] == stats["flushes"] - called
            and (stats["capture_s"] is not None) == miss):
        return None
    return (f"want {called} round called, a capture only on a miss and "
            f"every other round replayed: {stats}")


def compress_passes(fq, arc, threads, device, dist, cuda, passes=PASSES,
                    progress=None):
    """``passes`` compresses of fq into arc on ``device``; the engine's
    kernel launches and the device peaks are set to 0 just before each
    pass and read just after, the host RSS sampled through it. Returns
    one record a pass."""
    import torch
    from spring_tpu_torch import api
    from spring_tpu_torch.ops import kernels
    from spring_tpu_torch.pipeline import short_mode
    from spring_tpu_torch.reorder import engine
    opts = api.CompressOptions(num_threads=threads, verbose=False,
                               dist=dist)
    out = []
    sampler = HostSampler(progress)
    try:
        for i in range(passes):
            for name in KERNEL.values():
                getattr(kernels, name).launches = 0
            engine.LAST_RUN_STATS.clear()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
            sampler.start_pass()
            t = time.time()
            api.compress([fq], arc, opts, device=device)
            if cuda:
                torch.cuda.synchronize()
            secs = time.time() - t
            host = sampler.end_pass()
            stats = json.loads(json.dumps(engine.LAST_RUN_STATS,
                                          default=str))
            out.append(dict(
                compress_s=round(secs, 3), engine=stats,
                launches={n: getattr(kernels, n).launches
                          for n in KERNEL.values()},
                peak_allocated=torch.cuda.max_memory_allocated() if cuda
                else None,
                peak_reserved=torch.cuda.max_memory_reserved() if cuda
                else None,
                stage_s=dict(short_mode.LAST_STAGE_SECONDS),
                stage_peak_bytes=dict(short_mode.LAST_STAGE_PEAK_BYTES),
                stage_reserved_bytes=dict(
                    short_mode.LAST_STAGE_RESERVED_BYTES),
                host_rss_gb_by_stage=host))
            log(f"[{'dist' if dist else 'default'}] pass {i}: {secs:.3f} "
                f"s, program cache {stats.get('program_cache')}, rounds "
                f"{stats.get('rounds')} ({stats.get('rounds_run')} run), "
                f"host peak {max(host.values())} GB")
    finally:
        sampler.close()
    return out


def pass_failures(label, passes, dist, cuda):
    """The checks of one engine's passes (see the module docstring)."""
    bad = []
    for i, p in enumerate(passes):
        st = p["engine"]
        if i and st.get("program_cache") != "hit":
            bad.append(f"{label} pass {i}: program cache "
                       f"{st.get('program_cache')}, want a hit")
        if not cuda:
            continue
        kern = KERNEL[dist]
        other = {n: k for n, k in p["launches"].items() if n != kern and k}
        if p["launches"][kern] != st["rounds_run"] or other:
            bad.append(f"{label} pass {i}: launches {p['launches']} in "
                       f"{st['rounds_run']} rounds run")
        why = graph_schedule(st)
        if why:
            bad.append(f"{label} pass {i}: {why}")
        if dist and st.get("collectives_per_round") != 7:
            bad.append(f"{label} pass {i}: "
                       f"{st.get('collectives_per_round')} collectives a "
                       "round, want 7")
    return bad


def engine_record(passes, dist):
    """One engine's numbers: the best pass after the first (the first
    when it is the only one) and every pass."""
    best = min(passes[1:] or passes, key=lambda p: p["compress_s"])
    st = best["engine"]
    rec = dict(
        best_s=best["compress_s"], rounds=st.get("rounds"),
        rounds_run=st.get("rounds_run"),
        unmatched_frac=st.get("unmatched_frac"), Np=st.get("Np"),
        B=st.get("walkers"), dict_dropped=st.get("dict_dropped"),
        engine_s=st.get("flush_wall_s"), ms_per_round=st.get("ms_per_round"),
        ms_per_graphed_round=st.get("ms_per_graphed_round"),
        stage_s=best["stage_s"], launches=best["launches"],
        passes=[{k: v for k, v in p.items() if k != "engine"}
                | {k: p["engine"].get(k) for k in (
                    "program_cache", "eager_rounds", "capture_s",
                    "graph_pool_bytes", "cached_program_bytes",
                    "rounds_run", "flush_wall_s")} for p in passes])
    if dist:
        ws = st.get("world_size")
        rec.update(world_size=ws,
                   Bl=rec["B"] // ws if rec["B"] and ws else None,
                   collectives_per_round=st.get("collectives_per_round"),
                   collectives=st.get("collectives"),
                   world_collective_s=st.get("world_collective_s"),
                   exchange=st.get("exchange"),
                   emissions_sha256=st.get("emissions_sha256"))
    return rec


def round_trip(fq, arc, work, threads, made):
    """Decompress arc into the work directory and compare the output with
    fq (see the module docstring). Returns the round trip's record; the
    output is removed."""
    from spring_tpu_torch import api
    out = os.path.join(work, "out.fastq")
    size = os.path.getsize(fq)
    room = shutil.disk_usage(work).free > size + CHUNK
    mode = "cmp" if room else "sha256"
    want = None
    if not room:
        want = chunk_sums(fq)
        if made and os.stat(fq).st_dev == os.stat(work).st_dev:
            log(f"no room for the output beside {fq}: hashed it, deleting "
                "it from the cache")
            os.remove(fq)
    t = time.time()
    api.decompress(arc, [out], num_threads=threads, verbose=False)
    dec_s = round(time.time() - t, 3)
    ok = same_file(fq, out) if want is None else chunk_sums(out) == want
    os.remove(out)
    return dict(roundtrip_ok=ok, compare=mode, decompress_s=dec_s)


def run_engine(fq, work, threads, device, dist, cuda, passes, made):
    """``passes`` compresses on one engine, then the round trip of the
    last archive; raises BenchFailure at once on a round trip that
    differs. Returns (record, failures)."""
    label = "dist" if dist else "default"
    arc = os.path.join(work, f"{label}.stpu")
    runs = compress_passes(fq, arc, threads, device, dist, cuda, passes)
    rt = round_trip(fq, arc, work, threads, made)
    rec = dict(archive_bytes=os.path.getsize(arc), **rt,
               **engine_record(runs, dist))
    os.remove(arc)
    ok = rt["roundtrip_ok"]
    log(f"[{label}] best {rec['best_s']} s, archive {rec['archive_bytes']} "
        f"bytes, round trip ({rt['compare']}) "
        f"{'byte-exact' if ok else 'DIFFERS'}")
    if not ok:
        raise BenchFailure(f"{label}: the round trip differs from the input")
    return rec, pass_failures(label, runs, dist, cuda)


def chip(fq, work, threads, device, cuda, passes=PASSES, made=False):
    """Both engines on one device (see the module docstring)."""
    from spring_tpu_torch.parallel import multihost
    out = {}
    out["default"], bad = run_engine(fq, work, threads, device, False, cuda,
                                     passes, made)
    world = multihost.initialize(0, 1, os.path.join(work, "store"),
                                 device=device, timeout=900.0)
    try:
        out["dist"], bad_d = run_engine(fq, work, threads, world.device,
                                        True, cuda, passes, made)
    finally:
        multihost.shutdown()
    bad += bad_d
    d, s = out["dist"]["archive_bytes"], out["default"]["archive_bytes"]
    if abs(d - s) > 0.05 * s + 10240:
        bad.append(f"dist archive {d} bytes against the default's {s}")
    if out["dist"]["world_size"] != 1:
        bad.append(f"dist world size {out['dist']['world_size']}, want 1")
    out["dist_over_default"] = round(
        out["dist"]["best_s"] / out["default"]["best_s"], 4)
    return out, bad


def rank_passes(world, fq, arc, threads, passes=PASSES, progress=None):
    """One rank of ``ranks``: ``passes`` distributed compresses on this
    rank's device. Returns (pass records, the host's peak)."""
    cuda = world.device.type == "cuda"
    runs = compress_passes(
        fq, arc, threads, world.device, True, cuda, passes,
        progress.format(rank=world.rank) if progress else None)
    return runs, host_peak()


def ranks(n, fq, work, threads, device, cuda, passes=PASSES, made=False,
          progress=None):
    """The distributed compress on n ranks (see the module docstring)."""
    import torch
    from spring_tpu_torch.parallel import multihost
    if n < 1 or n & (n - 1):
        raise SystemExit(f"bench_dist_torch: {n} ranks; want a power of two")
    if cuda and n > torch.cuda.device_count():
        raise SystemExit(
            f"bench_dist_torch: {n} ranks want {n} cards, "
            f"{torch.cuda.device_count()} visible: one rank a card")
    from spring_tpu_torch.codecs import native
    from spring_tpu_torch.ops import _build
    native.load()               # built once here, not once a rank
    if cuda:
        _build.load()
    arc = os.path.join(work, "ranks.stpu")
    res = multihost.launch(rank_passes, n,
                           (fq, arc, threads, passes, progress),
                           device=device, timeout=RANK_TIMEOUT)
    bad = []
    per_rank = []
    for r, (runs, peak) in enumerate(res):
        bad += pass_failures(f"rank {r}", runs, True, cuda)
        per_rank.append(dict(
            seconds=[p["compress_s"] for p in runs],
            peak_allocated=[p["peak_allocated"] for p in runs],
            peak_reserved=[p["peak_reserved"] for p in runs],
            **peak, **engine_record(runs, True)))
    equal = all(len({res[r][0][i]["engine"]["emissions_sha256"]
                     for r in range(n)}) == 1 for i in range(passes))
    if not equal:
        bad.append(f"emissions differ between the {n} ranks")
    rt = round_trip(fq, arc, work, threads, made)
    archive = os.path.getsize(arc)
    os.remove(arc)
    ok = rt["roundtrip_ok"]
    if not ok:
        bad.append("the round trip of rank 0's archive differs from the "
                   "input")
    log(f"[ranks {n}] archive {archive} bytes, round trip "
        f"({rt['compare']}) {'byte-exact' if ok else 'DIFFERS'}, "
        f"emissions {'equal' if equal else 'DIFFER'} on the ranks")
    return dict(ranks=n, per_rank=per_rank, emissions_equal=equal,
                **rt, archive_bytes=archive,
                best_s=max(r["best_s"] for r in per_rank)), bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("chip", "ranks"))
    ap.add_argument("args", nargs="*",
                    help="chip: [FASTQ]; ranks: N [FASTQ]")
    ap.add_argument("--reads", type=int, default=1_000_000,
                    help="reads of the made input (default 1,000,000)")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the made input (default 42; 5 is "
                         "tools/rss_check_torch.py's)")
    ap.add_argument("--cache", default=os.path.join(
        tempfile.gettempdir(), "bench_dist_torch_data"))
    ap.add_argument("--work", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=None,
                    help="threads a compress (default: the host's cores, "
                         "over N in ranks mode)")
    ap.add_argument("--passes", type=int, default=PASSES,
                    help="compresses an engine or a rank (default 3)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.passes < 1:
        ap.error("--passes must be at least 1")
    import torch
    cuda = torch.device(a.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("bench_dist_torch: no CUDA device; pass --device "
                         "cpu for a CPU run")
    if a.mode == "ranks":
        if not a.args:
            ap.error("ranks needs N")
        n, fastq = int(a.args[0]), (a.args[1:] or [None])[0]
    else:
        n, fastq = None, (a.args or [None])[0]
    threads = a.threads or default_threads(a.mode, n or 1)
    card = card_line() if cuda else None
    kind = torch.cuda.get_device_name(0) if cuda else None
    log(f"device {a.device}: {kind}; nvidia-smi: {card}")
    work = a.work or tempfile.mkdtemp(prefix="bench_dist_torch_")
    os.makedirs(work, exist_ok=True)
    if not fastq:
        os.makedirs(a.cache, exist_ok=True)
    show(["df", "-h", fastq or a.cache, work], log)
    show(["free", "-g"], log)
    fq, gen_s = input_path(fastq, a.reads, a.cache, a.seed)
    reads = count_records(fq)
    size = os.path.getsize(fq)
    log(f"input {fq}: {reads} reads, {size} bytes"
        + (f", made in {gen_s} s" if gen_s is not None else ""))
    rec = dict(mode=a.mode, input=fq, reads=reads, input_bytes=size,
               seed=None if fastq else a.seed, gen_s=gen_s,
               device=a.device, kind=kind, card=card, threads=threads,
               passes=a.passes)
    progress = (a.out or os.path.join(work, "host")) + ".rank{rank}.progress"
    try:
        if a.mode == "chip":
            res, bad = chip(fq, work, threads, a.device, cuda, a.passes,
                            not fastq)
        else:
            res, bad = ranks(n, fq, work, threads, a.device, cuda, a.passes,
                             not fastq, progress)
        rec.update(res)
    except (BenchFailure, RuntimeError, TimeoutError) as e:
        # a failed check, a rank that failed (multihost.launch's report)
        # or ranks out of time: the last line still says what happened
        bad = [str(e)[-8000:]]
    finally:
        if a.work is None:
            shutil.rmtree(work, ignore_errors=True)
    rec.update(ok=not bad, failures=bad)
    line = json.dumps(rec)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    for b in bad:
        log(f"FAILED: {b}")
    print(line, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.modules["jax"] = None           # the port runs without JAX
    sys.modules["spring_tpu"] = None
    sys.exit(main())
