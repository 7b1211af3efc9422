#!/usr/bin/env python3
"""Warm whole-compress seconds, archive bytes and engine numbers for each
set of engine overrides.

    python tools/sweep_probe_torch.py FASTQ [NAME=key:val[,key:val] ...]
        [--device cuda|cpu] [--passes 3] [--threads N] [--work DIR]
        [--check-default] [--out FILE]

The PyTorch port's counterpart of tools/sweep_probe.py. A config is
NAME=key:val[,key:val], or NAME= for the defaults; its keys are
spring_tpu_torch.api.ENGINE_KEYS, set through CompressOptions.engine (a
JAX environment variable such as SPRING_TPU_SC is refused with the key
that replaces it). The default list: base=, fn4=far_near:4,
sc8=shift_chunk:8, sc32=shift_chunk:32, sl8=accept_slots:8,
sl32=accept_slots:32, w16k=num_walkers:16384, cap6=cap_per_round:6,
fr64=flush_rounds:64, then base= again: the host differs by up to 1.9
times between runs, so the two base lines show the drift over the sweep.

Each config, in this process on --device (default cuda; with no card
the tool fails, it never moves to the CPU): the program cache emptied,
then --passes compresses (CompressOptions(num_threads=--threads,
verbose=False, engine=...), the device synchronised around each) into
one archive in --work (default: a new temporary directory, removed at
the end). Pass 0 builds the flush program (a program-cache miss); every
later pass must hit the cache, and the best of them is ``best_s`` (pass
0's time when it is the only one). Then the archive is decompressed into
--work and compared with FASTQ byte for byte, or by SHA-256 sums of 1 GiB
chunks (tools/rss_check_torch.py's chunk_sums) where --work has no room
for the output beside the input; the output is removed at once.

One JSON line a config: its name and engine dict, best_s and every
pass's seconds and cache state, archive bytes and SHA-256, the best
pass's engine.LAST_RUN_STATS (rounds, rounds run, ms_per_graphed_round,
program_cache, unmatched_frac, ...) and short_mode.LAST_STAGE_SECONDS,
and the round trip. The first line gives the card's name and power
limit (nvidia-smi; null on the CPU) and the input; the last a summary:
each config's best_s, archive bytes, rounds and ms a replayed round, the
first and last configs' best_s where their engines are equal, and
``default_check``: with --check-default a fresh process compresses FASTQ
with the default options (nothing set but the threads) and every
config with no override must give its archive byte for byte. Lines are
also appended to --out FILE; progress goes to stderr. The exit code is
1 when a round trip differs, a pass after the first misses the program
cache or the default check fails. Imports neither JAX nor the JAX
package.
"""
import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from bench_dist_torch import same_file  # noqa: E402
from knob_sweep_torch import card_line, config_value, log  # noqa: E402
from rss_check_torch import CHUNK, chunk_sums  # noqa: E402

PASSES = 3
DEFAULT_CONFIGS = ("base=", "fn4=far_near:4", "sc8=shift_chunk:8",
                   "sc32=shift_chunk:32", "sl8=accept_slots:8",
                   "sl32=accept_slots:32", "w16k=num_walkers:16384",
                   "cap6=cap_per_round:6", "fr64=flush_rounds:64", "base=")

# a compress of FASTQ into ARCHIVE with the default options, in a fresh
# process
DEFAULT_CHILD = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["spring_tpu"] = None
sys.path.insert(0, %(repo)r)
from spring_tpu_torch import api
fq, arc, device, threads = sys.argv[1:5]
api.compress([fq], arc, api.CompressOptions(num_threads=int(threads),
                                            verbose=False), device=device)
"""


def parse_config(spec):
    """NAME=key:val[,key:val] -> (NAME, CompressOptions.engine dict)."""
    from spring_tpu_torch import api
    name, sep, body = spec.partition("=")
    if not sep or not name:
        raise ValueError(f"config {spec!r}: want NAME=key:val[,key:val]")
    engine = {}
    for kv in filter(None, body.split(",")):
        k, _, v = kv.partition(":")
        engine[k] = config_value(k, v, set(api.ENGINE_KEYS))
    return name, engine


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while b := f.read(1 << 26):
            h.update(b)
    return h.hexdigest()


class RoundTrip:
    """Decompress an archive into ``work`` and compare it with ``fq``:
    byte for byte where ``work`` has room for the output beside the
    input, else by chunk_sums (the input's taken once)."""

    def __init__(self, fq, work, threads):
        self.fq, self.threads = fq, threads
        self.out = os.path.join(work, "sweep.out.fastq")
        self._want = None

    def __call__(self, arc):
        from spring_tpu_torch import api
        room = (shutil.disk_usage(os.path.dirname(self.out)).free
                > os.path.getsize(self.fq) + CHUNK)
        if not room and self._want is None:
            self._want = chunk_sums(self.fq)
        t = time.time()
        api.decompress(arc, [self.out], num_threads=self.threads,
                       verbose=False)
        dec_s = round(time.time() - t, 3)
        try:
            ok = (same_file(self.fq, self.out) if room
                  else chunk_sums(self.out) == self._want)
        finally:
            os.remove(self.out)
        return dict(round_trip="byte-exact" if ok else "mismatch",
                    compare="cmp" if room else "sha256", decompress_s=dec_s)


def run_config(torch, fq, arc, name, engine, passes, device, threads):
    """``passes`` compresses of one config from an empty program cache:
    (record, failures)."""
    from spring_tpu_torch import api
    from spring_tpu_torch.pipeline import short_mode
    from spring_tpu_torch.reorder import engine as eng
    cuda = device.type == "cuda"
    api.clear_program_cache()
    opts = api.CompressOptions(num_threads=threads, verbose=False,
                               engine=dict(engine))
    best, each, bad = None, [], []
    for i in range(passes):
        if cuda:
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        api.compress([fq], arc, opts, device=device)
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t
        stats = dict(eng.LAST_RUN_STATS)
        each.append(dict(s=round(dt, 4),
                         program_cache=stats.get("program_cache"),
                         rounds=stats.get("rounds"),
                         engine_s=stats.get("flush_wall_s")))
        log(f"[{name}] pass {i}: {json.dumps(each[-1])}")
        if i and stats.get("program_cache") != "hit":
            bad.append(f"{name}: pass {i} missed the program cache "
                       f"({stats.get('program_cache')})")
        if (i or passes == 1) and (best is None or dt < best[0]):
            best = (dt, stats, dict(short_mode.LAST_STAGE_SECONDS))
    dt, stats, stages = best
    rec = dict(config=name, engine=engine, best_s=round(dt, 4),
               passes=each, archive_bytes=os.path.getsize(arc),
               archive_sha256=sha256(arc), run=stats, stage_s=stages)
    return rec, bad


def default_check(fq, work, device, threads, records):
    """A fresh process's compress with the default options against
    every config with no override: (check record, failures)."""
    plain = [r for r in records if not r["engine"]]
    if not plain:
        return None, []
    arc = os.path.join(work, "default.stpu")
    t = time.time()
    subprocess.run([sys.executable, "-c", DEFAULT_CHILD % dict(repo=REPO),
                    fq, arc, str(device), str(threads)], check=True)
    want = sha256(arc)
    rec = dict(archive_bytes=os.path.getsize(arc), archive_sha256=want,
               compress_s=round(time.time() - t, 3),
               equal=[[r["config"], r["archive_sha256"] == want]
                      for r in plain])
    os.remove(arc)
    bad = [f"{r['config']}: archive differs from the default compress"
           for r in plain if r["archive_sha256"] != want]
    return rec, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fastq")
    ap.add_argument("configs", nargs="*",
                    help="NAME=key:val[,key:val] (keys: api.ENGINE_KEYS)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--passes", type=int, default=PASSES)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--work", default=None)
    ap.add_argument("--check-default", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.passes < 1:
        ap.error("--passes must be at least 1")
    try:
        configs = [parse_config(s) for s in a.configs or DEFAULT_CONFIGS]
    except ValueError as e:
        ap.error(str(e))
    import torch
    device = torch.device(a.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("sweep_probe_torch: no CUDA device; pass --device "
                         "cpu for a CPU run")
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    card = card_line() if cuda else None
    kind = torch.cuda.get_device_name(device) if cuda else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")

    emit(dict(tool="sweep_probe_torch", card=card, kind=kind,
              device=a.device, input=a.fastq,
              input_bytes=os.path.getsize(a.fastq), threads=a.threads,
              passes=a.passes))
    work = a.work or tempfile.mkdtemp(prefix="sweep_probe_torch_")
    os.makedirs(work, exist_ok=True)
    arc = os.path.join(work, "sweep.stpu")
    trip = RoundTrip(a.fastq, work, a.threads)
    records, bad = [], []
    try:
        for name, engine in configs:
            rec, fail = run_config(torch, a.fastq, arc, name, engine,
                                   a.passes, device, a.threads)
            rec.update(trip(arc))
            os.remove(arc)
            if rec["round_trip"] != "byte-exact":
                fail.append(f"{name}: round trip {rec['round_trip']}")
            rec.update(card=card, device=a.device, ok=not fail)
            emit(rec)
            records.append(rec)
            bad += fail
        check = None
        if a.check_default:
            check, fail = default_check(a.fastq, work, device, a.threads,
                                        records)
            bad += fail
    finally:
        if a.work is None:
            shutil.rmtree(work, ignore_errors=True)
    first, last = records[0], records[-1]
    drift = (dict(first_s=first["best_s"], last_s=last["best_s"],
                  last_over_first=round(last["best_s"] / first["best_s"], 4))
             if len(records) > 1 and first["engine"] == last["engine"]
             else None)
    emit(dict(summary=[dict(config=r["config"], best_s=r["best_s"],
                            archive_bytes=r["archive_bytes"],
                            rounds=r["run"].get("rounds"),
                            ms_per_graphed_round=r["run"].get(
                                "ms_per_graphed_round"))
                       for r in records],
              drift=drift, default_check=check, card=card, ok=not bad,
              failures=bad))
    for b in bad:
        log(f"FAILED: {b}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.modules["jax"] = None           # the port runs without JAX
    sys.modules["spring_tpu"] = None
    sys.exit(main())
