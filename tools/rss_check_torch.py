#!/usr/bin/env python3
"""Peak memory, stage times and round trip of the port's compress at scale.

    python tools/rss_check_torch.py [n_reads] [read_len] [limit_gb]
        [--device cuda|cpu] [--cache DIR] [--work DIR] [--threads N]
        [--out FILE]

The PyTorch port's counterpart of tools/rss_check.py, on the same input:
synth.make_se(n_reads, read_len, genome_size=max(2_000_000,
n_reads * read_len // 50), seed=5) (spring_tpu_torch/utils/synth.py),
made once into the cache directory (default: rss_check_torch_data under
the temporary directory) and kept there for later runs. It prints ``df``
and ``free -g`` first, then runs spring_tpu_torch.api.compress in a child
process on --device (default cuda), then api.decompress in another, and
checks the round trip: ``cmp`` of input and output where the disk holds
both, else SHA-256 sums of 1 GiB chunks of each (the input is hashed and
deleted from the cache before the decompress writes its output).

The last line of standard output is one JSON object (also appended to
--out FILE): compress and decompress seconds, archive bytes, each child's
own peak RSS (VmHWM, and ru_maxrss, which a kernel without VmHWM still
gives), the host RSS and device bytes sampled each second, their maxima
by stage, the pipeline's stage seconds and device peaks at each stage's
end (allocated and reserved; short_mode.LAST_STAGE_*), the
engine's numbers (engine.LAST_RUN_STATS: rounds, rounds run, unmatched
reads, keys dropped per read dictionary, Np, walkers B, consensus
dictionaries a matcher used), round_trip, and on a card its name and
power limit (nvidia-smi). The exit code is 0 only when compress and
decompress ran, the round trip is byte-exact and the compress child's
peak RSS is below limit_gb (default 8, as rss_check.py's); a failed
child's error and the peaks it reached by stage are in the JSON line.

    python tools/rss_check_torch.py 20000 100 8 --device cpu --cache DIR

rehearses it on the CPU (tests/test_torch_rss_check.py).
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
SEED = 5
CHUNK = 1 << 30     # bytes a SHA-256 sum of the chunked comparison covers

CHILD = r"""
import json, os, resource, sys, threading, time, traceback
sys.path.insert(0, %(repo)r)
import torch
from spring_tpu_torch import api
from spring_tpu_torch.ops import graphs, kernels
from spring_tpu_torch.pipeline import short_mode
from spring_tpu_torch.reorder import engine

res = {}
card = %(device)r == "cuda"
stages = short_mode.LAST_STAGE_SECONDS
peaks = {}      # stage index -> [host RSS, device allocated] maxima
lock = threading.Lock()


def sample():
    # host RSS (statm; the running ru_maxrss where there is none) and
    # device allocated bytes, the maxima kept by the stage in progress and
    # written out at each sample, so that a killed child leaves them
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10
    dev = torch.cuda.memory_allocated() if card else 0
    with lock:
        m = peaks.setdefault(len(stages), [0, 0])
        m[0], m[1] = max(m[0], rss), max(m[1], dev)
        with open(%(prog)r, "w") as f:
            json.dump(dict(stages=list(stages), peaks=peaks), f)


def sampler():
    while True:
        sample()
        time.sleep(1)


threading.Thread(target=sampler, daemon=True).start()
t = time.time()
try:
    if %(what)r == "compress":
        api.compress([%(fq)r], %(arc)r, api.CompressOptions(
            num_threads=%(threads)d, verbose=False), device=%(device)r)
        if card:
            torch.cuda.synchronize()
    else:
        api.decompress(%(arc)r, [%(out)r], num_threads=%(threads)d,
                       verbose=False)
    res["seconds"] = round(time.time() - t, 3)
except Exception as e:
    res["error"] = "".join(traceback.format_exception(e))[-4000:]
sample()
if %(what)r == "compress":
    res.update(
        stage_seconds=dict(short_mode.LAST_STAGE_SECONDS),
        stage_peak_bytes=dict(short_mode.LAST_STAGE_PEAK_BYTES),
        stage_reserved_bytes=dict(short_mode.LAST_STAGE_RESERVED_BYTES),
        engine=json.loads(json.dumps(engine.LAST_RUN_STATS, default=str)),
        loops=json.loads(json.dumps(graphs.LOOP_STATS)),
        verify_rows_launches=kernels.verify_rows.launches)
    if card:
        res.update(kind=torch.cuda.get_device_name(0),
                   device_peak_allocated=torch.cuda.max_memory_allocated(),
                   device_peak_reserved=torch.cuda.max_memory_reserved())
with open("/proc/self/status") as f:      # this process's own peak
    for line in f:
        if line.startswith("VmHWM"):
            res["vmhwm_kb"] = int(line.split()[1])
res["ru_maxrss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
with open(%(res)r, "w") as f:
    json.dump(res, f)
sys.exit(1 if "error" in res else 0)
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def run_child(what: str, work: str, prog: str, **kw) -> dict:
    """api.compress or api.decompress in a child process; its result
    dict (an "error" key where it failed). The child rewrites its sampled
    peaks into ``prog`` each second."""
    res = os.path.join(work, f"{what}.json")
    code = CHILD % dict(repo=REPO, what=what, res=res, prog=prog, **kw)
    rc = subprocess.run([sys.executable, "-c", code], cwd=REPO).returncode
    out = {"error": f"{what} child exited {rc} without a result"}
    if os.path.exists(res):
        with open(res) as f:
            out = json.load(f)
    if rc and "error" not in out:
        out["error"] = f"{what} child exited {rc}"
    if os.path.exists(prog):
        with open(prog) as f:
            prog = json.load(f)
        names = prog["stages"]
        # the samples taken while stage i ran, by its name (past the last
        # stage that ended: "after" it)
        out["sampled"] = {
            (names[int(i)] if int(i) < len(names) else
             "after " + (names[-1] if names else "start")):
            {"host_rss_gb": round(r / 1e9, 3),
             "device_allocated_gb": round(d / 1e9, 3)}
            for i, (r, d) in sorted(prog["peaks"].items(),
                                    key=lambda kv: int(kv[0]))}
    return out


def chunk_sums(path: str) -> list:
    """SHA-256 hex digests of the file's successive CHUNK-byte chunks."""
    out = []
    with open(path, "rb") as f:
        while True:
            b = f.read(CHUNK)
            if not b:
                return out
            out.append(hashlib.sha256(b).hexdigest())


def show(cmd: list, say=log) -> None:
    """Pass the output of cmd to ``say`` (default: standard output)."""
    try:
        say(subprocess.run(cmd, capture_output=True, text=True,
                           timeout=60).stdout.rstrip())
    except FileNotFoundError:
        say(f"({cmd[0]} not found)")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def gb(kb) -> float | None:
    return None if kb is None else round(kb / 1e6, 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", type=int, nargs="?", default=10_000_000)
    ap.add_argument("read_len", type=int, nargs="?", default=100)
    ap.add_argument("limit_gb", type=float, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", default=os.path.join(
        tempfile.gettempdir(), "rss_check_torch_data"))
    ap.add_argument("--work", default=None,
                    help="directory of the archive and the output "
                         "(default: the temporary directory); a tmpfs "
                         "such as /dev/shm keeps them off a disk whose "
                         "writes are limited")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    N, L = a.n_reads, a.read_len
    card = None
    if a.device == "cuda":
        card = card_line()      # raises where there is no card
        log(card)
    os.makedirs(a.cache, exist_ok=True)
    work = tempfile.mkdtemp(prefix="rss_check_torch_", dir=a.work)
    show(["df", "-h", a.cache, work])
    show(["free", "-g"])
    fq = os.path.join(a.cache, f"in_{N}_{L}.fastq")
    genome = max(2_000_000, N * L // 50)   # ~50x coverage at any N
    gen_s = None
    if not os.path.exists(fq):
        log(f"generating {N} x {L} bp reads (genome {genome}, seed {SEED})")
        sys.path.insert(0, REPO)
        from spring_tpu_torch.utils import synth
        t = time.time()
        synth.make_se(fq + ".tmp", N, read_len=L, genome_size=genome,
                      seed=SEED)
        os.replace(fq + ".tmp", fq)
        gen_s = round(time.time() - t, 3)
    size = os.path.getsize(fq)
    log(f"input {size} bytes; compressing on {a.device}")
    arc = os.path.join(work, "out.stpu")
    out = os.path.join(work, "out.fastq")
    kw = dict(fq=fq, arc=arc, out=out, device=a.device, threads=a.threads)
    # the sampled peaks go beside --out, where a killed run leaves them
    prog = (a.out or os.path.join(work, "peaks")) + ".{}.progress"
    comp = run_child("compress", work, prog.format("compress"), **kw)
    eng = comp.get("engine", {})
    rec = {
        "n_reads": N, "read_len": L, "genome_size": genome, "seed": SEED,
        "input_bytes": size, "gen_s": gen_s, "device": a.device,
        "card": card, "kind": comp.get("kind"),
        "compress_s": comp.get("seconds"),
        "archive_bytes": (os.path.getsize(arc) if "error" not in comp
                          else None),
        "compress_vmhwm_gb": gb(comp.get("vmhwm_kb")),
        "compress_ru_maxrss_gb": gb(comp.get("ru_maxrss_kb")),
        "limit_gb": a.limit_gb,
        "device_peak_allocated": comp.get("device_peak_allocated"),
        "device_peak_reserved": comp.get("device_peak_reserved"),
        "LAST_STAGE_SECONDS": comp.get("stage_seconds"),
        "LAST_STAGE_PEAK_BYTES": comp.get("stage_peak_bytes"),
        "LAST_STAGE_RESERVED_BYTES": comp.get("stage_reserved_bytes"),
        "rounds": eng.get("rounds"), "rounds_run": eng.get("rounds_run"),
        "unmatched_frac": eng.get("unmatched_frac"),
        "unmatched_reads": eng.get("unmatched"),
        "dict_dropped": eng.get("dict_dropped"), "Np": eng.get("Np"),
        "B": eng.get("walkers"),
        "consensus_segments": eng.get("consensus_segments"),
        "verify_rows_launches": comp.get("verify_rows_launches"),
        "engine": eng, "matcher_loops": comp.get("loops"),
        "compress_sampled_by_stage": comp.get("sampled"),
        "round_trip": False,
    }
    errors = [comp["error"]] if "error" in comp else []
    if not errors:
        free = shutil.disk_usage(work).free
        rec["compare"] = "cmp" if free > size + (1 << 30) else "sha256"
        want = None
        if rec["compare"] == "sha256":
            log(f"{free} bytes free: hashing the input, then deleting it "
                "from the cache")
            want = chunk_sums(fq)
            os.remove(fq)
        dec = run_child("decompress", work, prog.format("decompress"),
                        **kw)
        rec["decompress_s"] = dec.get("seconds")
        rec["decompress_vmhwm_gb"] = gb(dec.get("vmhwm_kb"))
        rec["decompress_ru_maxrss_gb"] = gb(dec.get("ru_maxrss_kb"))
        if "error" in dec:
            errors.append(dec["error"])
        elif want is None:
            rec["round_trip"] = subprocess.run(
                ["cmp", "-s", fq, out]).returncode == 0
        else:
            rec["round_trip"] = chunk_sums(out) == want
        if not errors and not rec["round_trip"]:
            errors.append("the decompressed output differs from the input")
    hwm = rec["compress_vmhwm_gb"] or rec["compress_ru_maxrss_gb"]
    rec["rss_within_limit"] = hwm is not None and hwm < a.limit_gb
    if errors:
        rec["error"] = errors
    rec["ok"] = not errors and rec["rss_within_limit"]
    shutil.rmtree(work, ignore_errors=True)
    line = json.dumps(rec)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    log(line)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
