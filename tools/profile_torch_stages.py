"""Split the port's one-shot device stages into device time and host time
on a CUDA card, with torch.profiler.

    python tools/profile_torch_stages.py [--reads 1000000] [--root DIR]
                                         [--label NAME] [--out DIR]
                                         [--fastq PATH]

Makes bench_torch.py's input (synth.make_se: 100 bp reads, genome
max(2M, reads * 100 / 50), seed 42) and compresses it three times in one
process on the card with the default options:
  1. a warm-up: the process's first compress, as the CLI's one call
     makes it (every program-cache miss, the libraries' first load);
  2. a profiled pass, in which each call of the stages' device work runs
     under its own torch.profiler window: the read dictionaries' build
     (``ReorderEngine._build_dicts``, inside the stage ``reorder_run``),
     contig stitching (``stitch_layout``, stage ``stitch[...]``) and the
     second-chance match (``align_leftovers_packed`` called from the
     pipeline, stage ``second_chance``). For each: the host wall of the
     call (the device synchronised before and after), the device busy
     time (the union of its kernels' spans), kernels, and the host's
     ``cudaGraphLaunch`` and ``cudaLaunchKernel`` calls;
  3. a pass without the profiler, whose stage seconds and device peaks
     (short_mode.LAST_STAGE_SECONDS / LAST_STAGE_PEAK_BYTES) are printed
     beside each call's split.
A pass's peaks are the allocated bytes and the reserved bytes
(torch.cuda.max_memory_reserved): a replayed CUDA graph allocates nothing,
so on a hit only the reserved peak holds the cached programs' pools.
Every pass prints the matchers' loops (ops/graphs.LOOP_STATS: iterations,
captures, replays, capture seconds, pool bytes) where the package has
them. ``--fastq PATH`` reads the input from PATH, made there first if it
is not there, so that several runs share one input.
``--root DIR`` imports spring_tpu_torch from DIR (a checkout of another
commit, to compare two trees on one card in one call). The card's name
and power limit (nvidia-smi) head the output; the last line is one JSON
object, also written to DIR/stages_LABEL.json with ``--out DIR``. Runs on
the card; ``--device cpu --reads 4096`` rehearses
the script here (no device times: the CPU has no kernels to trace).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from profile_torch_engine import _busy_us


def _split(events) -> dict:
    """Device busy us, kernels and host launch calls of one window."""
    spans = []
    host = {"cudaGraphLaunch": 0, "cudaLaunchKernel": 0}
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        if str(e.device_type).endswith("CUDA"):
            spans.append((e.time_range.start, e.time_range.end))
        else:
            for api in host:
                if e.name.startswith(api):
                    host[api] += 1
    return dict(busy_us=_busy_us(spans), kernels=len(spans), **host)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--root", default=None,
                    help="import spring_tpu_torch from this directory")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=None,
                    help="also write the result to DIR/stages_LABEL.json")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fastq", default=None,
                    help="the input's path (made there if missing)")
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)

    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("profile_torch_stages: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0] \
        if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    print("[card]", card, flush=True)

    import spring_tpu_torch
    from spring_tpu_torch import api
    from spring_tpu_torch.encode import second_chance, stitch
    from spring_tpu_torch.ops import graphs
    from spring_tpu_torch.pipeline import short_mode
    from spring_tpu_torch.reorder import engine
    from spring_tpu_torch.utils import synth
    print(f"[{args.label}] spring_tpu_torch from "
          f"{os.path.dirname(spring_tpu_torch.__file__)}", flush=True)

    calls = []
    depth = [0]

    def profiled(name, fn):
        """fn, each outermost call run in a profiler window of its own
        (only while ``calls`` is a list)."""
        def run(*a, **k):
            if calls is None or depth[0]:
                return fn(*a, **k)
            depth[0] += 1
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    sync()
                    t = time.perf_counter()
                    out = fn(*a, **k)
                    sync()
                    wall = time.perf_counter() - t
            finally:
                depth[0] -= 1
            sp = _split(prof.events())
            calls.append(dict(name=name, wall_s=round(wall, 4),
                              device_busy_s=round(sp["busy_us"] / 1e6, 4),
                              host_s=round(wall - sp["busy_us"] / 1e6, 4),
                              kernels=sp["kernels"],
                              cudaGraphLaunch=sp["cudaGraphLaunch"],
                              cudaLaunchKernel=sp["cudaLaunchKernel"]))
            return out
        return run

    engine.ReorderEngine._build_dicts = profiled(
        "dict_build", engine.ReorderEngine._build_dicts)
    stitch.stitch_layout = profiled("stitch", stitch.stitch_layout)
    second_chance.align_leftovers_packed = profiled(
        "second_chance", second_chance.align_leftovers_packed)

    passes = []
    with tempfile.TemporaryDirectory(prefix="stages_") as tmp:
        fq = args.fastq or os.path.join(tmp, "in.fastq")
        genome = max(2_000_000, args.reads * 100 // 50)
        t = time.time()
        if not os.path.exists(fq):
            synth.make_se(fq, args.reads, read_len=100, genome_size=genome,
                          seed=42)
        print(f"[data] {args.reads} reads, genome {genome}, seed 42, in "
              f"{time.time() - t:.1f} s ({fq})", flush=True)
        arc = os.path.join(tmp, "out.stpu")
        opts = api.CompressOptions(num_threads=args.threads, verbose=False)
        for k, mode in enumerate(("warm-up", "profiled", "clean")):
            calls = [] if mode == "profiled" else None
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t = time.time()
            api.compress([fq], arc, opts, device=args.device)
            sync()
            p = dict(
                mode=mode, compress_s=round(time.time() - t, 3),
                archive_bytes=os.path.getsize(arc),
                peak_bytes=torch.cuda.max_memory_allocated() if cuda
                else None,
                peak_reserved_bytes=torch.cuda.max_memory_reserved() if cuda
                else None,
                stages_s=dict(short_mode.LAST_STAGE_SECONDS),
                stage_peak_bytes=dict(short_mode.LAST_STAGE_PEAK_BYTES),
                loops=dict(getattr(graphs, "LOOP_STATS", {})),
                cached_program_bytes=graphs.cached_program_bytes(
                    args.device),
                engine_cache=engine.LAST_RUN_STATS.get("program_cache"),
                calls=calls)
            passes.append(p)
            print(f"[{args.label}] pass {k + 1} ({mode}): "
                  f"{json.dumps(p)} on {card}", flush=True)
    clean = passes[2]["stages_s"]
    for c in passes[1]["calls"]:
        stage = {"dict_build": "reorder_run", "second_chance":
                 "second_chance"}.get(c["name"])
        if stage is None:
            stage = next((s for s in clean if s.startswith("stitch[")), "")
        print(f"[{args.label}] {c['name']}: call {c['wall_s']} s = device "
              f"{c['device_busy_s']} s + host {c['host_s']} s "
              f"({c['kernels']} kernels, {c['cudaGraphLaunch']} "
              f"cudaGraphLaunch, {c['cudaLaunchKernel']} cudaLaunchKernel); "
              f"stage {stage} {clean.get(stage)} s without the profiler; "
              f"on {card}", flush=True)
    res = dict(label=args.label, root=root, reads=args.reads, card=card,
               passes=passes)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"stages_{args.label}.json"),
                  "w") as f:
            json.dump(res, f)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
