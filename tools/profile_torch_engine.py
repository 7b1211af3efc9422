"""Profile the port's reorder engine on a CUDA card with torch.profiler.

    python tools/profile_torch_engine.py [--reads 1000000] [--out DIR]
                                         [--dist [--no-group]]

Builds SRR554369-class packed reads in memory (1% substitutions, both
strands, ~50x coverage, seed 42), runs spring_tpu_torch's ReorderEngine
once on cuda to warm up (a program-cache miss: it captures the flush
program and leaves it in the cache) and once under torch.profiler (a
hit: every round replayed, nothing captured), and prints, under
the card's name and power limit (nvidia-smi):
  * the dictionary build and run wall times, rounds and ms/round, the
    flush runner's capture+instantiate seconds, graphed flushes and graph
    pool bytes;
  * the host's launch calls a graphed round: ``cudaGraphLaunch`` and
    ``cudaLaunchKernel`` (and its variants) counted apart, from the end
    of the runner's bind to a cached program (or of a miss's first
    capture) to the end of the run, over the rounds replayed;
  * device kernels a round (all of the run's device kernels, dictionary
    build and flush compaction included, over the rounds run) and the
    device busy share (the union of the kernels' spans over wall time),
    of the whole run and of its graphed part (from its first kernel to
    its last);
  * the round's hand-written kernel: calls, device us a call inside the
    graphs (the calls after the capture) and in all;
  * the ops with the most CUDA time. The full table goes to
    DIR/engine_ops.txt (DIR/dist_engine_ops.txt with --dist).
Each count is printed beside the parent's value, when every flush was a
Python loop of eager launches (BEFORE, PERF.md sections 5-6).
With --dist the engine is the distributed one (parallel/dist.py) at
world size 1 over NCCL: its round's kernel is masked_hamming_rows
(masked_hamming_kernel in the trace), and the NCCL kernels are listed.
With --no-group the same engine runs with one rank and no process group,
so that its collectives are the identity. The warm-up run's ms/round (no
profiler) is printed too. Needs a CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# The parent's values, when every flush was a Python loop of eager
# launches, by this script at 1M reads on an NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md sections 5-6, the runs before the flush was graphed).
BEFORE = {
    "engine": {"launches_a_round": 995.7, "busy_pct": 5.8,
               "kernel_us_a_call": 4.725},
    "dist": {"launches_a_round": 1254.7, "busy_pct": 12.7,
             "kernel_us_a_call": 2.341},
    "dist-no-group": {"launches_a_round": 1238.5, "busy_pct": None,
                      "kernel_us_a_call": None},
}


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


def _busy_us(spans) -> float:
    """Length of the union of (start, end) spans: time the device ran at
    least one kernel (the profiler's kernel spans may overlap)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _trace_counts(events, kernel_name: str) -> dict:
    """Host launch calls, device kernels and the round kernel's calls,
    split at the end of the flush runner's bind to a cached program, or of
    a miss's first capture (the record_function ranges ``stpu::bind``,
    ``stpu::capture``): what comes after it is the graphed part, which
    spans from its first device kernel to its last. The NCCL kernels that
    a graph replays do not show in the trace."""
    marks = [e.time_range.end for e in events
             if e.name in ("stpu::bind", "stpu::capture")]
    t_graph = min(marks) if marks else float("inf")
    host = {"cudaGraphLaunch": 0, "cudaLaunchKernel": 0}
    spans_all, spans_graph = [], []
    ours_all, ours_graph = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False):
            continue            # a range on the device's timeline, no work
        if str(e.device_type).endswith("CUDA"):
            spans_all.append((start, end))
            if kernel_name in e.name:
                ours_all.append(end - start)
            if start >= t_graph:
                spans_graph.append((start, end))
                if kernel_name in e.name:
                    ours_graph.append(end - start)
        elif start >= t_graph:
            for api in host:
                if e.name.startswith(api):
                    host[api] += 1
    span = (max(e for _, e in spans_graph) - min(s for s, _ in spans_graph)
            if spans_graph else 0.0)
    return dict(host=host, dev_all=len(spans_all),
                dev_graph=len(spans_graph), busy_all_us=_busy_us(spans_all),
                busy_graph_us=_busy_us(spans_graph), graph_span_us=span,
                sum_graph_us=sum(e - s for s, e in spans_graph),
                ours_all=ours_all, ours_graph=ours_graph)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--dist", action="store_true",
                    help="profile the distributed engine at world size 1 "
                         "over NCCL")
    ap.add_argument("--no-group", action="store_true",
                    help="with --dist: one rank and no process group")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_engine: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print("[card]", card, flush=True)

    from spring_tpu_torch.ops import kernels
    from spring_tpu_torch.reorder import engine as eng

    packed, lengths = make_reads(args.reads)
    if args.dist:
        import tempfile
        from spring_tpu_torch.parallel import dist, multihost
        store = tempfile.TemporaryDirectory(prefix="profile_store_")
        if args.no_group:
            world = multihost.World(None, 0, 1, torch.device("cuda", 0))
        else:
            world = multihost.initialize(
                0, 1, os.path.join(store.name, "s"), device="cuda")
        dcfg = dist.DistConfig(max_readlen=100)
        dist.DistReorderEngine(packed, lengths, dcfg, world=world).run()
        torch.cuda.synchronize()
        e = dist.DistReorderEngine(packed, lengths, dcfg, world=world)
        rows = multihost.put_sharded(world, e.packed)
        torch.cuda.synchronize()
        t = time.time()
        e._prog["build"](rows)                # dictionary build alone
        torch.cuda.synchronize()
        build_s = time.time() - t
        del rows
        wrapper, kernel_name = kernels.masked_hamming_rows, "masked_hamming"
        which = "dist-no-group" if args.no_group else "dist"
    else:
        cfg = eng.ReorderConfig(max_readlen=100)
        eng.ReorderEngine(packed, lengths, cfg, device="cuda").run()
        torch.cuda.synchronize()              # the warm-up run
        e = eng.ReorderEngine(packed, lengths, cfg, device="cuda")
        t = time.time()
        e.dicts                               # dictionary build alone
        torch.cuda.synchronize()
        build_s = time.time() - t
        e._dicts = None
        wrapper, kernel_name = kernels.verify_rows, "verify_rows"
        which = "engine"
    before = BEFORE[which]
    warm = dict(eng.LAST_RUN_STATS)
    wrapper.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        e.run()
        torch.cuda.synchronize()
        wall = time.time() - t
    stats = dict(eng.LAST_RUN_STATS)
    c = _trace_counts(prof.events(), kernel_name)
    calls = len(c["ours_all"])
    if calls != wrapper.launches or calls != stats["rounds_run"]:
        raise SystemExit(f"profile_torch_engine: the trace holds {calls} "
                         f"calls of the round's kernel, the wrapper "
                         f"counted {wrapper.launches}, the engine ran "
                         f"{stats['rounds_run']} rounds")
    graphed_rounds = stats["round_replays"]
    label = {"engine": "engine",
             "dist": "distributed engine, world size 1 over NCCL",
             "dist-no-group": "distributed engine, one rank, no group"}[which]

    def per_round(n):
        return f"{n / graphed_rounds:.2f}" if graphed_rounds else "n/a"

    def was(key, unit=""):
        v = before[key]
        return f"{v}{unit}" if v is not None else "not measured"

    print(f"[engine] {label}; warm-up run without the profiler: "
          f"{warm['rounds']} rounds, {warm['ms_per_round']} ms/round, "
          f"engine {warm['flush_wall_s']} s, program cache "
          f"{warm['program_cache']}, {warm['eager_rounds']} rounds called, "
          f"capture+instantiate {warm['capture_s']} s")
    print(f"[engine] {label}; {args.reads} reads: dict build "
          f"{build_s:.3f} s; run {wall:.3f} s, {stats['rounds']} rounds "
          f"({stats['rounds_run']} run, {stats['graphed_flushes']} of "
          f"{stats['flushes']} flushes graphed, {graphed_rounds} round "
          f"replays, program cache {stats['program_cache']}), "
          f"{stats['ms_per_round']} ms/round; capture+"
          f"instantiate {stats['capture_s']} s; graph pool "
          f"{stats['graph_pool_bytes']} bytes; kernel launches "
          f"{wrapper.launches}")
    print(f"[engine] host launch calls a graphed round (from the end of "
          f"the bind or the first capture on, over {graphed_rounds} "
          f"rounds): cudaGraphLaunch "
          f"{per_round(c['host']['cudaGraphLaunch'])}, cudaLaunchKernel "
          f"{per_round(c['host']['cudaLaunchKernel'])} (before: every "
          f"round eager, {was('launches_a_round')} launches a round)")
    print(f"[engine] device kernels: {c['dev_all']} in the run, "
          f"{c['dev_all'] / calls:.1f} a round over {calls} rounds run; "
          f"{c['dev_graph']} in the graphed part, "
          f"{per_round(c['dev_graph'])} a round")
    span = c["graph_span_us"]
    print(f"[engine] device busy (union of kernel spans) "
          f"{c['busy_all_us'] / 1e6:.3f} s of {wall:.3f} s wall "
          f"({100 * c['busy_all_us'] / 1e6 / wall:.1f}%); graphed part "
          f"{c['busy_graph_us'] / 1e6:.3f} s of its {span / 1e6:.3f} s "
          f"({100 * c['busy_graph_us'] / span if span else 0:.1f}%; its "
          f"kernel spans sum to {c['sum_graph_us'] / 1e6:.3f} s), "
          f"{c['busy_graph_us'] / 1e3 / max(graphed_rounds, 1):.3f} ms a "
          f"graphed round (before: {was('busy_pct', '%')} of the whole "
          f"run)")
    og = c["ours_graph"]
    print(f"[engine] round kernel {kernel_name}: {calls} calls, "
          f"{sum(c['ours_all']) / calls:.3f} us a call in all; inside the "
          f"graphs {len(og)} calls, "
          + (f"{sum(og) / len(og):.3f} us a call" if og else "none")
          + f" (before: {was('kernel_us_a_call', ' us')} a call, eager)")
    ka = prof.key_averages()
    table = ka.table(sort_by="self_device_time_total", row_limit=-1)
    os.makedirs(args.out, exist_ok=True)
    name = "dist_engine_ops.txt" if args.dist else "engine_ops.txt"
    with open(os.path.join(args.out, name), "w") as f:
        f.write(table)
    lines = table.splitlines()
    print("\n".join(lines[:25]))
    print("\n".join(ln for ln in lines
                    if kernel_name in ln or "nccl" in ln.lower()
                    or "cudaGraphLaunch" in ln or "cudaLaunchKernel" in ln))
    if args.dist:
        dev_rows = [k for k in ka if str(k.device_type).endswith("CUDA")]
        nccl = [k for k in dev_rows if "nccl" in k.key.lower()]
        print(f"[engine] NCCL kernels: {sum(k.count for k in nccl)} calls, "
              f"{sum(k.self_device_time_total for k in nccl) / 1e3:.3f} ms "
              f"device in all; collectives counted by the world: "
              f"{stats['collectives']}, {stats['collectives_per_round']} a "
              f"round")
        multihost.shutdown()
        store.cleanup()
    print(f"[engine] on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
