#!/usr/bin/env python3
"""Device ms a round of the reorder engine's flush, a static variant each.

    python tools/knob_sweep_torch.py [n_reads] [variant ...]
        [--device cuda|cpu] [--fastq F] [--seed 42] [--cache DIR]
        [--threads T] [--out FILE]

The PyTorch port's counterpart of tools/knob_sweep.py, against the
engine as it is now (spring_tpu_torch/reorder/engine.py). A variant is
``baseline`` or ``k=v[,k=v]`` over ReorderConfig fields (``candidates``
too, which CompressOptions.engine does not set); the default list is
tools/knob_sweep.py's: baseline, accept_slots=8, accept_slots=32,
shift_chunk=8, candidates=4.

Input: --fastq F, else tools/knob_sweep.py's: synth.make_se(n_reads)
(100 bp reads of a 2,000,000-base genome, --seed 42; made by
synth.make_se_fast, the same bytes), parsed by the port's io and packed
to 2 bits; the packed rows of a made input are kept in --cache (default:
the temporary directory) as knob_sweep_torch_<n>_seed<s>.npz. Every
read goes to the engine, as in tools/knob_sweep.py.

Each variant, on --device (default cuda; with no card the tool fails, it
never moves to the CPU):
  1. the setup of ReorderEngine.run: the engine, its start state, the
     row table, the read dictionaries, their stacked tables and pair
     rows, the strided seed order;
  2. the variant's FlushRunner from engine._flush_program(...)[-1];
  3. three flushes, the device synchronised before and after each. The
     first calls one round and captures the round and the compaction
     (on the card; the CPU calls every step); the second and third only
     replay. ``ms_a_round`` is their mean seconds over the flush's
     rounds: the device's time for a replayed round plus its share of
     the compaction. ``claimed`` is the claimed reads after the third
     flush (stats[0] - (Np - N), as tools/knob_sweep.py reports);
     ``stats`` each flush's four (claimed bits, queue position, active
     walkers, emitted rows);
  4. ReorderEngine.run() on the same input and variant (a program-cache
     miss): rounds, rounds run, engine seconds and ms_per_graphed_round
     (the host clock over the replayed rounds) from LAST_RUN_STATS, and
     ``host_over_device``, that over ms_a_round.
The runner and the engine's program are freed before the next variant.
Only whole flushes are timed: a round graph replayed outside flush()
would write past the runner's emission stack.

Standard output: first a JSON line with the card's name and power limit
(nvidia-smi; null on the CPU) and the input, then one JSON line a
variant (each also appended to --out FILE); progress on stderr. Imports
neither JAX nor the JAX package.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEED = 42
GENOME = 2_000_000
READ_LEN = 100
FLUSHES = 3
DEFAULT_VARIANTS = ("baseline", "accept_slots=8", "accept_slots=32",
                    "shift_chunk=8", "candidates=4")
# the JAX package's environment variables for ReorderConfig fields
# (spring_tpu/pipeline/short_mode.py:439-442, spring_tpu/reorder/engine.py
# :53, :62, :509): the port sets the fields themselves
ENV_KEYS = {"SPRING_TPU_FARDICT": "far_near", "SPRING_TPU_SC": "shift_chunk",
            "SPRING_TPU_SLOTS": "accept_slots",
            "SPRING_TPU_WALKERS": "num_walkers",
            "SPRING_TPU_CAP_PER_ROUND": "cap_per_round",
            "SPRING_TPU_REBUILD_FRACTION": "rebuild_fraction",
            "SPRING_TPU_FLUSH_ROUNDS": "flush_rounds"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def config_value(key, val, allowed):
    """``val`` (a string) as the ReorderConfig field ``key``'s type;
    ValueError for a key outside ``allowed`` (a JAX variable name is
    told its key) or a value of the wrong type."""
    from spring_tpu_torch.reorder.engine import ReorderConfig
    if key in ENV_KEYS:
        raise ValueError(f"{key} is the JAX package's environment variable;"
                         f" the port's key is {ENV_KEYS[key]}")
    if key not in allowed:
        raise ValueError(f"unknown key {key!r}; known: {sorted(allowed)}")
    kind = {f.name: f.type for f in dataclasses.fields(ReorderConfig)}[key]
    if kind == "bool":
        if val.lower() not in ("0", "1", "false", "true"):
            raise ValueError(f"{key} takes 0/1/true/false, not {val!r}")
        return val.lower() in ("1", "true")
    try:
        return float(val) if kind == "float" else int(val)
    except ValueError:
        raise ValueError(f"{key} takes a {kind} value, not {val!r}") from None


def parse_variant(spec):
    """``baseline`` -> {}; ``k=v[,k=v]`` -> ReorderConfig overrides."""
    from spring_tpu_torch.reorder.engine import ReorderConfig
    if spec == "baseline":
        return {}
    allowed = {f.name for f in dataclasses.fields(ReorderConfig)
               } - {"max_readlen"}
    kw = {}
    for kv in spec.split(","):
        k, sep, v = kv.partition("=")
        if not sep or not v:
            raise ValueError(f"variant {spec!r}: want k=v[,k=v]")
        kw[k] = config_value(k, v, allowed)
    return kw


def load_input(n, fastq, seed, cache, threads):
    """(packed (N, W) uint32 rows, lengths, maxlen, where from)."""
    from spring_tpu_torch.io import fastq_native
    path = None
    if not fastq:
        os.makedirs(cache, exist_ok=True)
        path = os.path.join(cache, f"knob_sweep_torch_{n}_seed{seed}.npz")
        if os.path.exists(path):
            d = np.load(path)
            return (d["packed"], d["lengths"], int(d["maxlen"]),
                    dict(made=n, seed=seed, cached=path))
    t = time.time()
    src = fastq
    tmp = None
    if not fastq:
        from spring_tpu_torch.utils import synth
        tmp = tempfile.mkdtemp(prefix="knob_sweep_torch_")
        src = os.path.join(tmp, "in.fastq")
        synth.make_se_fast(src, n, read_len=READ_LEN, genome_size=GENOME,
                           seed=seed, workers=threads)
    try:
        arrs = fastq_native.load_file(src, want_quals=False)
    finally:
        if tmp:
            os.remove(src)
            os.rmdir(tmp)
    packed = fastq_native.pack_2bit(arrs.codes, threads)
    lengths = np.ascontiguousarray(arrs.lengths, np.int32)
    where = dict(fastq=fastq) if fastq else dict(made=n, seed=seed)
    where["load_s"] = round(time.time() - t, 3)
    if path:
        np.savez(path, packed=packed, lengths=lengths, maxlen=arrs.maxlen)
    return packed, lengths, arrs.maxlen, where


def flush_variant(packed, lengths, maxlen, kw, device):
    """The variant's flushes from ReorderEngine.run's start (steps 1-3 of
    the module docstring): its shape, the first flush's seconds, capture
    and pool, each later flush's seconds, ms_a_round, claimed and each
    flush's stats."""
    import torch
    from spring_tpu_torch.reorder import dictionary as dct
    from spring_tpu_torch.reorder import engine as eng
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = eng.ReorderConfig(max_readlen=maxlen, **kw)
    e = eng.ReorderEngine(packed, lengths, cfg, device=dev)
    state = e._init_state()
    rows_tab = state.pop("rows")
    e._build_dicts(rows_tab)
    dkeys = torch.cat([d.btab for d in e._dicts], dim=0)
    pairs_all = torch.cat([dct.pairs_from_rids(d.rids) for d in e._dicts],
                          dim=0)
    stride = max(e.N // e.B, 1)
    idx = np.arange(e.N, dtype=np.int32)
    so = (np.concatenate([idx[r::stride] for r in range(stride)])
          if e.N else idx)
    so = np.concatenate([so, np.full(e.Np - len(so), e.Np - 1, np.int32)])
    seed_order = torch.as_tensor(so.astype(np.int32), device=dev)
    starts = tuple(w.start for w in e.windows)
    _, _, cap, make_runner = eng._flush_program(
        e.Np, cfg.candidates, cfg.shift_chunk, cfg.accept_slots, starts,
        cfg.thresh, cfg.far_near, cfg.cap_per_round, cfg.flush_rounds)
    runner = make_runner(state, e.lengths, dkeys, pairs_all, seed_order,
                         e.N, cfg.max_shift, rows_tab)
    del state, dkeys, pairs_all, seed_order, rows_tab
    e._dicts = None
    rec = dict(B=e.B, Np=e.Np, N=e.N, SC=cfg.shift_chunk,
               M=runner._ys.shape[2] - 1, C=cfg.candidates, cap=cap,
               flush_rounds=cfg.flush_rounds)
    secs, stats = [], []
    try:
        for _ in range(FLUSHES):
            sync()
            t = time.perf_counter()
            _, _, st = runner.flush()
            sync()
            secs.append(time.perf_counter() - t)
            stats.append([int(x) for x in st.cpu()])
        captured = runner.capture_s is not None
        rec.update(
            first_flush_s=round(secs[0], 4),
            capture_s=round(runner.capture_s, 4) if captured else None,
            graph_pool_bytes=runner.pool_bytes if captured else None,
            flush_s=[round(s, 6) for s in secs[1:]],
            ms_a_round=round(1000 * float(np.mean(secs[1:]))
                             / cfg.flush_rounds, 4),
            claimed=stats[-1][0] - (e.Np - e.N), stats=stats)
    finally:
        runner.free()
        e.release()
        if cuda:
            torch.cuda.empty_cache()
    return rec


def engine_variant(packed, lengths, maxlen, kw, device):
    """ReorderEngine.run() of the variant (step 4): its LAST_RUN_STATS
    numbers; the program it leaves in the cache is freed."""
    import torch
    from spring_tpu_torch.ops import graphs
    from spring_tpu_torch.reorder import engine as eng
    dev = torch.device(device)
    e = eng.ReorderEngine(packed, lengths,
                          eng.ReorderConfig(max_readlen=maxlen, **kw),
                          device=dev)
    try:
        t = time.perf_counter()
        e.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        s = dict(eng.LAST_RUN_STATS)
    finally:
        e.release()
        graphs.clear_program_cache()
    return dict(rounds=s["rounds"], rounds_run=s["rounds_run"],
                engine_s=s["flush_wall_s"], run_s=round(wall, 4),
                ms_per_round=s["ms_per_round"],
                ms_per_graphed_round=s["ms_per_graphed_round"],
                round_replays=s["round_replays"],
                eager_rounds=s["eager_rounds"],
                program_cache=s["program_cache"], emitted=s["emitted"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=1_000_000)
    ap.add_argument("variants", nargs="*",
                    help="baseline or k=v[,k=v] over ReorderConfig fields")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fastq", default=None,
                    help="input FASTQ (default: the made input)")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--cache", default=tempfile.gettempdir())
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    specs = a.variants or list(DEFAULT_VARIANTS)
    try:
        variants = [(s, parse_variant(s)) for s in specs]
    except ValueError as e:
        ap.error(str(e))
    import torch
    dev = torch.device(a.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("knob_sweep_torch: no CUDA device; pass --device "
                         "cpu for a CPU run")
    card = card_line() if cuda else None
    kind = torch.cuda.get_device_name(dev) if cuda else None
    packed, lengths, maxlen, where = load_input(
        a.n_reads, a.fastq, a.seed, a.cache, a.threads)
    head = dict(tool="knob_sweep_torch", card=card, kind=kind,
                device=a.device, reads=int(len(lengths)), maxlen=maxlen,
                input=where)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")

    emit(head)
    for name, kw in variants:
        log(f"[{name}] flushes ...")
        rec = dict(variant=name, config=kw)
        rec.update(flush_variant(packed, lengths, maxlen, kw, dev))
        log(f"[{name}] B={rec['B']} SC={rec['SC']} M={rec['M']} "
            f"C={rec['C']}: {rec['ms_a_round']} ms a round, claimed "
            f"{rec['claimed']}; engine run ...")
        rec.update(engine_variant(packed, lengths, maxlen, kw, dev))
        mpg = rec["ms_per_graphed_round"]
        rec["host_over_device"] = (round(mpg / rec["ms_a_round"], 4)
                                   if mpg and rec["ms_a_round"] else None)
        rec.update(card=card, device=a.device)
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.modules["jax"] = None           # the port runs without JAX
    sys.modules["spring_tpu"] = None
    sys.exit(main())
