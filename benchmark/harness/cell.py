"""One run of one cell: set-up, the measured window, then the check.

Set-up makes the cell's input from the seed (in a thread, while the
program is imported and the device's context made), then compresses it
once: the program's native builds, its first flush and its CUDA graph
capture, which every later compress of the same shapes finds cached.
The window then runs whole compresses of that input back to back, one at
a time (a closed loop with one client), and starts no compress once
``seconds`` have passed. After the window every archive it wrote is
decompressed on the host clock, one at a time, and each distinct one is
held to the configuration's guarantee by reference/records.py.

The program is reached only through ``spring_tpu_torch.api`` and its
counters ``pipeline.short_mode.LAST_STAGE_SECONDS`` and
``reorder.engine.LAST_RUN_STATS``; a counter that is gone reads as
empty, and the metrics that read it are left out.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from reference import records

from . import spec as specs
from . import synth
from .trace import Profiler

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "spring_tpu")
LIMIT = 0       # every number the check compares is a count of faults


def block_forbidden() -> None:
    """Make an import of the JAX package or of JAX fail (as
    bench_torch.py does), before torch is imported."""
    for name in FORBIDDEN:
        sys.modules[name] = None


def loaded_forbidden() -> list:
    """Forbidden top-level names that sys.modules holds a module of,
    compared whole (``spring_tpu_torch`` is not ``spring_tpu``)."""
    return sorted({k.split(".")[0] for k, v in list(sys.modules.items())
                   if v is not None and k.split(".")[0] in FORBIDDEN})


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    workload: dict
    config: dict
    traffic: dict
    reads: int                      # reads a compress
    bases: int                      # bases a compress
    setup_s: float = 0.0
    compresses: list = field(default_factory=list)
    window_s: float = 0.0           # window start to the last one's end
    peak_reserved_bytes: int | None = None    # the window's first compress
    decompress_s: float = 0.0       # every window archive read back
    decompressed: int = 0           # archives read back
    trace: object = None            # trace.Trace of a traced run

    def stage_s(self, *names: str) -> float | None:
        """Mean seconds a compress of the stages named (a name that ends
        in ``[`` takes every stage it begins), None where no compress
        marked any of them."""
        per = []
        for c in self.compresses:
            got = [v for k, v in c["stages"].items()
                   if any(k == n or (n.endswith("[") and k.startswith(n))
                          for n in names)]
            if got:
                per.append(sum(got))
        return sum(per) / len(per) if per else None

    def engine(self, key: str) -> list:
        """The engine's counter ``key`` of each compress that has it."""
        return [c["engine"][key] for c in self.compresses
                if c["engine"].get(key) is not None]


def _counters() -> dict:
    """Copies of the program's counters of its last compress."""
    out = {"stages": {}, "engine": {}}
    try:
        from spring_tpu_torch.pipeline import short_mode
        out["stages"] = dict(short_mode.LAST_STAGE_SECONDS)
    except (ImportError, AttributeError):
        pass
    try:
        from spring_tpu_torch.reorder import engine
        out["engine"] = dict(engine.LAST_RUN_STATS)
    except (ImportError, AttributeError):
        pass
    return out


def _digest(path: str) -> str:
    if not os.path.exists(path):
        return "missing"
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest(config: dict, traffic: dict, reads: int) -> dict:
    """What the archive's manifest must state under the guarantee."""
    g = config["guarantee"]
    out = {"paired_end": traffic["mates"] == 2,
           "preserve_order": g["order"], "preserve_id": g["ids"],
           "num_reads": reads}
    if g["qualities"]:
        out.update(preserve_quality=True, quality_mode="lossless")
    return out


def _decompress(api, arc: str, outputs: list, num_threads: int):
    """Decompress ``arc`` into ``outputs``: the seconds on the host clock,
    or None where it cannot be read back (a fault of the program)."""
    t = time.perf_counter()
    try:
        api.decompress(arc, outputs, num_threads=num_threads, verbose=False)
    except Exception:
        log(f"[check] {arc} cannot be read back:\n{traceback.format_exc()}")
        return None
    return time.perf_counter() - t


def _held(arc: str, read_back: bool, inputs: list, outputs: list,
          guarantee: dict, expect: dict) -> dict:
    """The numbers of ``arc`` held to the guarantee; an archive that was
    not read back counts as ``unreadable`` with every record missing."""
    if not read_back:
        return {"unreadable": 1, "records_missing": expect["num_reads"],
                "flags_wrong": records.manifest_wrong(arc, expect)}
    return {"unreadable": 0,
            **records.compare(inputs, outputs, guarantee),
            "flags_wrong": records.manifest_wrong(arc, expect)}


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", root: str = specs.ROOT,
        t_start: float | None = None, override: dict | None = None,
        warm: bool = True):
    """Run one cell with the configuration's options (``override`` laid
    over them); ``warm=False`` leaves out the warm-up compress. Returns
    (Run, checks, outcome): checks maps each number compared to (value,
    limit); outcome has ``correct``, ``attempted`` (compresses in the
    window), ``failed`` (those whose archive failed the check) and
    ``peak`` (the process's reserved device peak)."""
    t_start = time.time() if t_start is None else t_start
    cell = specs.cell(specs.load(root), workload, root)
    config, traffic = cell["config"], cell["traffic"]
    reads = traffic["pairs"] * traffic["mates"]
    run_ = Run(workload=cell["workload"], config=config, traffic=traffic,
               reads=reads, bases=reads * traffic["read_len"])
    work = tempfile.mkdtemp(prefix="spring_bench_")
    try:
        return _run(run_, work, seed, seconds, traced, device, t_start,
                    override or {}, warm)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(run_, work, seed, seconds, traced, device, t_start, override,
         warm):
    config, traffic = run_.config, run_.traffic
    mates = traffic["mates"]
    inputs = [os.path.join(work, f"in_{m}.fastq")
              for m in range(1, mates + 1)]
    outputs = [os.path.join(work, f"out_{m}.fastq")
               for m in range(1, mates + 1)]
    with ThreadPoolExecutor(max_workers=1) as ex:
        gen = ex.submit(synth.generate, traffic, seed, inputs)
        import torch
        from spring_tpu_torch import api
        cuda = device.startswith("cuda")
        if cuda:
            torch.cuda.init()
            torch.ones(1, device=device).sum().item()
        gen.result()
    opts = api.CompressOptions(**{**config["options"], **override},
                               verbose=False)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if warm:
        # builds, the first flush and the graph capture
        arc = os.path.join(work, "warm.stpu")
        t = time.perf_counter()
        api.compress(inputs, arc, opts, device=device)
        sync()
        log(f"[setup] warm-up compress {time.perf_counter() - t:.3f} s "
            f"{json.dumps(_counters(), default=str)}")
        os.unlink(arc)
    prof = None
    if traced:
        Profiler.warm(torch, device)
        prof = Profiler(torch, device)
    if cuda:
        setup_peak = torch.cuda.max_memory_reserved(device)
        torch.cuda.reset_peak_memory_stats(device)
    run_.setup_s = time.time() - t_start

    runs = run_.compresses
    with prof if prof is not None else contextlib.nullcontext():
        start = time.perf_counter()
        while not runs or time.perf_counter() - start < seconds:
            arc = os.path.join(work, f"window_{len(runs)}.stpu")
            t = time.perf_counter()
            with (prof.compress() if prof is not None
                  else contextlib.nullcontext()):
                api.compress(inputs, arc, opts, device=device)
                sync()
            end = time.perf_counter()
            if cuda and not runs:
                # one compress's peak: later ones in the same process
                # add to what the allocator holds (PERF.md)
                run_.peak_reserved_bytes = torch.cuda.max_memory_reserved(
                    device)
            runs.append(dict(seconds=end - t, archive=arc,
                             reserved=(torch.cuda.memory_reserved(device)
                                       if cuda else None),
                             archive_bytes=(os.path.getsize(arc)
                                            if os.path.exists(arc) else 0),
                             **_counters()))
        run_.window_s = end - start
    window_peak = torch.cuda.max_memory_reserved(device) if cuda else None
    for i, c in enumerate(runs):
        log(f"[window] compress {i}: {c['seconds']:.4f} s, "
            f"{c['archive_bytes']} B, reserved {c['reserved']} "
            f"{json.dumps(c['stages'])} "
            f"{json.dumps(c['engine'], default=str)}")
    if prof is not None:
        t = time.perf_counter()
        run_.trace = prof.read([c["stages"] for c in runs])
        log(f"[trace] {len(run_.trace.ops)} device operations read in "
            f"{time.perf_counter() - t:.3f} s")

    # after the window every archive it wrote is decompressed on the host
    # clock, the last first; the first of each distinct archive is held
    # to the guarantee (the others are the same bytes)
    checks: dict = {}
    held: dict = {}
    failed = 0
    t_check = time.perf_counter()
    expect = _manifest(config, traffic, run_.reads)
    for c in reversed(runs):
        secs = _decompress(api, c["archive"], outputs, opts.num_threads)
        if secs is not None:
            run_.decompress_s += secs
            run_.decompressed += 1
        key = (_digest(c["archive"]), secs is not None)
        if key not in held:
            held[key] = _held(c["archive"], secs is not None, inputs,
                              outputs, config["guarantee"], expect)
            for k, v in held[key].items():
                checks[k] = checks.get(k, 0) + v
        if any(v > LIMIT for v in held[key].values()):
            failed += 1
        for p in outputs:
            if os.path.exists(p):
                os.unlink(p)
    log(f"[check] {run_.decompressed} of {len(runs)} archive(s) read back "
        f"in {run_.decompress_s:.3f} s, {len(held)} distinct held to the "
        f"guarantee; {time.perf_counter() - t_check:.3f} s in all")
    for c in runs:
        if os.path.exists(c["archive"]):
            os.unlink(c["archive"])
    checks = {k: (v, LIMIT) for k, v in checks.items()}
    result = dict(correct=failed == 0, attempted=len(runs), failed=failed,
                  peak=max(setup_peak, window_peak) if cuda else None)
    return run_, checks, result


def result_line(run_: Run, checks: dict, outcome: dict, metrics: list,
                device: str, chips: int, root: str = specs.ROOT) -> dict:
    """The contract's result object: every metric in ``metrics`` that
    its reader finds, the device, the breakdown of a traced run, and the
    numbers compared beside their limits, last."""
    got = {}
    for m in metrics:
        v = specs.reader(m["name"], root).read(run_)
        if v is not None:
            got[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": None, "count": chips, "memory_peak_bytes": None}
    if device.startswith("cuda"):
        import torch
        dev["kind"] = torch.cuda.get_device_name(device)
        dev["memory_peak_bytes"] = outcome["peak"]
    out = dict(correct=outcome["correct"], attempted=outcome["attempted"],
               failed=outcome["failed"], metrics=got, device=dev)
    if run_.trace is not None:
        dev["busy_s"] = run_.trace.busy_s
        dev["window_s"] = run_.trace.window_s
        out["breakdown"] = {"device_ops": run_.trace.device_ops(),
                            "idle_gaps": run_.trace.idle_by_stage()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
