#!/usr/bin/env python3
"""The benchmark of spring_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Runs one cell of BENCHMARK.json on the CUDA card(s) of this machine
(harness/cell.py) and prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``, then ``checks``: each number the
check compared beside its limit, which also end standard error. Exits
with another code than 0, and prints no result, where torch sees no CUDA
card or fewer than the cell asks for, and where a module of JAX or of
the JAX package is loaded once the window has closed.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def caches(root: str) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    base = os.path.join(root, os.path.basename(BENCH), ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(args, device: str, root: str = ROOT) -> int:
    """Run the cell on ``device`` and print its result; the rest of a run
    once the look for a card has passed."""
    from harness import cell, spec
    entry = spec.cell(spec.load(root), args.workload, root)
    chips = entry["workload"]["chips"]
    run_, checks, outcome = cell.run(args.workload, args.seed, args.seconds,
                                     bool(args.trace), device=device,
                                     root=root, t_start=T_START)
    bad = cell.loaded_forbidden()
    if bad:
        cell.log(f"run: modules of {bad} are loaded; the port runs "
                 "without JAX and the JAX package")
        return 3
    metrics = entry["per_layer"] if args.trace else entry["end_to_end"]
    out = cell.result_line(run_, checks, outcome, metrics, device, chips,
                           root)
    for k, c in out["checks"].items():
        cell.log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(1, ROOT)          # the program, beside the benchmark
    from harness import cell, spec
    cell.block_forbidden()
    caches(ROOT)
    chips = spec.cell(spec.load(ROOT), args.workload,
                      ROOT)["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        cell.log(f"run: the cell needs {chips} CUDA card(s); torch sees "
                 f"{torch.cuda.device_count()}")
        return 2
    return report(args, "cuda:0")


if __name__ == "__main__":
    sys.exit(main())
