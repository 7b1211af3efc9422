#!/usr/bin/env python3
"""The check's readings over many seeds, on the chip: the program's, and
the control's (the configuration's ``control`` options, its lossy step,
in the program's place).

    python3 benchmark/control.py --workload <name> --seeds 1,2,3
                                 [--control] [--seconds 0]

Each seed makes the cell's input at its full size, runs a window of
``--seconds`` (0: one compress, no warm-up after the first seed) and
prints one JSON line: the seed, whether it was the control, ``correct``
and every number compared. The benchmark's own runs do not run this; its
readings set the limits (PERF.md).
"""
import json
import sys

import run


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(1, run.ROOT)
    from harness import cell, spec
    cell.block_forbidden()
    run.caches(run.ROOT)
    import torch
    if not torch.cuda.is_available():
        cell.log("control: needs a CUDA card")
        return 2
    config = spec.cell(spec.load(run.ROOT), args.workload, run.ROOT)["config"]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        _, checks, outcome = cell.run(
            args.workload, seed, args.seconds, False, device="cuda:0",
            override=config["control"] if args.control else None,
            warm=i == 0)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": outcome["correct"],
                          "checks": {k: v for k, (v, _) in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
