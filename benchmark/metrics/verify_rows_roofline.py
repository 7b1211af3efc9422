"""Layer kernel: the reorder round's fused verify (``verify_rows_kernel``
of csrc/masked_hamming.cu) as a share of its roofline, in %: the least
time of one launch at the run's round shape (harness/roofline.py) over
the launch's mean device time in the profiler's trace. B is the
engine's walkers, W the packed words of the longest read, M the
candidate slots a walker: the program's ReorderConfig defaults under the
configuration's engine settings, as the engine's _flush_program takes
them (GSEL = accept_slots // candidates probe groups of ``candidates``,
for the 16 or more shifts a round probes). The bound leaves out the
frames' bytes, so the share is a lower bound of the true one."""
import dataclasses

from harness import roofline

KERNEL = "verify_rows_kernel"


def _slots(engine_cfg: dict):
    try:
        from spring_tpu_torch.reorder.engine import ReorderConfig
    except ImportError:
        return None
    cfg = {f.name: f.default for f in dataclasses.fields(ReorderConfig)
           if f.default is not dataclasses.MISSING}
    cfg.update(engine_cfg)
    c = cfg.get("candidates")
    a = cfg.get("accept_slots")
    if not c or not a:
        return None
    return max(1, a // c) * c


def read(run):
    tr = run.trace
    if tr is None:
        return None
    times = tr.kernels(KERNEL)
    walkers = run.engine("walkers")
    M = _slots(run.config["options"].get("engine", {}))
    if not times or not walkers or M is None:
        return None
    W = -(-run.traffic["read_len"] // roofline.BASES_PER_WORD)
    b = roofline.verify_rows_bound(max(walkers), M, W)
    return 100 * b["bound_s"] / (sum(times) / len(times) / 1e6)
