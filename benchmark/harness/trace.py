"""The traced run's profile: device spans from torch.profiler, the
compress ranges they fall in, and the breakdown of both.

``busy_us`` is a frozen copy of tools/profile_torch_engine.py::_busy_us
as of commit b2b9e62. Stage labels come from laying a compress's
``LAST_STAGE_SECONDS`` (the program's host clock at each stage's end)
end to end from the compress's start: approximate, since those marks
do not wait for the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

RANGE = "bench::compress"
NAME_CHARS = 120         # a device operation's name in the breakdown


def busy_us(spans) -> float:
    """Length of the union of (start, end) spans: time the device ran at
    least one kernel (the profiler's kernel spans may overlap)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _union(spans) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class Trace:
    """Device operations (name, start_us, end_us) and the compress
    ranges (start_us, end_us) of the traced window, on one clock."""
    ops: list
    compresses: list
    stages: list = field(default_factory=list)   # a dict per compress

    @property
    def window_s(self) -> float:
        """From the first compress's start to the last one's end."""
        return (self.compresses[-1][1] - self.compresses[0][0]) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        lo, hi = self.compresses[0][0], self.compresses[-1][1]
        return busy_us((max(s, lo), min(e, hi)) for _, s, e in self.ops
                       if e > lo and s < hi) / 1e6

    def kernels(self, part: str) -> list:
        """Durations (us) of the device operations whose name holds
        ``part``."""
        return [e - s for n, s, e in self.ops if part in n]

    def device_ops(self, top: int = 10) -> list:
        """Device seconds by operation (names cut to NAME_CHARS), largest
        first."""
        tot: dict = {}
        for n, s, e in self.ops:
            n = n[:NAME_CHARS]
            tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        return sorted(([n, t] for n, t in tot.items()),
                      key=lambda x: -x[1])[:top]

    def idle_by_stage(self, top: int = 10) -> list:
        """Idle device seconds inside the compresses by the stage the
        host was in, largest first."""
        busy = _union((s, e) for _, s, e in self.ops)
        tot: dict = {}
        for (c0, c1), stages in zip(self.compresses, self.stages):
            marks, t = [], c0
            for name, sec in stages.items():
                marks.append((t, t + sec * 1e6, name))
                t += sec * 1e6
            marks.append((t, max(t, c1), "after_stages"))
            gaps, t = [], c0
            for s, e in busy:
                if e <= c0 or s >= c1:
                    continue
                if s > t:
                    gaps.append((t, s))
                t = max(t, e)
            if t < c1:
                gaps.append((t, c1))
            for g0, g1 in gaps:
                for m0, m1, name in marks:
                    lap = min(g1, m1) - max(g0, m0)
                    if lap > 0:
                        tot[name] = tot.get(name, 0.0) + lap / 1e6
        return sorted(([n, t] for n, t in tot.items()),
                      key=lambda x: -x[1])[:top]


class Profiler:
    """torch.profiler over the window, a record_function range a
    compress."""

    def __init__(self, torch, device):
        from torch.profiler import profile
        self._torch = torch
        self._prof = profile(activities=_activities(device))

    @staticmethod
    def warm(torch, device) -> None:
        """A short profile of one operation: the profiler's own start-up
        (CUPTI's included) then happens in set-up."""
        from torch.profiler import profile
        with profile(activities=_activities(device)):
            torch.ones(1024, device=device).sum().item()

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def compress(self):
        return self._torch.profiler.record_function(RANGE)

    def read(self, stages: list) -> Trace:
        """The window's device operations and compress ranges, from the
        profiler's raw events (building its event tree takes 75 times
        longer)."""
        ops, comp = [], []
        for e in self._prof.profiler.kineto_results.events():
            name, s = e.name(), e.start_ns() / 1e3
            t = s + e.duration_ns() / 1e3
            on_device = str(e.device_type()).endswith("CUDA")
            if name == RANGE and not on_device:
                comp.append((s, t))
            elif on_device and not e.is_user_annotation() and name != RANGE:
                ops.append((name, s, t))
        comp.sort()
        return Trace(ops=ops, compresses=comp, stages=stages)


def _activities(device) -> list:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return acts
