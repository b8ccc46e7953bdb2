"""A torch.profiler Chrome trace, reduced to what the readers need.

The traced run captures a few whole jobs with the program's own
``utils.tracing.profile_trace`` (every thread of the process: the jobs
run on scheduler lane threads) and marks each job with a
``sortbench:job`` range.  The program marks its phases ``dsort:<phase>``.
Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events.  Times are seconds on the trace's clock.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict

from sortbench.yardstick import gaps, overlap, union_length

JOB_RANGE = "sortbench:job"
PHASE_PREFIX = "dsort:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COPY_DIRECTIONS = ("HtoD", "DtoH")
TOP = 10  # entries in each list of the breakdown
NAME_CHARS = 160  # a kernel's name in the breakdown is cut to this


@dataclasses.dataclass
class Trace:
    jobs: list  # (start, end) of each captured job, in order
    device: list  # (cat, name, start, end) of each device operation
    phases: list  # (name, start, end) of each dsort:<phase> range

    @property
    def window(self) -> tuple[float, float]:
        return self.jobs[0][0], self.jobs[-1][1]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def intervals(self, cats=DEVICE_CATS, names=None) -> list:
        """Device intervals of the categories ``cats`` (and, where given,
        whose name holds one of ``names``) inside the window."""
        lo, hi = self.window
        return [
            (s, e) for cat, name, s, e in self.device
            if cat in cats and e > lo and s < hi and (names is None or any(n in name for n in names))
        ]

    def busy_s(self, cats=DEVICE_CATS, names=None) -> float:
        """Time in the window in which any such operation ran (a union)."""
        return union_length(self.intervals(cats, names), *self.window)

    def jobs_without_kernel(self) -> list[int]:
        """Captured jobs (by their order) in which no kernel started."""
        starts = [s for cat, _, s, _ in self.device if cat == "kernel"]
        return [i for i, (lo, hi) in enumerate(self.jobs) if not any(lo <= s < hi for s in starts)]

    def device_ops(self, top: int = TOP) -> list:
        """``[name, seconds]`` of the device operations that took most time
        in the window, summed by name (a kernel's argument list dropped)."""
        lo, hi = self.window
        by_name: dict[str, float] = defaultdict(float)
        for cat, name, s, e in self.device:
            if e > lo and s < hi:
                by_name[short_name(name) if cat == "kernel" else name] += min(e, hi) - max(s, lo)
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]

    def idle_by_phase(self, top: int = TOP) -> list:
        """``[host range, seconds]``: the device's idle time in the window,
        split by the ``dsort:<phase>`` range the host was in (what no phase
        covers goes to ``outside dsort phases``), longest first."""
        idle = gaps(self.intervals(), *self.window)
        ranges: dict[str, list] = defaultdict(list)
        for name, s, e in self.phases:
            ranges[name].append((s, e))
        rows = {name: overlap(idle, ivs) for name, ivs in ranges.items()}
        rows["outside dsort phases"] = max(sum(e - s for s, e in idle) - sum(rows.values()), 0.0)
        return sorted(([k, v] for k, v in rows.items() if v > 0), key=lambda kv: -kv[1])[:top]


def short_name(kernel: str) -> str:
    """A kernel's name without its argument list (the last parenthesised
    group at the top level; ``(anonymous namespace)`` stays), cut to
    ``NAME_CHARS``: torch's kernels carry whole lambda signatures."""
    name = kernel.strip()
    depth = 0
    for i in range(len(name) - 1, -1, -1) if name.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            name = name[:i].strip() or name
            break
    return name[:NAME_CHARS]


def read(path) -> Trace:
    """Parse the Chrome trace ``profile_trace`` wrote."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    jobs, device, phases = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((cat, name, s, e))
        elif cat == "user_annotation":
            if name == JOB_RANGE:
                jobs.append((s, e))
            elif name.startswith(PHASE_PREFIX):
                phases.append((name, s, e))
    jobs.sort()
    return Trace(jobs, device, phases)
