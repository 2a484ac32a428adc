"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over the
tail of the window, read into device intervals by name and the harness's
and engine's host spans.

The slice opens at the first step boundary at or after ``tail_s`` seconds
before the window's end and stays open through the drain; the profiler is
stopped and read once serving is over, since stopping it takes seconds
that would otherwise fall inside the window. Only whole steps are
profiled, so every kernel in the trace belongs to a step of the slice.
"""
from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


@dataclasses.dataclass
class TraceData:
    device_ops: List[Tuple[str, int, int]]      # (name, start ns, end ns)
    spans: List[Tuple[str, int, int]]           # host spans, same clock
    t0: int                                     # the slice, ns
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        iv = sorted((max(a, self.t0), min(b, self.t1))
                    for _, a, b in self.device_ops
                    if b > self.t0 and a < self.t1)
        out: List[List[int]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.device_ops if rx.search(n)) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, int] = defaultdict(int)
        for name, a, b in self.device_ops:
            tot[short(name)] += b - a
        return [[k, v / 1e9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle device time within the slice, summed by the innermost host
        span that was open at each gap's midpoint."""
        busy = self.busy_intervals()
        edges = np.asarray([self.t0] + [x for iv in busy for x in iv]
                           + [self.t1], np.int64)
        a, b = edges[::2], edges[1::2]
        keep = b > a
        a, b = a[keep], b[keep]
        mids = (a + b) // 2          # ascending: the gaps do not overlap
        names = ["host.other"]
        who = np.zeros(len(mids), np.int64)
        # longest span first, so the innermost one is written last
        for name, s, e in sorted(self.spans, key=lambda x: x[1] - x[2]):
            lo, hi = np.searchsorted(mids, [s, e])
            if hi > lo:
                names.append(name)
                who[lo:hi] = len(names) - 1
        tot: Dict[str, int] = defaultdict(int)
        for i, dur in zip(who.tolist(), (b - a).tolist()):
            tot[names[i]] += dur
        return [[k, v / 1e9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1e3)


def read(prof) -> Tuple[List, List]:
    """(device ops, host spans) of a stopped profiler: the device's kernels,
    copies and sets (not the host spans' projections onto its timeline),
    and the harness's and engine's spans."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and (name.startswith(("bench.", "engine."))
                          or getattr(e, "is_user_annotation",
                                     lambda: False)()):
            continue
        if not on_device and not name.startswith(("bench.", "engine.")):
            continue
        a = _ns(e, "start")
        (dev if on_device else host).append((name, a, a + _ns(e, "duration")))
    return dev, host


class Slice:
    """Asked after each step of a traced run whether the step just ended
    was profiled; opens the profiler at a step boundary."""

    def __init__(self, spec: Dict, seconds: float):
        self.start = max(float(seconds) - float(spec["tail_s"]), 0.0)
        self.prof = None
        self.data: Optional[TraceData] = None
        self.start_s = self.read_s = 0.0

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once (CUPTI's first start is slow),
        during set-up."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def __call__(self, t: float, steps) -> bool:
        if self.prof is not None:
            return True
        if t >= self.start:
            t0 = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.start_s = time.perf_counter() - t0
        return False

    def finish(self) -> None:
        """Stop the profiler and read its trace (after the drain)."""
        if self.prof is None:
            return
        t0 = time.perf_counter()
        self.prof.stop()
        dev, host = read(self.prof)
        self.read_s = time.perf_counter() - t0
        steps = [h for h in host if h[0] == "bench.step"]
        if steps:
            t0, t1 = min(h[1] for h in steps), max(h[2] for h in steps)
        else:
            t0 = min((a for _, a, _ in dev), default=0)
            t1 = max((b for _, _, b in dev), default=0)
        self.data = TraceData(dev, host, t0, t1)
        self.prof = None
