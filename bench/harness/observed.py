"""What one run observed, in the form the metric readers
(``bench/metrics/<name>.py``) take: the requests with their send times and
token stamps, the steps with their stamps, the engine's events and graph
counters, the device trace of a traced run, and the model's operation
counts. Every time is in seconds from the window's start; the window is
[0, ``end``], ``end`` being the first step boundary at or after the
window's length.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from harness.serve import Record, Served, Step
from harness.trace import TraceData
from harness.work import ModelWork


def percentile(vals, p: float) -> Optional[float]:
    """numpy's (linear) percentile, None for no values."""
    if len(vals) == 0:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), p))


@dataclasses.dataclass
class Run:
    record: Record
    cell: Dict
    mix: Dict
    port: Dict
    seconds: float
    setup_s: float
    trace: Optional[TraceData] = None
    work: ModelWork = None

    def __post_init__(self):
        self.work = ModelWork(self.port)

    @property
    def end(self) -> float:
        return self.record.closed_at

    def inside(self, t: float) -> bool:
        return 0.0 <= t <= self.end

    def stamp(self, step_idx: int) -> float:
        return self.record.stamp(step_idx)

    # ------------------------------------------------------------ requests
    def attempted(self) -> List[Served]:
        """Requests sent inside the window (open loop: due inside it)."""
        return [s for s in self.record.served if s.in_window]

    def failed(self) -> List[Served]:
        """Requests sent inside the window that never got a first token
        before the drain ran out."""
        return [s for s in self.attempted() if not s.token_steps]

    def ttfts(self) -> List[float]:
        """Seconds from each attempted request's send (its due time, in an
        open loop) to the end of the step that produced its first token;
        a failed request counts as infinitely late."""
        out = []
        for s in self.attempted():
            steps = s.token_steps
            out.append(self.stamp(steps[0]) - s.sent if steps
                       else float("inf"))
        return out

    def tbts(self) -> List[float]:
        """Every gap between consecutive tokens of every request whose later
        token came inside the window."""
        out = []
        for s in self.record.served:
            ts = [self.stamp(i) for i in s.token_steps]
            out.extend(b - a for a, b in zip(ts, ts[1:]) if self.inside(b))
        return out

    def tokens_in_window(self) -> int:
        return sum(1 for s in self.record.served for i in s.token_steps
                   if self.inside(self.stamp(i)))

    # --------------------------------------------------------------- steps
    def steps(self, profiled: Optional[bool] = None) -> List[Step]:
        """Steps inside the window; ``profiled`` False leaves out the
        traced slice's steps (their times carry the profiler's cost)."""
        return [s for s in self.record.steps
                if s.t0 >= 0 and s.t1 <= self.end
                and (profiled is None or s.profiled == profiled)]

    def decode_rows(self) -> Dict[Tuple[str, int], List[Tuple[Served, int]]]:
        """(tenant, step) -> [(request, token index)] of every decoded token
        (token 0 comes from the prefill; token i >= 1 from a decode step
        whose input was token i - 1)."""
        out: Dict[Tuple[str, int], List[Tuple[Served, int]]] = {}
        for s in self.record.served:
            for i, st in enumerate(s.token_steps):
                if i:
                    out.setdefault((s.tenant, st), []).append((s, i))
        return out

    def prefills(self) -> Dict[int, List[Served]]:
        """step -> requests prefilled in it."""
        out: Dict[int, List[Served]] = {}
        for s in self.record.served:
            if s.prefill_step >= 0:
                out.setdefault(s.prefill_step, []).append(s)
        return out

    def step_flops(self, steps: List[Step]) -> Tuple[float, float]:
        """(prefill flops, decode flops) of the model work in ``steps``."""
        idx = {s.idx for s in steps}
        pre = sum(self.work.prefill_flops(s.plan.prompt.size)
                  for st, reqs in self.prefills().items() if st in idx
                  for s in reqs)
        dec = 0.0
        for (_, st), rows in self.decode_rows().items():
            if st in idx:
                # token i is decoded at position prompt + i - 1 and attends
                # over prompt + i keys, its own included
                dec += sum(self.work.token_flops(s.plan.prompt.size + i)
                           for s, i in rows)
        return pre, dec

    def decode_contexts(self, steps: List[Step]) -> Iterator[List[int]]:
        """Each (tenant, step) decode call's real rows' key counts."""
        idx = {s.idx for s in steps}
        for (_, st), rows in self.decode_rows().items():
            if st in idx:
                yield [s.plan.prompt.size + i for s, i in rows]
