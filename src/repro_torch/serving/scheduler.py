"""Multi-tenant GPU-sharing schedulers (paper §5.2) + the SLO layer.

MIRAGE is scheduler-agnostic; we provide the two sharing modes the paper
evaluates, the round-robin default used when no priorities exist, and an
SLO-aware scheduler that orders tenants by live slack (earliest deadline
first) while degrading to round-robin when every tenant shares one
``SLOSpec``. ``schedule()`` returns the models that run this iteration;
everything else (victim ordering etc.) reads activity from the
MetadataStore.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.slo import SLOSpec, tier_rank, uniform_specs


class Scheduler:
    # per-iteration token budget shared by every tenant scheduled this
    # step (0 = unlimited). Decode tokens are charged first; chunked
    # prefill consumes only the remainder — a tenant mid-way through a
    # long prompt can therefore never starve decode-heavy tenants.
    step_tokens: int = 0

    def schedule(self, pending: Dict[str, int], running: Dict[str, int],
                 now: float) -> List[str]:
        raise NotImplementedError

    def observe_slack(self, slacks: Dict[str, float]) -> None:
        """Per-tenant live SLO slack, fed by the runtime before each
        ``schedule`` call. Default: ignored (slack-blind schedulers)."""

    def prefill_budget(self, decode_tokens: int) -> int:
        """Prompt tokens the engine may prefill this iteration, after the
        step's ``decode_tokens`` (one per decoding request) are served."""
        if self.step_tokens <= 0:
            return 1 << 30
        return max(self.step_tokens - decode_tokens, 0)


@dataclasses.dataclass
class TemporalScheduler(Scheduler):
    """One model owns the whole accelerator per quantum (round robin over
    models with work). Suits multi-agent pipelines / idle-heavy tenants.

    Quantum accounting: a fresh quantum grants ``quantum_steps`` schedule
    calls (the grant itself plus quantum_steps-1 decrements). On expiry the
    rotation scans the other models first and, when none of them has work,
    deliberately lands back on the current model at k == len(order) with a
    fresh quantum — a lone busy tenant is never stalled by its own expiry
    (covered by tests/test_scheduler.py). ``_current`` starts at -1 (i.e.
    "before the first model") so the very first quantum goes to the first
    busy model in declaration order instead of skipping it.
    """
    models: Sequence[str]
    quantum_steps: int = 32
    step_tokens: int = 0
    _current: int = -1
    _steps_left: int = 0

    def schedule(self, pending, running, now) -> List[str]:
        order = list(self.models)
        busy = lambda m: pending.get(m, 0) + running.get(m, 0) > 0
        if self._steps_left > 0 and busy(order[self._current]):
            self._steps_left -= 1
            return [order[self._current]]
        # rotate to the next model with work (k == len(order) revisits the
        # current model: quantum expiry with a single busy tenant re-grants)
        for k in range(1, len(order) + 1):
            cand = (self._current + k) % len(order)
            if busy(order[cand]):
                self._current = cand
                self._steps_left = self.quantum_steps - 1
                return [order[cand]]
        self._steps_left = 0   # idle: no leftover quantum survives the gap
        return []


@dataclasses.dataclass
class SpatialScheduler(Scheduler):
    """All models run concurrently (MPS/MIG-like); each gets every step."""
    models: Sequence[str]
    step_tokens: int = 0

    def schedule(self, pending, running, now) -> List[str]:
        return [m for m in self.models
                if pending.get(m, 0) + running.get(m, 0) > 0]


@dataclasses.dataclass
class SLOScheduler(Scheduler):
    """Slack-driven temporal sharing: serve the tenant whose SLO is most
    at risk; round-robin whenever nobody is at risk.

    Each iteration the runtime feeds per-tenant slack (time to the
    earliest deadline minus predicted service time — see
    ``slo.tenant_slack``) via ``observe_slack``. A tenant is *urgent*
    when its slack has fallen to ``slack_margin`` or below; the most
    urgent tenant (minimum slack; ties: latency tier first, then
    declaration order — fully deterministic) owns the accelerator for
    that iteration, preempting the fair rotation. With no urgent tenant
    — and always, when every tenant shares one ``SLOSpec`` — scheduling
    is exactly ``TemporalScheduler`` round-robin, so best-effort tenants
    keep fair-share throughput whenever the latency tier has headroom.

    Best-effort tenants (inf targets) have inf slack and can never be
    urgent: under contention they yield precisely when a latency tenant
    would otherwise miss its deadline, and only then.
    """
    models: Sequence[str]
    specs: Dict[str, SLOSpec] = dataclasses.field(default_factory=dict)
    quantum_steps: int = 32
    step_tokens: int = 0
    # urgency threshold: serve a tenant out of turn once its slack is at
    # most this many time units (simulator: seconds; engine: steps).
    slack_margin: float = 0.0
    _slack: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.specs = {m: self.specs.get(m, SLOSpec()) for m in self.models}
        self._uniform = uniform_specs(self.specs)
        self._rr = TemporalScheduler(self.models,
                                     quantum_steps=self.quantum_steps,
                                     step_tokens=self.step_tokens)

    def observe_slack(self, slacks: Dict[str, float]) -> None:
        self._slack = dict(slacks)

    def schedule(self, pending, running, now) -> List[str]:
        if self._uniform:
            return self._rr.schedule(pending, running, now)
        busy = [m for m in self.models
                if pending.get(m, 0) + running.get(m, 0) > 0]
        urgent = [m for m in busy
                  if self._slack.get(m, math.inf) <= self.slack_margin]
        if urgent:
            order = {m: i for i, m in enumerate(self.models)}
            pick = min(urgent, key=lambda m: (
                self._slack.get(m, math.inf),
                -tier_rank(self.specs[m].tier), order[m]))
            return [pick]
        return self._rr.schedule(pending, running, now)


def admission_watermark(occupied_slots: int, watermark_tokens: int,
                        tokens_to_units) -> int:
    """vLLM-style admission watermark shared by both runtimes: decode
    headroom reserved per occupied batch slot so decode can always
    progress without admission thrash. ``tokens_to_units`` lowers the
    token knob into the runtime's allocation unit — allocator pages in
    the engine (``pages_needed``), KV bytes in the simulator."""
    return occupied_slots * tokens_to_units(watermark_tokens)


def make_scheduler(kind: str, models: Sequence[str], **kw) -> Scheduler:
    """Build a scheduler; irrelevant keyword args for the chosen kind are
    dropped so callers (engine/simulator) can pass one uniform kwargs set."""
    def pick(*names):
        return {k: kw[k] for k in names if k in kw}
    if kind == "temporal":
        return TemporalScheduler(models, **pick("quantum_steps", "step_tokens"))
    if kind == "spatial":
        return SpatialScheduler(models, **pick("step_tokens"))
    if kind == "slo":
        return SLOScheduler(models, **pick(
            "specs", "quantum_steps", "step_tokens", "slack_margin"))
    raise ValueError(f"unknown scheduler {kind!r}")
