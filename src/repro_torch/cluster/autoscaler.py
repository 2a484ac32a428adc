"""Elastic fleet autoscaling over ``ReplicaGroup`` membership.

The autoscaler is pure POLICY: it watches time-windowed fleet signals
(in-flight load, KV pressure, live SLO slack, dispatch backlog) and asks
the group for membership changes; every mechanism — warming joins,
fleet-cache pre-warm, respill, the remap-aware drain-before-teardown
sequence — lives in ``ReplicaGroup``/the runtimes, so the same policies
drive engine-backed fleets and both simulator paths unmodified.

Scaling decisions are deliberately conservative in both directions:

* windowed signals, not instantaneous ones — a single bursty round must
  not flap membership (a join pays a pre-warm transfer, a leave pays a
  teardown drain; flapping pays both for nothing);
* a cooldown between decisions, long enough for the previous decision's
  transient (warm-up imports, respilled queue) to wash out of the window
  before it can trigger the next;
* scale-in picks the least-loaded ACTIVE unit (ties to the highest
  index) and never drops below ``min_replicas`` — and the group itself
  refuses to remove the last active unit, whatever the policy says.

Capacity accounting counts WARMING units as already provisioned: a
replica mid-pre-warm is paid for and about to serve, so the policy must
not keep adding units while one is warming (the classic
scale-out-stampede bug).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.cluster.replica_group import ACTIVE, LEAVING, WARMING


@dataclasses.dataclass
class FleetSignal:
    """One sampled observation of fleet state (the policy window's unit)."""
    now: float          # fleet clock (seconds on sim, steps on engine)
    inflight: int       # admitted, unfinished requests fleet-wide
    pressure: float     # max replica KV pressure (0..1-ish)
    min_slack: float    # tightest live SLO slack across tenants/replicas
    backlog: int        # arrivals due but not yet dispatched
    active: int         # ACTIVE replica count at sample time


class ScalingPolicy:
    """Base: map a window of ``FleetSignal`` to a desired ACTIVE count."""

    def desired(self, window: Sequence[FleetSignal],
                capacity: int) -> int:    # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass
class TargetUtilizationPolicy(ScalingPolicy):
    """Track a target in-flight-per-replica with a hysteresis band.

    Scale out when windowed mean load per ACTIVE replica exceeds
    ``upper * target``, in when it falls below ``lower * target``; inside
    the band, hold. The band is the anti-flap margin: load oscillating
    around the target must map to a constant fleet."""
    target_inflight: float = 8.0
    upper: float = 1.25
    lower: float = 0.5

    def desired(self, window: Sequence[FleetSignal], capacity: int) -> int:
        if not window:
            return capacity
        per = [s.inflight / max(s.active, 1) for s in window]
        mean = sum(per) / len(per)
        if mean > self.upper * self.target_inflight:
            return capacity + 1
        if mean < self.lower * self.target_inflight and \
                not any(s.backlog for s in window):
            return capacity - 1
        return capacity


@dataclasses.dataclass
class SLOSlackPolicy(ScalingPolicy):
    """Scale on the tightest live SLO slack: the deadline-driven policy.

    Slack is the latency-tier tenants' own currency (seconds of margin
    before an in-flight request misses its SLO), so this policy grows the
    fleet exactly when tails are about to be breached — the windowed MIN
    slack dipping under ``slack_out`` — and shrinks it only when every
    sample in the window shows comfortable margin (min slack above
    ``slack_in``) and no dispatch backlog. Asymmetric thresholds are the
    hysteresis; requiring the whole window calm before scale-in biases
    toward tails over replica-hours, which is the right trade for a
    latency tier."""
    slack_out: float = 0.5
    slack_in: float = 4.0

    def desired(self, window: Sequence[FleetSignal], capacity: int) -> int:
        if not window:
            return capacity
        worst = min(s.min_slack for s in window)
        if worst < self.slack_out or window[-1].backlog:
            return capacity + 1
        if all(s.min_slack > self.slack_in and not s.backlog
               for s in window):
            return capacity - 1
        return capacity


@dataclasses.dataclass
class SchedulePolicy(ScalingPolicy):
    """Fixed schedule baseline: (time, replicas) steps on the fleet clock.

    The no-feedback control every reactive policy is judged against —
    what an operator with perfect knowledge of the diurnal pattern would
    provision by hand."""
    steps: List[Tuple[float, int]] = dataclasses.field(default_factory=list)

    def desired(self, window: Sequence[FleetSignal], capacity: int) -> int:
        if not window:
            return capacity
        now = window[-1].now
        want = capacity
        for t, n in sorted(self.steps):
            if now >= t:
                want = n
        return want


@dataclasses.dataclass
class Autoscaler:
    """Ticked by ``ReplicaGroup.tick()``: sample, window, decide, act.

    ``window`` and ``cooldown`` are in fleet-clock units (seconds on the
    simulator, steps on the engine). ``prewarm`` makes scale-out joins
    import the fleet's cached prefixes before activation (only effective
    when the group has a fleet cache). Decisions land in ``decisions`` as
    (now, "out"/"in", active-count-after) for audit."""
    policy: ScalingPolicy = dataclasses.field(
        default_factory=TargetUtilizationPolicy)
    min_replicas: int = 1
    max_replicas: int = 4
    window: float = 60.0
    cooldown: float = 30.0
    prewarm: bool = True
    prewarm_blocks: int = 0
    decisions: List[Tuple[float, str, int]] = dataclasses.field(
        default_factory=list)
    _signals: List[FleetSignal] = dataclasses.field(default_factory=list)
    _last_change: float = -math.inf

    def tick(self, group) -> None:
        sig = self._sample(group)
        self._signals.append(sig)
        cutoff = sig.now - self.window
        while len(self._signals) > 1 and self._signals[0].now < cutoff:
            self._signals.pop(0)
        if sig.now - self._last_change < self.cooldown:
            return
        # capacity = provisioned units (ACTIVE + WARMING): a warming
        # replica is paid for and about to serve, so it already counts
        # against the desired size. LEAVING units are capacity already
        # surrendered.
        states = group.states
        capacity = sum(s in (ACTIVE, WARMING) for s in states)
        want = self.policy.desired(self._signals, capacity)
        want = max(self.min_replicas, min(self.max_replicas, want))
        if want > capacity:
            group.add_replica(prewarm=self.prewarm,
                              prewarm_blocks=self.prewarm_blocks)
            self._last_change = sig.now
            self.decisions.append((sig.now, "out", want))
        elif want < capacity and sig.active > 1:
            victim = self._victim(group)
            if victim is not None:
                group.remove_replica(victim)
                self._last_change = sig.now
                self.decisions.append((sig.now, "in", want))

    def _sample(self, group) -> FleetSignal:
        inflight = 0
        pressure = 0.0
        min_slack = math.inf
        for rt, state in zip(group.replicas, group.states):
            if state == LEAVING:
                continue
            inflight += rt.inflight()
            pressure = max(pressure, rt.pressure())
            slacks = rt.tenant_slacks()
            if slacks:
                min_slack = min(min_slack, min(slacks.values()))
        return FleetSignal(
            now=group._fleet_now(), inflight=inflight, pressure=pressure,
            min_slack=min_slack, backlog=len(group._incoming),
            active=max(group.n_active, 1))

    @staticmethod
    def _victim(group) -> Optional[int]:
        """Least-loaded ACTIVE unit; ties to the highest index (the most
        recently joined goes first — LIFO keeps long-lived replicas' warm
        caches in the fleet)."""
        cands = [(group.replicas[i].inflight(), -i, i)
                 for i, s in enumerate(group.states) if s == ACTIVE]
        if len(cands) <= 1:
            return None
        return min(cands)[2]
