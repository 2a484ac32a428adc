"""Cross-unit remap coordination (single replicas and whole shard sets).

A revert (Dynamic Reversion) drains restored layers over the host link
for several iterations; every request running on that unit eats the
drain time. With independent per-unit controllers and near-identical
traffic, units revert nearly *simultaneously* — the whole fleet stalls
at once and the router has nowhere clean to send latency-tier traffic.
``CoordinatedRemapPolicy`` staggers those transitions: at most
``max_concurrent_drains`` units may start a new reversion at a time,
so there is always a non-draining twin for the router's drain-awareness
to shift traffic onto (the ROADMAP "revert on one replica while its twin
absorbs traffic" scenario).

The grant unit is whatever the group routes to — a single-device replica
or a ``ShardSet``. A set is granted and drained ATOMICALLY: one
``set_reversion_enabled`` gates all N shards, and the drain it admits is
the set's lock-step ``ShardedPlanDrain`` — the policy can never leave a
layer half-drained across a set because no per-shard grant exists.

Only *reversion* is gated. Pressure-driven remaps stay always-on: they
are how a unit makes room for admitted KV, and delaying them would
trade a latency stall for preemptions or admission livelock.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class CoordinatedRemapPolicy:
    """Grant reversion tokens across serving units with a STICKY rotation.

    Units already mid-drain keep their grant (an in-flight
    ``PlanDrain`` must complete — interrupting it would leave an interim
    plan live forever). Free grants go to the cursor replica and its
    successors; the cursor advances when its holder actually begins a
    drain (hand-off to the twin) or after ``grant_lease`` usable-but-
    unused ticks (starvation bound). Stickiness matters: the
    controller's ``revert_patience`` demands *consecutive* calm steps
    before a reversion fires, so a cursor that hops every tick would
    reset everyone's patience forever and silently disable reversion
    fleet-wide instead of staggering it.
    """
    max_concurrent_drains: int = 1
    # ticks a holder may sit on its grant without starting a drain before
    # the cursor rotates on. Bounds starvation: a holder with nothing to
    # revert (e.g. the router sent all the remapped tenant's traffic to
    # its twin) would otherwise keep the token forever while the twin
    # streams its remapped layers indefinitely. Deliberately LONG — far
    # past the controller's revert_patience (8): a holder legitimately
    # sits on the grant through a whole pressure phase (a diurnal ON
    # window spans hundreds of iterations), and rotating mid-phase hands
    # the token to a calm twin whose immediate revert re-enters the
    # remap/revert churn the stagger exists to suppress (measured on
    # fig22: lease 128 forfeits most of the latency-tier p99 win).
    grant_lease: int = 512
    _grant: int = 0      # sticky rotation cursor over replica indices
    _held: int = 0       # ticks the current holder has sat on the grant

    def apply(self, replicas: Sequence) -> None:
        n = len(replicas)
        draining = [rt.draining() for rt in replicas]
        budget = max(self.max_concurrent_drains - sum(draining), 0)
        if draining[self._grant % n]:
            self._held = 0
        elif budget > 0:
            # the lease only burns while the grant is USABLE: with
            # another replica draining the budget is zero, and rotating
            # then could hand the cursor back to the still-draining
            # replica instead of the twin the drain hand-off promised
            self._held += 1
            if self._held > self.grant_lease:
                self._grant = (self._grant + 1) % n
                self._held = 0
        # the holder started its drain: hand the cursor to the next
        # non-draining replica so the FIRST grant after this drain
        # completes goes to the twin (fairness). The successor stays
        # gated while the drain runs — granting it now would permit the
        # simultaneous drain this policy exists to prevent — so each
        # staggered revert pays the controller's full revert_patience
        # after the previous drain ends; that serialization is the cost
        # of always leaving the router a clean replica.
        if draining[self._grant % n]:
            for k in range(1, n + 1):
                j = (self._grant + k) % n
                if not draining[j]:
                    self._grant = j
                    break
        granted = 0
        enabled = [False] * n
        for k in range(n):
            i = (self._grant + k) % n
            if draining[i]:
                enabled[i] = True
            elif granted < budget:
                enabled[i] = True
                granted += 1
        for rt, on in zip(replicas, enabled):
            rt.set_reversion_enabled(on)

    def on_remove(self, idx: int, n: int) -> None:
        """Advance the sticky cursor past a departed unit (``idx`` is the
        position removed from a fleet of ``n``). Without this the cursor
        can keep pointing at the departed unit's old index: after the
        group renumbers, the grant lands on whichever unit inherited the
        index — or, worse, ``_grant % n`` aliases onto a unit that is
        mid-drain — and the lease bookkeeping stalls reversion fleet-wide.
        The departed holder's grant passes to its successor (which holds
        the same position after the shift); cursors past the removal
        point shift down with their units."""
        if n <= 1:
            self._grant = 0
            self._held = 0
            return
        g = self._grant % n
        if g == idx:
            # holder departed: the successor inherits a fresh lease
            self._held = 0
        elif g > idx:
            g -= 1
        self._grant = g % (n - 1)
