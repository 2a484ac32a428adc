"""Unified serving-runtime protocol + single-source runtime configuration.

The repo grows two runtimes on purpose — the *functional* ``ServingEngine``
(really executes models; clock = engine steps) and the *event-driven*
``Simulator`` (analytic PerfModel timing; clock = seconds) — but multi-tenant
claims are cluster-level: a router, a replica group, and a coordinated remap
policy must sit *above* either runtime without caring which one it is.
``ServingRuntime`` is that seam: the tick-granular protocol both runtimes
implement, and the cluster layer is written against it alone.

Protocol contract (units are the runtime's own clock — steps or seconds;
slack ordering and all cluster logic are unit-invariant):

  * ``submit(reqs)``   — enqueue arrivals; append-safe (the cluster router
    feeds requests incrementally as their arrival times come due).
  * ``tick()``         — advance ONE scheduling iteration, returning the
    elapsed time. Admission inside the tick considers requests with
    ``arrival <= horizon()`` as observed *before* the tick.
  * ``busy()``         — any work left (incoming, queued, or in flight)?
  * ``horizon()``      — the arrival-time horizon of the next tick: a
    request submitted before ``tick()`` with ``arrival <= horizon()`` is
    admitted in exactly the iteration it would have been admitted in had
    it been submitted up front. THE single-replica-equivalence contract:
    a router dispatching on this horizon is invisible to the runtime.
  * ``pressure()``     — KV memory pressure in [0, 1] (used fraction).
  * ``inflight()``     — requests submitted but not finished (router load).
  * ``draining()``     — a remap/revert plan transition is mid-drain (the
    router shifts traffic away; the coordination policy staggers starts).
  * ``tenant_slacks()``— live per-tenant SLO slack (slack-aware routing).
  * ``set_reversion_enabled(b)`` — gate *new* Dynamic Reversion decisions
    (``CoordinatedRemapPolicy``); in-flight drains always complete.
  * ``metrics()`` / ``tier_metrics()`` — ``ServingMetrics`` aggregate and
    per-SLO-tier slices, including ``unfinished`` truncation counts.

The port carries ``merge_arrivals`` and the protocol; ``TenantSpec`` and
the backend lowering wait for the port of the simulator.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Protocol, runtime_checkable

from repro_torch.serving.request import Request, ServingMetrics


def merge_arrivals(pending: deque, reqs: List[Request]) -> deque:
    """THE arrival-queue merge behind every ``submit()`` (engine,
    simulator, replica group — one implementation so the boundary
    condition can never diverge between them). The cluster router feeds
    requests one at a time in arrival order, so the in-order path must
    be an O(1) append; the full re-sort runs only on out-of-order adds."""
    reqs = sorted(reqs, key=lambda r: r.arrival)
    if pending and reqs and reqs[0].arrival < pending[-1].arrival:
        return deque(sorted([*pending, *reqs], key=lambda r: r.arrival))
    pending.extend(reqs)
    return pending


@runtime_checkable
class ServingRuntime(Protocol):
    """Tick-granular serving runtime (see module docstring for the
    contract). ``ServingEngine`` and ``Simulator`` both satisfy it —
    enforced by tests/test_runtime_protocol.py across both backends."""

    def submit(self, reqs: List[Request]) -> None: ...

    def tick(self) -> float: ...

    def busy(self) -> bool: ...

    def horizon(self) -> float: ...

    def pressure(self) -> float: ...

    def inflight(self) -> int: ...

    def draining(self) -> bool: ...

    def tenant_slacks(self) -> Dict[str, float]: ...

    def set_reversion_enabled(self, enabled: bool) -> None: ...

    def metrics(self) -> ServingMetrics: ...

    def tier_metrics(self) -> Dict[str, ServingMetrics]: ...

    # fleet prefix cache hooks (cluster/fleet_prefix_cache.py): publish
    # notification, non-mutating local probe, the transfer-vs-recompute
    # quantities, and cross-replica KV export/import
    def set_prefix_listener(self, cb) -> None: ...

    def prefix_probe(self, model: str, tokens) -> int: ...

    def prefix_costs(self, model: str, span_tokens: int,
                     prompt_tokens: int): ...

    def export_prefix(self, model: str, tokens, n_tokens: int): ...

    def import_prefix(self, model: str, tokens, n_tokens: int,
                      kv=None) -> int: ...

    def prefix_snapshot(self, max_blocks: int = 0): ...

    # replica lifecycle (cluster/autoscaler.py): respill un-admitted
    # arrivals at scale-in, and force reversion of donated parameter
    # memory before the replica's KV is torn down (the cluster-level
    # drain-before-teardown invariant)
    def withdraw_pending(self) -> List[Request]: ...

    def drain_for_removal(self) -> None: ...
