"""Per-tenant SLO specification + live slack computation.

The paper's headline claims are *tail* TBT/TTFT reductions in multi-tenant
serving — which only matter relative to each tenant's latency target. This
module is the one place those targets live: ``SLOSpec`` is threaded through
``TenantConfig`` (engine), ``SimTenantConfig`` (simulator), and
``ModelInfo.slo_tier`` (control plane), and ``tenant_slack`` turns live
request state into the earliest-deadline-first signal the ``SLOScheduler``
and the victim-selection policy consume.

Units contract: slack, ``now``, and the spec's targets share whatever clock
the runtime uses — *seconds* in the simulator (PerfModel-predicted service
times), *engine steps* in the functional engine (one decode == one step).
Slack ordering is unit-invariant, so the scheduler never needs to know.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional

LATENCY = "latency"          # latency-critical: chat-style tenants
BEST_EFFORT = "best_effort"  # throughput batch tenants (default)

_TIERS = (LATENCY, BEST_EFFORT)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-tenant service-level objective.

    ``ttft_target``/``tbt_target`` are deadlines relative to arrival /
    previous token (inf = no target, i.e. pure best-effort). ``tier``
    drives victim selection and preemption order: best-effort tenants
    donate parameter memory and get preempted/cache-evicted first;
    latency-critical tenants revert first. Frozen + hashable so "all
    tenants share one SLOSpec" is a plain set-cardinality check.
    """
    ttft_target: float = math.inf
    tbt_target: float = math.inf
    tier: str = BEST_EFFORT

    def __post_init__(self):
        if self.tier not in _TIERS:
            raise ValueError(f"unknown SLO tier {self.tier!r}")

    @property
    def latency_critical(self) -> bool:
        return self.tier == LATENCY


def tier_rank(tier: str) -> int:
    """Donation/preemption order: best-effort (0) pays before latency (1)."""
    return 0 if tier == BEST_EFFORT else 1


def request_slack(r, spec: SLOSpec, now: float,
                  t_first: float, t_next: float) -> float:
    """Slack of one request: time to its next deadline minus the predicted
    service time (negative = will miss even if served immediately).

    Before the first token the deadline is TTFT (arrival-anchored, so queue
    wait eats slack); afterwards it is TBT (anchored at the last emitted
    token). ``t_first``/``t_next`` are the runtime's predicted
    time-to-first-token / next-decode-step durations.
    """
    if r.t_first_token is None or not r.token_times:
        return r.arrival + spec.ttft_target - now - t_first
    return r.token_times[-1] + spec.tbt_target - now - t_next


def tenant_slack(spec: SLOSpec, now: float, queued: Iterable,
                 running: Iterable, t_first: float, t_next: float) -> float:
    """Most-urgent (minimum) slack across a tenant's requests.

    Only the queue head matters for the TTFT side (FIFO admission: it has
    the earliest arrival); every running request contributes its TBT
    deadline, and mid-prefill requests still carry their TTFT deadline.
    Returns +inf for an idle tenant or an all-inf spec — such tenants lose
    every urgency comparison, which is exactly best-effort semantics.
    """
    slack = math.inf
    head = next(iter(queued), None)
    if head is not None:
        slack = min(slack, request_slack(head, spec, now, t_first, t_next))
    for r in running:
        slack = min(slack, request_slack(r, spec, now, t_first, t_next))
    return slack


def runtime_tenant_slack(spec: SLOSpec, now: float, queued: Iterable,
                         running: Iterable, prefilling: Iterable, *,
                         t_first_head: float, t_next: float,
                         t_first_remaining) -> float:
    """THE per-tenant slack computation shared by both runtimes,
    parameterized by the runtime's service-time estimates: the functional
    engine feeds step counts (one decode == one step, chunked prefill ==
    ceil(remaining/chunk) steps), the simulator feeds PerfModel seconds.

    ``queued``'s head carries the tenant's earliest TTFT deadline served
    in ``t_first_head``; ``running`` requests carry TBT deadlines served
    in ``t_next``; ``prefilling`` (mid-prefill, admitted but before first
    token) requests keep their TTFT deadline with the remaining-prompt
    estimate ``t_first_remaining(r)`` — not the queue head's.
    """
    slack = tenant_slack(spec, now, queued, running, t_first_head, t_next)
    for r in prefilling:
        slack = min(slack, request_slack(
            r, spec, now, t_first_remaining(r), t_next))
    return slack


def preemption_victim(candidates: Iterable, specs: Dict[str, "SLOSpec"]):
    """Pick the recompute-preemption victim shared by both runtimes'
    vLLM baseline: the youngest running request, preferring best-effort
    tenants whenever one is running, so the recompute stall lands on the
    tier without latency targets. Returns None when nothing is running."""
    return max(candidates,
               key=lambda r: (specs[r.model].tier == BEST_EFFORT, r.arrival),
               default=None)


def slo_attainment(ttfts: List[Optional[float]], max_tbts: List[float],
                   spec: SLOSpec) -> float:
    """Fraction of requests meeting BOTH targets (request-level: one late
    token anywhere in a stream is a user-visible stall, so the whole
    request misses). A request that never produced a first token (dropped
    as unserveable) counts as a miss. NaN-free by construction: missing
    TTFTs arrive as None."""
    if not ttfts:
        return float("nan")
    ok = 0
    for ttft, mtbt in zip(ttfts, max_tbts):
        if ttft is None or ttft > spec.ttft_target:
            continue
        if mtbt > spec.tbt_target:
            continue
        ok += 1
    return ok / len(ttfts)


def uniform_specs(specs: Dict[str, SLOSpec]) -> bool:
    """True when every tenant shares one SLOSpec — the degenerate case in
    which SLO scheduling must reduce to plain round-robin fairness."""
    return len(set(specs.values())) <= 1
