"""Remap-aware request routing over ``ServingRuntime`` replicas.

The router is the cluster layer's admission plane: every arrival is
dispatched to exactly one replica at the moment the fleet's clock reaches
its arrival time, so routing can react to *live* replica state — load,
per-tenant SLO slack, and crucially ``draining()``: a replica mid
remap/revert drain is avoided whenever a non-draining twin exists, which
is what lets ``CoordinatedRemapPolicy``'s staggered drains pay off (the
twin absorbs the traffic while the drain completes).

Determinism contract (tested): routing is a pure function of (policy,
seed, request, replica states) with index-ordered tie-breaks — the same
trace through the same fleet produces the same assignment map, and
``prefix_affinity`` is seed-stable across processes (CRC32, not Python's
salted ``hash``).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serving.request import Request

LEAST_LOADED = "least_loaded"
SLACK_AWARE = "slack_aware"
PREFIX_AFFINITY = "prefix_affinity"

POLICIES = (LEAST_LOADED, SLACK_AWARE, PREFIX_AFFINITY)

# prompt tokens hashed for prefix-affinity when a request has no session:
# one page-ish leading block captures the shareable system prompt
_AFFINITY_PREFIX_TOKENS = 32


@dataclasses.dataclass
class Router:
    """Dispatch policy over N replicas.

    * ``least_loaded`` — fewest unfinished requests; ties by KV pressure,
      then replica index.
    * ``slack_aware``  — the replica where this request's tenant has the
      most live SLO slack (the deadline-safest home); ties fall back to
      least-loaded. Best-effort tenants (inf slack everywhere) therefore
      get pure least-loaded placement.
    * ``prefix_affinity`` — sticky hashing on the conversation session
      (or the leading prompt tokens when no session is set), so multi-turn
      traffic keeps landing where its prefix cache lives.

    All policies are drain-aware: draining replicas are excluded whenever
    at least one non-draining replica exists.
    """
    policy: str = LEAST_LOADED
    seed: int = 0
    # rid -> replica index, recorded for every routed request (assignment
    # audit + the seed-stability tests)
    assignments: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown router policy {self.policy!r}")

    def route(self, req: Request, replicas: Sequence,
              prefer=None, routable=None) -> int:
        """Pick the replica for ``req`` and record the assignment.
        ``prefer`` is an optional set of replica indices the fleet prefix
        cache reports as warm for this prompt — consulted by the
        ``prefix_affinity`` policy before assignment (other policies
        ignore the hint; the fetch path still serves them after routing).
        ``routable`` restricts the candidate pool to those indices (the
        replica group passes the ACTIVE members of a dynamic fleet;
        ``None`` = all, the historical behaviour bit for bit). Draining
        replicas stay excluded: a warm-but-draining holder loses to the
        normal policy pick (the drain-aware fallback)."""
        pool = list(routable) if routable is not None \
            else list(range(len(replicas)))
        avail = [i for i in pool if not replicas[i].draining()] or pool
        i = avail[0] if len(avail) == 1 \
            else self._pick(req, replicas, avail, prefer)
        self.assignments[req.rid] = i
        return i

    def forget_replica(self, idx: int) -> None:
        """Purge the audit map of a removed replica and renumber the
        survivors (the group deletes position ``idx`` from its list, so
        every later index shifts down by one). Without this, stale
        entries keep pointing at dead or renumbered replicas and any
        consumer reading the map after scale-in — audits, seed-stability
        comparisons — attributes requests to the wrong unit."""
        self.assignments = {
            rid: (i - 1 if i > idx else i)
            for rid, i in self.assignments.items() if i != idx}

    # ------------------------------------------------------------ policies
    def _pick(self, req: Request, replicas: Sequence,
              avail: List[int], prefer=None) -> int:
        if self.policy == PREFIX_AFFINITY:
            home = self._affinity_home(req, len(replicas))
            home = home if home in avail else avail[home % len(avail)]
            if prefer and home not in prefer:
                # fleet-warm replicas compete with the CRC home: divert to
                # the least-loaded warm one only when that never worsens
                # balance (load <= home's), so affinity cannot hotspot the
                # first replica that happened to publish a popular prefix
                pref = [i for i in avail if i in prefer]
                if pref:
                    best = min(pref, key=lambda i: (
                        self._load(replicas[i]), replicas[i].pressure(), i))
                    if self._load(replicas[best]) <= \
                            self._load(replicas[home]):
                        return best
            return home
        if self.policy == SLACK_AWARE:
            return min(avail, key=lambda i: (
                -self._finite_slack(replicas[i], req.model),
                self._load(replicas[i]), replicas[i].pressure(), i))
        return min(avail, key=lambda i: (
            self._load(replicas[i]), replicas[i].pressure(), i))

    @staticmethod
    def _load(rt) -> float:
        # capacity-normalized: a shard set's N devices serve one queue, so
        # its in-flight count is divided by its degree. Single-device
        # units divide by 1 — the historical ordering, bit for bit.
        return rt.inflight() / max(getattr(rt, "shards", 1), 1)

    @staticmethod
    def _finite_slack(rt, model: str) -> float:
        s = rt.tenant_slacks().get(model, math.inf)
        # inf slacks (best-effort / idle) must tie rather than win: clamp
        # to one shared sentinel so the least-loaded tie-break decides
        return min(s, 1e30)

    def _affinity_home(self, req: Request, n: int) -> int:
        key = req.session if req.session else \
            np.asarray(req.prompt[:_AFFINITY_PREFIX_TOKENS]).tobytes()
        if isinstance(key, str):
            key = key.encode()
        return zlib.crc32(self.seed.to_bytes(4, "little") + key) % n
