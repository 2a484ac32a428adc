"""Replica fleet over the ``ServingRuntime`` protocol.

``ReplicaGroup`` is the cluster-level runtime: it holds N independent
serving units — single-device replicas (each a full ``ServingEngine`` or
``Simulator`` with its own allocator and ``RemappingController``) or
multi-device ``ShardSet``s when the config declares shard degrees —
dispatches the global request stream through a ``Router`` as arrival
times come due, optionally applies a ``CoordinatedRemapPolicy`` before
every round, and advances all busy units in lock-step ``tick()`` rounds.
Drain-awareness is per UNIT: a draining shard set diverts traffic and
consumes a coordination grant as one thing, never per device. Fleet
metrics are ``ServingMetrics.merge`` over the units — tails recomputed
from pooled per-request samples, never averaged-of-tails.

Membership is DYNAMIC (cluster/autoscaler.py drives it): each unit moves
through a per-replica state machine

    add_replica()                       remove_replica()
        |                                      |
        v        imports drained               v        drained + reverted
    WARMING ─────────────────────> ACTIVE ─────────> LEAVING ─────> gone

* WARMING — built from the group's ``RuntimeConfig``, optionally
  pre-warming its prefix pool from the fleet's cached state (real KV
  bytes cross through the ``import_prefix`` data plane); not routable.
* ACTIVE  — routable; the only state the static fleet ever occupies.
* LEAVING — unroutable; un-admitted arrivals respill through the router,
  admitted work finishes, then the **drain-before-teardown invariant**
  runs: every in-flight ``PlanDrain``/``PrefixFetch`` completes and every
  donated tenant layer is reverted to residency (``drain_for_removal``)
  before the unit's KV is torn down and ``FleetPrefixCache.drop_replica``
  forgets its holdings — the cluster-level analogue of the shard-set
  partial-drain hazard.

Fleet-cache identity is the replica's stable ``uid`` (monotonic, never
reused), so an index freed by scale-in can be recycled by a later join
without aliasing the departed unit's published blocks.

Single-replica transparency (tested for both backends): driving a
1-replica group over a trace is byte-identical to submitting the trace to
the runtime directly. This holds because dispatch uses the runtime's
``horizon()`` — a request is handed over exactly when the runtime would
first admit it, so incremental submission is invisible. A static fleet
(no membership ops) runs the identical code paths it always did: every
dynamic branch is gated on the first ``add_replica``/``remove_replica``.
"""
from __future__ import annotations

import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.fleet_prefix_cache import FleetPrefixCache
from repro_torch.cluster.policy import CoordinatedRemapPolicy
from repro_torch.cluster.router import Router
from repro_torch.cluster.shard_set import ShardSet
from repro_torch.serving.request import Request, ServingMetrics
from repro_torch.serving.runtime import (
    RuntimeConfig, ServingRuntime, merge_arrivals,
)

# per-replica lifecycle states (see module docstring)
WARMING = "warming"
ACTIVE = "active"
LEAVING = "leaving"


class ReplicaGroup:
    def __init__(self, replicas: Sequence[ServingRuntime],
                 router: Optional[Router] = None,
                 remap_policy: Optional[CoordinatedRemapPolicy] = None,
                 fleet_cache: Optional[FleetPrefixCache] = None,
                 autoscaler=None):
        if not replicas:
            raise ValueError("ReplicaGroup needs at least one replica")
        self.replicas: List[ServingRuntime] = list(replicas)
        self.router = router if router is not None else Router()
        self.remap_policy = remap_policy
        self.autoscaler = autoscaler
        self._incoming: deque = deque()
        self.ticks = 0
        # drain concurrency audit: how often ANY replica was draining and
        # how often >= 2 were draining at once (what coordination removes)
        self.drain_ticks = 0
        self.simultaneous_drain_ticks = 0
        # membership: per-replica lifecycle state + a stable uid per unit
        # (fleet-cache holder identity; survives list renumbering). For a
        # static fleet uids == indices and every dynamic branch is dead —
        # gated on ``_dynamic``, flipped by the first membership op.
        self._state: List[str] = [ACTIVE] * len(self.replicas)
        self._uids: List[int] = list(range(len(self.replicas)))
        self._next_uid = len(self.replicas)
        self._dynamic = False
        self._retired: List[ServingRuntime] = []
        # membership event log: (fleet time, kind, uid) with kind in
        # {join, active, leave, gone} — what fig27 audits scale events on
        self.events: List[Tuple[float, str, int]] = []
        # accumulated replica-time (replica count x round wall time, all
        # lifecycle states — a warming or draining unit still costs its
        # machine): the replica-hours axis of the autoscaling benchmark
        self.replica_seconds = 0.0
        self._wall = 0.0
        # from_config stashes these so add_replica can build fresh units
        self._config: Optional[RuntimeConfig] = None
        self._backend = "sim"
        self._build_kw: Dict = {}
        # fleet-wide content-addressed prefix cache: every replica's
        # publishes feed the shared index; dispatch consults it and cold
        # replicas import warm spans over the host link when the
        # transfer-vs-recompute call favors the fetch
        self.fleet_cache = fleet_cache
        # pre-flight batch dedup: leading-block chain key -> replica that
        # a same-round arrival with that key was steered to (reset per
        # dispatch round)
        self._round_prefix: Dict[str, int] = {}
        if fleet_cache is not None:
            for i, rt in enumerate(self.replicas):
                self._install_listener(rt, self._uids[i])

    def _install_listener(self, rt: ServingRuntime, uid: int) -> None:
        fc = self.fleet_cache
        rt.set_prefix_listener(
            lambda model, tokens, now, _u=uid:
            fc.publish(_u, model, tokens, now))

    @classmethod
    def from_config(cls, config: RuntimeConfig, n_replicas: int, *,
                    backend: str = "sim",
                    router: Optional[Router] = None,
                    coordinate: bool = False,
                    fleet_cache: Optional[FleetPrefixCache] = None,
                    autoscaler=None,
                    **kw) -> "ReplicaGroup":
        """Build N identical serving units from one declare-once config.
        When the config declares shard degrees (``TenantSpec.shards > 1``)
        each unit is a ``ShardSet`` spanning that many devices — routed,
        ticked, and drain-tracked atomically; fit is validated up front
        (``RuntimeConfig.validate_fit``) so an impossible tenant fails
        here, not in an allocator mid-run. ``coordinate=True`` installs a
        ``CoordinatedRemapPolicy`` (stagger whole-unit drains); extras in
        ``kw`` pass through to the backend builder. The config/backend/kw
        triple is retained so ``add_replica()`` can mint identical fresh
        units at scale-out."""
        if config.shard_devices() > 1:
            units: List[ServingRuntime] = [
                ShardSet.from_config(config, backend=backend, **kw)
                for _ in range(n_replicas)]
        else:
            units = [config.build(backend, **kw) for _ in range(n_replicas)]
        group = cls(units, router=router,
                    remap_policy=CoordinatedRemapPolicy() if coordinate
                    else None,
                    fleet_cache=fleet_cache, autoscaler=autoscaler)
        group._config = config
        group._backend = backend
        group._build_kw = dict(kw)
        return group

    # ------------------------------------------------------------ membership
    def _build_unit(self) -> ServingRuntime:
        if self._config is None:
            raise ValueError(
                "add_replica() with no runtime needs a group built via "
                "from_config (it replays the stored config); pass a "
                "constructed runtime instead")
        if self._config.shard_devices() > 1:
            return ShardSet.from_config(self._config,
                                        backend=self._backend,
                                        **self._build_kw)
        return self._config.build(self._backend, **self._build_kw)

    def add_replica(self, runtime: Optional[ServingRuntime] = None, *,
                    prewarm: bool = False, prewarm_blocks: int = 0) -> int:
        """Scale out by one unit; returns its stable uid. The unit joins
        WARMING (unroutable) and flips ACTIVE on the next round once its
        pre-warm imports have fully drained — a cold join activates on
        the next round outright. ``prewarm=True`` imports the fleet's
        cached prefixes (re-verified against the donors, charged as real
        KV bytes over the joining unit's host link) before activation;
        ``prewarm_blocks`` bounds the transfer (0 = everything)."""
        self._dynamic = True
        if runtime is None:
            runtime = self._build_unit()
        uid = self._next_uid
        self._next_uid += 1
        i = len(self.replicas)
        self.replicas.append(runtime)
        self._uids.append(uid)
        self._state.append(WARMING)
        self.events.append((self._wall, "join", uid))
        if self.fleet_cache is not None:
            self._install_listener(runtime, uid)
            if prewarm:
                self._prewarm(i, prewarm_blocks)
        return uid

    def remove_replica(self, index: int) -> None:
        """Begin scale-in of the unit at ``index``: it leaves the
        routable set immediately, its un-admitted arrivals respill
        through the router, and the group's lifecycle pass tears it down
        once its admitted work, in-flight transfers, and forced reversion
        of donated parameter memory have all drained."""
        if not 0 <= index < len(self.replicas):
            raise IndexError(f"no replica at index {index}")
        if self._state[index] != ACTIVE:
            raise ValueError(
                f"replica {index} is {self._state[index]}, not active")
        if sum(s == ACTIVE for s in self._state) <= 1:
            raise ValueError("cannot scale in the last active replica")
        self._dynamic = True
        self._state[index] = LEAVING
        self.events.append((self._wall, "leave", self._uids[index]))
        respill = self.replicas[index].withdraw_pending()
        if respill:
            self.submit(respill)

    def _prewarm(self, i: int, max_blocks: int = 0) -> None:
        """Warm the joining unit's prefix pool before it takes traffic:
        snapshot each active donor's maximal cached prefixes, re-verify
        the span against the donor (the non-mutating probe — the donor
        may have evicted since publishing), and move the KV through the
        existing export/import data plane — the import charges real bytes
        against the joiner's host link, so a pre-warmed join is never
        free, it is just paid before traffic instead of under it."""
        fc = self.fleet_cache
        new = self.replicas[i]
        uid = self._uids[i]
        now = self._fleet_now()
        for j in range(len(self.replicas)):
            if j == i or self._state[j] != ACTIVE:
                continue
            donor = self.replicas[j]
            for model, tokens in donor.prefix_snapshot(max_blocks):
                span = donor.prefix_probe(model, tokens)
                if span <= 0 or span <= new.prefix_probe(model, tokens):
                    continue
                kv = donor.export_prefix(model, tokens, span)
                got = new.import_prefix(model, tokens, span, kv=kv)
                if got:
                    nbytes, _tf, _tr = new.prefix_costs(
                        model, got, max(len(tokens), got))
                    fc.stats.transfers += 1
                    fc.stats.transferred_tokens += got
                    fc.stats.fetch_bytes += nbytes
                    fc.publish(uid, model, tokens[:span], now)

    def _transfer_pending(self, rt: ServingRuntime) -> bool:
        """Any in-flight host-link work the lifecycle must wait on: a
        remap/revert plan drain, or a cross-replica prefix fetch (the
        simulator drains those outside ``draining()``)."""
        return bool(rt.draining()) or \
            bool(getattr(rt, "_prefix_fetches", ()))

    def _remapped(self, rt: ServingRuntime) -> bool:
        store = getattr(rt, "store", None)
        return bool(store is not None and store.total_remapped_bytes())

    def _lifecycle(self) -> None:
        """One membership pass per round: warming units whose imports
        drained flip ACTIVE; leaving units run the drain-before-teardown
        sequence and are finalized when nothing is left in flight."""
        for i, rt in enumerate(self.replicas):
            if self._state[i] == WARMING and not self._transfer_pending(rt):
                self._state[i] = ACTIVE
                self.events.append((self._wall, "active", self._uids[i]))
        # reversed: finalizing deletes list positions
        for i in reversed(range(len(self.replicas))):
            if self._state[i] != LEAVING:
                continue
            rt = self.replicas[i]
            if not rt.busy():
                # admitted work is gone: force reversion of every donated
                # tenant layer (idempotent; the restore drains over the
                # unit's host link like any Dynamic Reversion)
                rt.drain_for_removal()
            if rt.busy() or self._transfer_pending(rt) \
                    or self._remapped(rt):
                continue
            self._finalize_remove(i)

    def _finalize_remove(self, i: int) -> None:
        rt = self.replicas[i]
        uid = self._uids[i]
        n = len(self.replicas)
        del self.replicas[i]
        del self._uids[i]
        del self._state[i]
        # the unit's finished requests stay in the fleet's books: retired
        # metrics merge into metrics()/tier_metrics() (request
        # conservation across scale-in is asserted by the benchmarks)
        self._retired.append(rt)
        self.router.forget_replica(i)
        if self.remap_policy is not None:
            self.remap_policy.on_remove(i, n)
        if self.fleet_cache is not None:
            self.fleet_cache.drop_replica(uid)
        self.events.append((self._wall, "gone", uid))

    def _fleet_now(self) -> float:
        """The fleet's clock: the furthest replica horizon (the runtimes
        share one clock domain per backend — seconds or steps)."""
        return max((rt.horizon() for rt in self.replicas), default=0.0)

    @property
    def n_active(self) -> int:
        return sum(s == ACTIVE for s in self._state)

    @property
    def states(self) -> List[str]:
        """Per-replica lifecycle states (copy; positional)."""
        return list(self._state)

    @property
    def uids(self) -> List[int]:
        return list(self._uids)

    @property
    def finished_count(self) -> int:
        """Requests finished fleet-wide, retired units included — the
        request-conservation counter (finished + inflight + undispatched
        == submitted, across every membership change)."""
        return sum(len(getattr(rt, "finished", ()))
                   for rt in [*self.replicas, *self._retired])

    # --------------------------------------------------------------- driving
    def submit(self, reqs: List[Request]) -> None:
        self._incoming = merge_arrivals(self._incoming, reqs)

    def busy(self) -> bool:
        return bool(self._incoming) or \
            any(rt.busy() for rt in self.replicas) or \
            (self._dynamic and any(s != ACTIVE for s in self._state))

    def tick(self) -> float:
        """One lock-step round: autoscale, advance membership lifecycle,
        dispatch due arrivals, apply the remap coordination policy,
        advance every busy replica one iteration. Returns the round's
        wall time (max over replicas — they run concurrently)."""
        if self.autoscaler is not None:
            self.autoscaler.tick(self)
        if self._dynamic:
            self._lifecycle()
        self._dispatch()
        if self.remap_policy is not None:
            self.remap_policy.apply(self.replicas)
        draining = sum(1 for rt in self.replicas if rt.draining())
        if draining:
            self.drain_ticks += 1
        if draining > 1:
            self.simultaneous_drain_ticks += 1
        # idle-but-draining replicas must tick too: their in-flight plan
        # transition has to complete, or they would hold drain state (and
        # the coordination policy's budget) forever while the router
        # steers all new work away from them. A dynamic fleet extends
        # this to lifecycle transfers (pre-warm imports, teardown drains).
        dts = [rt.tick() for rt in self.replicas
               if rt.busy() or rt.draining()
               or (self._dynamic and self._transfer_pending(rt))]
        self.ticks += 1
        # wall time is the FLEET clock (furthest replica horizon), not a
        # sum of per-round maxima: replicas tick concurrently and idle
        # fast-forwards jump clocks, so only the monotonic max is the
        # fleet's elapsed time. Provisioned-but-idle units still accrue
        # replica-time — that is the point of the replica-hours axis.
        now = self._fleet_now()
        if now > self._wall:
            self.replica_seconds += (now - self._wall) * len(self.replicas)
            self._wall = now
        return max(dts, default=0.0)

    def _dispatch(self) -> None:
        """Hand over every arrival the fleet is due to admit: requests
        with ``arrival <= min(busy replicas' horizon)``. When the whole
        fleet is idle, release the next arrival unconditionally and let
        the routed replica fast-forward its clock — the same thing a
        standalone runtime does with its internal queue. Only a submit to
        a replica can change that replica's busy()/horizon(), so one
        snapshot plus a refresh of the routed replica after each handover
        keeps the loop O(replicas + dispatched) instead of re-scanning
        every replica (busy() walks its tenant queues) per request.
        Dynamic fleets restrict routing to ACTIVE units."""
        if not self._incoming:
            return
        routable = None
        if self._dynamic and any(s != ACTIVE for s in self._state):
            routable = [i for i, s in enumerate(self._state)
                        if s == ACTIVE]
        horizons = {i: rt.horizon()
                    for i, rt in enumerate(self.replicas) if rt.busy()}
        self._round_prefix.clear()
        while self._incoming:
            horizon = min(horizons.values()) if horizons \
                else self._incoming[0].arrival
            if self._incoming[0].arrival > horizon:
                break
            r = self._incoming.popleft()
            i = self.router.route(r, self.replicas, routable=routable) \
                if self.fleet_cache is None \
                else self._route_fleet(r, routable)
            self.replicas[i].submit([r])
            horizons[i] = self.replicas[i].horizon()

    def _route_fleet(self, r: Request, routable=None) -> int:
        """Fleet-cache-aware dispatch of one request:

        1. look up the prompt's chained content hashes in the fleet index
           (per-replica warm depths, keyed by stable uid);
        2. pre-flight batch dedup — an arrival sharing its leading block
           with one routed earlier in this SAME round is steered to that
           leader's replica, so the shared block prefills once and the
           follower CoW-forks it;
        3. route with the warm set as the router's ``prefer`` hint
           (drain-aware: the router never picks a draining holder);
        4. if the pick landed cold, re-verify the best warm holder's span
           with a non-mutating probe (the fleet index may be stale) and
           either import the span's KV over the host link or charge it as
           recomputed, per the analytic transfer-vs-recompute decision.
        """
        fc = self.fleet_cache
        m = fc.match(r.model, r.prompt, now=r.arrival,
                     max_tokens=r.prompt_len - 1)
        pos = {u: i for i, u in enumerate(self._uids)}
        prefer = {pos[u] for u in m.depths if u in pos
                  and (routable is None or pos[u] in routable)}
        bkey = fc.batch_key(r.model, r.prompt)
        mate = self._round_prefix.get(bkey) if bkey is not None else None
        if mate is not None and not prefer \
                and (routable is None or mate in routable) \
                and not self.replicas[mate].draining():
            # co-route regardless of router policy: following the leader
            # is the whole point (N identical prefills otherwise), so this
            # is a hard assignment, not a hint — but never to a draining
            # leader (drain-aware fallback: the router re-picks below)
            fc.stats.dedup_coroutes += 1
            self.router.assignments[r.rid] = mate
            i = mate
        else:
            i = self.router.route(r, self.replicas, prefer=prefer or None,
                                  routable=routable)
        if bkey is not None:
            self._round_prefix.setdefault(bkey, i)
        holder, span = m.best_holder(exclude=self._uids[i])
        local = self.replicas[i].prefix_probe(r.model, r.prompt) \
            if span else m.depths.get(self._uids[i], 0)
        hpos = pos.get(holder, -1)
        if holder < 0 or hpos < 0 or span <= local:
            return i
        # never fetch more than the holder still verifiably has, nor more
        # than admission could use (full blocks below prompt_len)
        span = min(span,
                   self.replicas[hpos].prefix_probe(r.model, r.prompt))
        gain = span - local
        if gain <= 0:
            return i
        nbytes, t_fetch, t_rec = self.replicas[i].prefix_costs(
            r.model, gain, r.prompt_len)
        if t_fetch < t_rec:
            kv = self.replicas[hpos].export_prefix(r.model, r.prompt,
                                                   span)
            got = self.replicas[i].import_prefix(r.model, r.prompt, span,
                                                 kv=kv)
            if got:
                fc.stats.transfers += 1
                fc.stats.transferred_tokens += got
                fc.stats.fetch_bytes += got * (nbytes // max(gain, 1))
                fc.publish(self._uids[i], r.model, r.prompt[:span],
                           r.arrival)
        else:
            fc.stats.recomputed_tokens += gain
        return i

    def run(self, requests: Optional[List[Request]] = None,
            max_ticks: int = 10_000_000) -> ServingMetrics:
        if requests is not None:
            self.submit(requests)
        while self.busy() and self.ticks < max_ticks:
            self.tick()
        if self.busy():
            warnings.warn(
                f"ReplicaGroup.run: tick budget ({max_ticks}) exhausted "
                f"with {len(self._incoming)} undispatched and "
                f"{sum(rt.inflight() for rt in self.replicas)} in-flight "
                "requests unfinished; see metrics().unfinished",
                RuntimeWarning, stacklevel=2)
        return self.metrics()

    # --------------------------------------------------------------- metrics
    @property
    def partial_drain_ticks(self) -> int:
        """Fleet total of ticks where any unit had a layer drained on some
        of its shards but not others (zero for single-device units and for
        lock-step shard sets)."""
        total = 0
        for rt in [*self.replicas, *self._retired]:
            if isinstance(rt, ShardSet):
                total += rt.partial_drain_ticks
            else:
                total += getattr(rt, "shard_partial_drain_ticks", 0)
        return total

    def metrics(self) -> ServingMetrics:
        met = ServingMetrics.merge(
            [rt.metrics() for rt in [*self.replicas, *self._retired]])
        if self.fleet_cache is not None:
            # fleet counters live on the shared index, not on any replica:
            # overwrite the merged zeros with the group-level truth
            s = self.fleet_cache.stats
            met.fleet_hit_rate = s.hit_rate
            met.transferred_prefix_tokens = s.transferred_tokens
            met.recomputed_prefix_tokens = s.recomputed_tokens
            met.prefix_fetch_bytes = s.fetch_bytes
            met._fleet_matched_tokens = s.matched_tokens
            met._fleet_lookup_tokens = s.lookup_tokens
        return met

    def tier_metrics(self) -> Dict[str, ServingMetrics]:
        """Fleet tails per SLO tier: the union of every replica's tiers
        (retired units included), each merged from pooled samples (a tier
        idle on one replica contributes its NaN row harmlessly)."""
        per = [rt.tier_metrics()
               for rt in [*self.replicas, *self._retired]]
        tiers = dict.fromkeys(k for d in per for k in d)
        return {t: ServingMetrics.merge([d[t] for d in per if t in d])
                for t in tiers}
