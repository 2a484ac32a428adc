"""Event-driven (iteration-level) multi-tenant serving simulator.

Reproduces the paper's GH200-scale evaluation on CPU: it drives the *real*
control plane — ``MetadataStore``, ``RemappingController``, victim policies,
layer-selection feasibility — with simulated time from the analytic
``PerfModel`` (Vidur-style iteration timing). Memory is byte-accounted.

Modes (paper baselines):
  * mirage — parameter remapping: KV capacity grows by α·unit_bytes per
    victim model; cycling-layer streaming rides the host link under compute,
    resolved per-layer by the shared event pipeline
    (``core/transfer_pipeline.simulate_decode_step`` — bubble only when a
    fetch misses its layer slot); Dynamic Reversion restores params through
    an incremental ``PlanDrain`` (one remap unit per iteration crosses the
    link) unless ``incremental_apply=False`` recreates the old synchronous
    apply that charged the whole transition to the decision step.
  * vllm   — fixed capacity; exhaustion preempts the youngest request and
    recomputes it (every running request observes the stall).
  * swap   — Pie-style KV swapping: capacity extends into host DRAM; the
    overflow fraction of every touched KV byte crosses the host link
    bidirectionally at degraded bandwidth (§3.2).

The simulator is deliberately scheduler-agnostic and takes the same
TemporalScheduler / SpatialScheduler objects as the functional engine.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import warnings
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    ControllerConfig, ExpertRemapState, MemoryInfo, MetadataStore, ModelInfo,
    PlanDrain, PrefixFetch, PrefixIndex, RemapPlan, RemappingController,
    ShardedPlanDrain, identity_plan,
)
from repro_torch.serving.hw import HardwareSpec, GH200
from repro_torch.serving.perf_model import PerfModel
from repro_torch.serving.request import (
    DECODE_WATERMARK_TOKENS, Request, ServingMetrics,
)
from repro_torch.serving.scheduler import admission_watermark, make_scheduler
from repro_torch.serving.slo import (
    SLOSpec, preemption_victim, request_slack, runtime_tenant_slack,
)


def _discard(lst: list, item) -> None:
    """Remove ``item`` from ``lst`` by identity. ``list.remove`` compares
    with ``==``, and the Request dataclass eq walks the field tuple of
    every earlier element — which dominates finish processing at
    production-trace scale. rids are unique, so the element ``==`` would
    find is always ``item`` itself."""
    for i, x in enumerate(lst):
        if x is item:
            del lst[i]
            return
    raise ValueError("item not in list")


@dataclasses.dataclass
class SimTenantConfig:
    cfg: ModelConfig
    max_batch: int = 64
    mem_fraction: float = 0.35     # paper Table 1 GPU reservation
    # per-tenant SLO: targets in SECONDS (the simulator's clock)
    slo: SLOSpec = dataclasses.field(default_factory=SLOSpec)
    # model-parallel degree: >1 means this tenant is striped across the
    # shard set's devices (per-shard param/KV/unit bytes via PerfModel);
    # 1 means a full replica on EVERY device of the set
    shards: int = 1


class SimTenant:
    def __init__(self, name: str, tc: SimTenantConfig, hw: HardwareSpec,
                 prefix_page: int = 0):
        self.name = name
        self.cfg = tc.cfg
        self.perf = PerfModel(tc.cfg, hw, shards=tc.shards)
        self.max_batch = tc.max_batch
        self.reserved_bytes = int(tc.mem_fraction * hw.hbm_bytes)
        self.kv_capacity_base = max(
            self.reserved_bytes - self.perf.param_bytes, 0)
        self.queue: deque = deque()
        self.running: List[Request] = []
        # admitted requests whose prompt is still being computed in chunks
        # (chunked prefill); their KV bytes are reserved up front, exactly
        # like the engine allocating the full prompt's pages at admission
        self.prefilling: List[Request] = []
        # per-device KV bytes per token: the head-striped slice for a
        # sharded tenant, the full row for a replicated one
        self.kv_token_bytes = max(self.perf.shard_kv_token_bytes, 1)
        self.needs_reload = 0.0    # pending cold-start reload seconds
        # prefix sharing (block-granular; virtual page handles)
        self.index: Optional[PrefixIndex] = \
            PrefixIndex(prefix_page) if prefix_page else None
        self._next_vpage = 0
        self._shared: Dict[str, int] = {}   # rid -> tokens served from cache
        self._paths: Dict[str, list] = {}   # rid -> acquired trie path
        # incremental accounting, maintained at every admit/prefill/decode/
        # finish/preempt event (integer-exact, so the fast path's O(1)
        # reads are bit-identical to the reference path's O(batch) scans)
        self.fast = False
        self._priv_tokens = 0   # Σ (total_len - shared) over running+prefilling
        self._ctx_tokens = 0    # Σ total_len over running
        # fast-path deferral state: decode rounds completed, the shared
        # per-round token-time timeline, requests admitted since the last
        # decode round, and the pending finish-event heap
        self._rounds = 0
        self._timeline: List[float] = []
        self._fresh: List[Request] = []
        self._finish_heap: List[tuple] = []
        self._admit_seq = 0

    def cache_bytes(self) -> int:
        if self.index is None:
            return 0
        return self.index.num_blocks * self.index.page_size \
            * self.kv_token_bytes

    def kv_used(self) -> int:
        """Device KV bytes: each request's private tokens (suffix + decode)
        plus the deduplicated cached blocks, counted once. Prefilling
        requests count in full — their pages are reserved at admission."""
        if self.fast:
            return self._priv_tokens * self.kv_token_bytes \
                + self.cache_bytes()
        private = sum((r.total_len - self._shared.get(r.rid, 0))
                      * self.kv_token_bytes
                      for r in self.running + self.prefilling)
        return private + self.cache_bytes()

    def cache_reclaim(self, bytes_needed: int) -> int:
        """LRU-evict unreferenced cached blocks; returns bytes freed —
        the low-pressure free source tried before the controller."""
        if self.index is None or bytes_needed <= 0:
            return 0
        block_bytes = self.index.page_size * self.kv_token_bytes
        n = -(-bytes_needed // block_bytes)
        return len(self.index.evict(n)) * block_bytes


class Simulator:
    def __init__(
        self,
        tenants: Dict[str, SimTenantConfig],
        *,
        mode: str = "mirage",
        scheduler: str = "temporal",
        hw: HardwareSpec = GH200,
        quantum_steps: int = 32,
        victim_policy: str = "mru",
        double_buffer: bool = True,
        buffer_mode: str = "dynamic",     # single (A) | double (B) | dynamic (C)
        pipeline_cap: bool = True,
        dynamic_reversion: bool = True,
        max_remap_fraction: float = 0.5,
        reversion_hysteresis: float = 0.3,
        uniform_selection: bool = True,   # ablation: False = contiguous
        seed: int = 0,
        prefix_sharing: bool = False,
        prefix_page: int = 32,            # tokens per shared KV block
        prefill_chunk_tokens: int = 0,    # 0 = monolithic prefill
        step_tokens: int = 0,             # scheduler token budget (0 = inf)
        watermark_tokens: int = DECODE_WATERMARK_TOKENS,
        slack_margin: float = 0.0,        # SLO urgency threshold (seconds)
        incremental_apply: bool = True,   # False = old synchronous apply
        expert_granular: bool = False,    # MoE tenants: remap per expert
        expert_routing=None,              # {model: traces.ZipfRouting}
        expert_pin_fraction: float = 0.125,
        shard_devices: int = 1,           # devices in this shard set (SPMD)
        shard_lockstep: bool = True,      # False = naive per-shard drains
        prefix_dedup: bool = False,       # publish prompt blocks at admission
                                          # (same-round arrivals fork, not
                                          # re-prefill); monolithic path only
        fast: bool = False,               # O(1)-per-tick hot path (bit-
                                          # identical; see docs/ARCHITECTURE)
    ):
        assert mode in ("mirage", "vllm", "swap")
        self.mode = mode
        self.fast = bool(fast)
        self.hw = hw
        self.shard_devices = max(int(shard_devices), 1)
        self.shard_lockstep = shard_lockstep
        # ticks where a layer was resident on some shards but not others —
        # zero by construction under lock-step coordination
        self.shard_partial_drain_ticks = 0
        self.uniform_selection = uniform_selection
        self.incremental_apply = incremental_apply
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.watermark_tokens = int(watermark_tokens)
        self.slo_specs: Dict[str, SLOSpec] = {
            n: tc.slo for n, tc in tenants.items()}
        # mirror of the engine: with every spec at the all-inf default,
        # every slack is inf and both consumers ignore it — skip the work
        self._slo_enabled = any(
            s != SLOSpec() for s in self.slo_specs.values())
        self.tenants = {
            n: SimTenant(n, tc, hw,
                         prefix_page=prefix_page if prefix_sharing else 0)
            for n, tc in tenants.items()}
        for t in self.tenants.values():
            t.fast = self.fast
        page_bytes = 2 << 20
        self.store = MetadataStore(MemoryInfo(
            hbm_bytes=hw.hbm_bytes, page_bytes=page_bytes,
            base_kv_pages=sum(t.kv_capacity_base for t in self.tenants.values())
            // page_bytes))
        # expert-granular remapping: MoE tenants register L*E expert units
        # (layer_bytes = one expert's FFN weights) instead of pattern
        # repeats; an ExpertRemapState per tenant supplies routing-driven
        # victim selection and the expected-cold-fetch feasibility bound
        self.expert_routing = dict(expert_routing or {})
        self._expert: Dict[str, ExpertRemapState] = {}
        if expert_granular and mode == "mirage":
            for n, t in self.tenants.items():
                cfg = t.cfg
                if cfg.moe is None or cfg.num_moe_layers() == 0 \
                        or t.perf.expert_bytes <= 0:
                    continue
                es = ExpertRemapState(
                    cfg.num_moe_layers(), cfg.moe.num_experts,
                    cfg.moe.top_k, t.perf.expert_bytes,
                    pin_fraction=expert_pin_fraction)
                es.note_step_compute(t.perf.decode_step_time(1, 512))
                self._expert[n] = es
        for n, t in self.tenants.items():
            es = self._expert.get(n)
            self.store.register(ModelInfo(
                name=n,
                num_layers=(es.num_moe_layers * es.num_experts
                            if es else t.perf.repeats),
                layer_bytes=(es.expert_bytes if es else t.perf.unit_bytes),
                max_remap_fraction=max_remap_fraction,
                slo_tier=self.slo_specs[n].tier))
        self.controller = RemappingController(
            self.store,
            ControllerConfig(
                victim_policy=victim_policy, double_buffer=double_buffer,
                buffer_mode=buffer_mode, pipeline_cap=pipeline_cap,
                dynamic_reversion=dynamic_reversion,
                reversion_hysteresis=reversion_hysteresis),
            {n: (t.perf.t_transfer_expert if n in self._expert
                 else t.perf.t_transfer_unit)
             for n, t in self.tenants.items()},
            expert_state=self._expert,
        )
        self.scheduler = make_scheduler(
            scheduler, list(self.tenants), quantum_steps=quantum_steps,
            step_tokens=step_tokens, specs=self.slo_specs,
            slack_margin=slack_margin)
        self.now = 0.0
        self._reversion_base = dynamic_reversion
        self._prefill_budget = 0       # per-iteration, shared by tenants
        # pending arrivals: ONE sorted list + a cursor. The old deque
        # re-sorted and re-allocated per merge and churned a popleft per
        # request; the cursor makes per-tick intake an index walk and the
        # in-order submit an O(new) append (out-of-order submits re-sort
        # only the unconsumed tail — same stable order merge_arrivals
        # produces, enforced by tests/test_sim_equivalence.py)
        self._arrivals: List[Request] = []
        self._arr_pos = 0
        # global progress counter for the starvation guard, maintained
        # incrementally (== the old per-tick O(running) rescan, exactly)
        self._tok_live = 0
        # tick-loop guard state (hoisted out of the old monolithic run()
        # so the iteration body is one protocol-visible tick())
        self._idle_guard = 0
        self._no_progress = 0
        self._tokens_done = -1
        self.finished: List[Request] = []
        self.host_link_busy_s = 0.0
        self.swap_overflow_peak = 0
        # fleet prefix cache hooks: a publish listener (the cluster layer's
        # fleet index), in-flight cross-replica KV fetches (byte-drains that
        # share the host link with remap traffic), and fetch accounting
        self.prefix_dedup = bool(prefix_dedup)
        self._prefix_listener = None
        self._prefix_fetches: List[PrefixFetch] = []
        self.prefix_fetch_bytes = 0
        self.prefix_fetched_tokens = 0
        # transfer-pipeline state: the plan in effect per tenant, in-flight
        # tier-switch drains, and cold-start flags (first step after a
        # plan change has no prefetch from the previous iteration)
        self._live_plan: Dict[str, RemapPlan] = {
            n: identity_plan(self.store.models[n].num_layers)
            for n in self.tenants}
        self._drains: Dict[str, PlanDrain] = {}
        self._cold: Dict[str, bool] = {}
        self.bubble_time_s = 0.0       # accumulated fetch-miss stall
        self.decode_time_s = 0.0       # accumulated decode iteration time
        self.fetch_miss_events = 0
        # benchmark probe: wall time of each iteration that carried a
        # controller decision — synchronous apply serializes the whole
        # plan transition into it, incremental apply does not
        self.post_decision_first_dt: List[float] = []

    # --------------------------------------------- API (ServingRuntime)
    def submit(self, reqs: List[Request]) -> None:
        """Enqueue arrivals (``merge_arrivals`` semantics over the
        cursor'd arrival list: the cluster router feeds requests as their
        times come due, so the in-order path is an O(new) append; an
        out-of-order add re-sorts only the not-yet-consumed tail)."""
        reqs = sorted(reqs, key=lambda r: r.arrival)
        a = self._arrivals
        if len(a) > self._arr_pos and reqs \
                and reqs[0].arrival < a[-1].arrival:
            tail = sorted(a[self._arr_pos:] + reqs,
                          key=lambda r: r.arrival)
            del a[self._arr_pos:]
            a.extend(tail)
        else:
            a.extend(reqs)

    def busy(self) -> bool:
        return bool(self._arr_pos < len(self._arrivals) or any(
            t.queue or t.running or t.prefilling
            for t in self.tenants.values()))

    def horizon(self) -> float:
        """Arrival horizon of the next tick: admission compares against
        the CURRENT clock (``now`` advances after the iteration body), so
        requests with arrival <= now are admitted in the upcoming tick."""
        return self.now

    def pressure(self) -> float:
        """Fleet-comparable KV pressure in [0, 1]: used KV bytes over the
        currently available (mode-adjusted) capacity."""
        used = sum(t.kv_used() for t in self.tenants.values())
        cap = sum(self._capacity(t) for t in self.tenants.values())
        return used / cap if cap else 0.0

    def inflight(self) -> int:
        """Requests submitted but not finished (cluster-router load)."""
        return (len(self._arrivals) - self._arr_pos) + sum(
            len(t.queue) + len(t.running) + len(t.prefilling)
            for t in self.tenants.values())

    def draining(self) -> bool:
        """A remap/revert plan transition is mid-drain."""
        return bool(self._drains)

    def tenant_slacks(self) -> Dict[str, float]:
        """Live per-tenant SLO slack in SECONDS."""
        return self._slo_slack()

    def set_reversion_enabled(self, enabled: bool) -> None:
        """Gate *new* Dynamic Reversion decisions (coordinated remap:
        a cluster policy staggers revert drains across replicas). The
        gate can only RESTRICT: a runtime built with reversion disabled
        stays disabled no matter what a cluster policy grants."""
        self.controller.cfg.dynamic_reversion = \
            enabled and self._reversion_base

    # ------------------------------------------- fleet prefix cache hooks
    def set_prefix_listener(self, cb) -> None:
        """Install ``cb(model, tokens, now)``, invoked whenever this
        replica publishes a prefix into its local index (the cluster
        layer points this at ``FleetPrefixCache.publish``)."""
        self._prefix_listener = cb

    def prefix_probe(self, model: str, tokens) -> int:
        """Non-mutating longest-cached-prefix length in tokens (no LRU
        refresh, no stats) — what a fleet fetch verifies against before
        trusting a possibly-stale fleet index entry."""
        t = self.tenants.get(model)
        if t is None or t.index is None:
            return 0
        return t.index.peek(tokens)

    def prefix_costs(self, model: str, span_tokens: int,
                     prompt_tokens: int):
        """(bytes, t_fetch_s, t_recompute_s) for importing a cached
        ``span_tokens`` prefix of a ``prompt_tokens`` prompt — the
        replica-local quantities behind the transfer-vs-recompute call
        (``PerfModel.prefix_transfer_costs``)."""
        t = self.tenants[model]
        return t.perf.prefix_transfer_costs(span_tokens, prompt_tokens,
                                            t.kv_token_bytes)

    def export_prefix(self, model: str, tokens, n_tokens: int):
        """Hand the leading ``n_tokens`` cached KV to a peer. The
        simulator's KV is virtual — content-addressed keys guarantee the
        importer reconstructs identical blocks from the token stream — so
        there is nothing to ship; the engine returns real page arrays."""
        return None

    def import_prefix(self, model: str, tokens, n_tokens: int,
                      kv=None) -> int:
        """Install the leading full blocks of ``tokens[:n_tokens]`` into
        the local prefix index as if a local request had published them,
        and enqueue the host-link transfer for the blocks actually new
        here. The fetch drains through ``_advance_drains`` at remap-unit
        granularity, so it contends with in-flight tier-switch drains for
        the same link. Returns the newly imported tokens."""
        t = self.tenants.get(model)
        if t is None or t.index is None:
            return 0
        ps = t.index.page_size
        nblk = min(int(n_tokens), len(tokens)) // ps
        if nblk <= 0:
            return 0
        vpages = list(range(t._next_vpage, t._next_vpage + nblk))
        new, _path = t.index.insert(tokens, vpages, max_tokens=nblk * ps)
        t._next_vpage += nblk
        got = len(new) * ps
        if got:
            nbytes = got * t.kv_token_bytes
            self._prefix_fetches.append(PrefixFetch(
                nbytes, self._unit_bytes(model), label=model))
            self.prefix_fetch_bytes += nbytes
            self.prefix_fetched_tokens += got
        return got

    def prefix_snapshot(self, max_blocks: int = 0):
        """Every maximal cached prefix as ``(model, tokens)`` pairs — the
        donor side of scale-out pre-warm (the joining replica imports the
        spans through ``import_prefix``, charging real link bytes).
        Non-mutating. ``max_blocks`` bounds total blocks (0 = unbounded)."""
        out = []
        budget = max_blocks if max_blocks > 0 else None
        for n, t in self.tenants.items():
            if t.index is None:
                continue
            paths = t.index.paths(budget)
            if budget is not None:
                budget -= sum(len(p) // t.index.page_size for p in paths)
            out.extend((n, p) for p in paths)
        return out

    def prefix_stats(self):
        """Per-tenant prefix-cache counters (engine-shaped; empty when
        sharing is off)."""
        return {n: dataclasses.asdict(t.index.stats)
                | {"cached_blocks": t.index.num_blocks}
                for n, t in self.tenants.items() if t.index is not None}

    # ------------------------------------------- replica lifecycle hooks
    def withdraw_pending(self) -> List[Request]:
        """Pull back every submitted-but-not-yet-admitted arrival (the
        unconsumed tail of the arrival list) so the cluster layer can
        respill it to another replica at scale-in. Requests already
        admitted (queued/prefilling/running) stay: they finish here
        before teardown."""
        out = self._arrivals[self._arr_pos:]
        del self._arrivals[self._arr_pos:]
        return out

    def drain_for_removal(self) -> None:
        """Force reversion of every donated parameter segment: the
        cluster-level drain-before-teardown invariant (a replica must
        return its tenants' remapped layers to residency — the restore
        bytes crossing its host link like any Dynamic Reversion — before
        its KV is torn down; ``MetadataStore.deregister`` refuses while
        ``remapped_alpha > 0``). Idempotent: models already at identity
        with no in-flight drain are untouched."""
        if self.mode != "mirage":
            return
        for name in self.tenants:
            target = identity_plan(self.store.models[name].num_layers)
            inflight = self._drains.get(name)
            if inflight is not None and inflight.target == target:
                continue        # teardown drain already in flight
            cur = self._current_plan(name)
            if cur == target and inflight is None \
                    and self.store.models[name].remapped_alpha == 0:
                continue
            if self.store.models[name].remapped_alpha:
                self.store.apply_remap(name, 0)
            if self.shard_devices > 1:
                drain = ShardedPlanDrain(
                    cur, target, self._unit_bytes(name),
                    shards=self.shard_devices,
                    lockstep=self.shard_lockstep)
            else:
                drain = PlanDrain(cur, target, self._unit_bytes(name))
            if drain.done:
                self._drains.pop(name, None)
                self._live_plan[name] = target
            else:
                self._drains[name] = drain
            self._cold[name] = True

    def tick(self) -> float:
        """One scheduling iteration; returns the elapsed simulated
        seconds (0.0 for pure bookkeeping iterations: starvation-guard
        drops and idle fast-forwards, which move the clock directly)."""
        # starvation guard: a head request that can never fit (tenant
        # mis-sized for vllm mode) is dropped as failed after a bound.
        # _tok_live carries the same progress count the old per-tick
        # rescan computed, maintained at each token event
        if self.fast:
            tok_now = self._tok_live
        else:
            tok_now = sum(len(r.generated) for t in self.tenants.values()
                          for r in t.running) + len(self.finished) \
                + sum(r.prompt_len - r._prefill_left
                      for t in self.tenants.values() for r in t.prefilling)
        self._no_progress = \
            self._no_progress + 1 if tok_now == self._tokens_done else 0
        self._tokens_done = tok_now
        if self._no_progress > 10_000:
            for t in self.tenants.values():
                if t.queue and not t.running and not t.prefilling:
                    r = t.queue.popleft()
                    r.finished = True
                    self.finished.append(r)
                    self._tok_live += 1
            self._no_progress = 0
            return 0.0
        arr, pos = self._arrivals, self._arr_pos
        while pos < len(arr) and arr[pos].arrival <= self.now:
            r = arr[pos]
            pos += 1
            self.tenants[r.model].queue.append(r)
        self._arr_pos = pos
        if self._slo_enabled:
            slacks = self._slo_slack_fast() if self.fast \
                else self._slo_slack()
            self.store.note_slack(slacks)
            self.scheduler.observe_slack(slacks)
        pending = {n: len(t.queue) for n, t in self.tenants.items()}
        running = {n: len(t.running) + len(t.prefilling)
                   for n, t in self.tenants.items()}
        active = self.scheduler.schedule(pending, running, self.now)
        self.store.mark_active(active)
        if not active:
            # an in-flight tier switch keeps draining while the fleet
            # idles — the host link is free, and a replica frozen in
            # draining() state would eat the cluster policy's drain
            # budget (and the router's avoidance) forever
            dt = self._advance_drains()
            if dt:
                self.now += dt
                return dt
            # fast-forward to next arrival
            if self._arr_pos < len(self._arrivals):
                self.now = max(self.now,
                               self._arrivals[self._arr_pos].arrival)
            self._idle_guard += 1
            return 0.0
        self._idle_guard = 0
        self._sync_memory()
        # ONE shared prefill budget per iteration (mirrors the
        # engine): decode tokens of the active tenants are charged
        # first, every tenant's chunks then drain the remainder
        self._prefill_budget = self.scheduler.prefill_budget(
            sum(len(self.tenants[n].running) for n in active))
        n_decisions = len(self.controller.decisions_log)
        dt = 0.0
        if self.scheduler.__class__.__name__ == "SpatialScheduler":
            # concurrent tenants: iteration time = max over tenants
            dts = [self._tenant_iteration(self.tenants[n]) for n in active]
            dt = max(dts) if dts else 0.0
        else:
            for n in active:
                dt += self._tenant_iteration(self.tenants[n])
        dt += self._idle_control()
        dt += self._advance_drains()
        if len(self.controller.decisions_log) > n_decisions:
            self.post_decision_first_dt.append(dt)
        dt = max(dt, 1e-6)
        self.now += dt
        return dt

    def metrics(self) -> ServingMetrics:
        met = ServingMetrics.from_requests(self.finished, self.now)
        met.bubble_time = self.bubble_time_s
        met.bubble_fraction = (self.bubble_time_s / self.decode_time_s
                               if self.decode_time_s else 0.0)
        met._decode_time = self.decode_time_s
        met.unfinished = self.inflight()
        return met

    def run(self, requests: Optional[List[Request]] = None,
            max_time: float = 1e6) -> ServingMetrics:
        if requests is not None:
            self.submit(requests)
        while self.busy():
            if self.now > max_time or self._idle_guard > 2_000_000:
                break
            self.tick()
        if self.busy():
            warnings.warn(
                f"Simulator.run: time budget exhausted with "
                f"{self.inflight()} requests still unfinished — their "
                "latency never enters the tails; see metrics().unfinished",
                RuntimeWarning, stacklevel=2)
        return self.metrics()

    # ----------------------------------------------------------- iteration
    def _slo_slack(self) -> Dict[str, float]:
        """Per-tenant slack in SECONDS: PerfModel-predicted service times
        (``next_token_time`` for running requests, ``prefill_time`` of the
        queue head / remaining prompt for TTFT) lowered into the shared
        ``runtime_tenant_slack`` helper (the engine lowers step counts
        into the same helper; slack ordering is unit-invariant)."""
        out = {}
        for n, t in self.tenants.items():
            batch = max(len(t.running), 1)
            avg_ctx = (sum(r.total_len for r in t.running) / len(t.running)) \
                if t.running else 512.0
            t_next = t.perf.next_token_time(batch, avg_ctx)
            head = t.queue[0] if t.queue else None
            out[n] = runtime_tenant_slack(
                self.slo_specs[n], self.now, t.queue, t.running,
                t.prefilling,
                t_first_head=t.perf.prefill_time(head.prompt_len)
                if head else 0.0,
                t_next=t_next,
                t_first_remaining=lambda r, p=t.perf: p.prefill_time(
                    max(r._prefill_left, 1)))
        return out

    def _slo_slack_fast(self) -> Dict[str, float]:
        """``_slo_slack`` in O(queue-head + fresh + prefilling) per tenant.

        Every running request's slack is ``token_times[-1] + tbt - now -
        t_next``; the trailing ops are the same for all of them and IEEE
        add/sub are monotone, so the minimum over the batch equals the
        expression applied once to the minimum last-token time — which is
        the tenant timeline's tail for every request that has decoded
        since admission, leaving only the fresh (just-admitted) requests
        to scan. Bit-identical to the reference fold by monotonicity."""
        out = {}
        for n, t in self.tenants.items():
            spec = self.slo_specs[n]
            batch = max(len(t.running), 1)
            avg_ctx = (t._ctx_tokens / len(t.running)) \
                if t.running else 512.0
            t_next = t.perf.next_token_time(batch, avg_ctx)
            slack = math.inf
            if t.queue:
                head = t.queue[0]
                slack = min(slack, request_slack(
                    head, spec, self.now,
                    t.perf.prefill_time(head.prompt_len), t_next))
            if t.running:
                last = math.inf
                if len(t._fresh) < len(t.running):
                    last = t._timeline[-1]
                for r in t._fresh:
                    lt = r.token_times[-1]
                    if lt < last:
                        last = lt
                slack = min(slack,
                            last + spec.tbt_target - self.now - t_next)
            for r in t.prefilling:
                slack = min(slack, request_slack(
                    r, spec, self.now,
                    t.perf.prefill_time(max(r._prefill_left, 1)), t_next))
            out[n] = slack
        return out

    def _capacity(self, t: SimTenant) -> int:
        """Device KV capacity currently available to tenant t."""
        base = t.kv_capacity_base
        if self.mode == "mirage":
            base += sum(m.remapped_bytes for m in self.store.models.values())
        elif self.mode == "swap":
            base += self.hw.host_dram_bytes // 4
        return base

    def _tenant_iteration(self, t: SimTenant) -> float:
        dt = 0.0
        dt += self._admit(t)
        dt += self._prefill_step(t)
        dt += self._decode(t)
        return dt

    def _admit(self, t: SimTenant) -> float:
        dt = 0.0
        while t.queue and len(t.running) + len(t.prefilling) < t.max_batch:
            r = t.queue[0]
            # longest cached prefix: those tokens neither occupy new KV
            # bytes nor cost prefill FLOPs (at least one token always
            # recomputes, producing the first logits)
            match = None
            if t.index is not None:
                match = t.index.match(r.prompt, max_tokens=r.prompt_len - 1,
                                      record=False)
                # pin the path so our own reclaim below can't evict it
                t.index.acquire(match.nodes)
            matched = match.tokens if match else 0
            # shared admission watermark (scheduler.admission_watermark):
            # decode headroom per occupied slot (mid-prefill requests will
            # decode soon), lowered to KV bytes here and to allocator
            # pages in the engine
            headroom = admission_watermark(
                len(t.running) + len(t.prefilling), self.watermark_tokens,
                lambda tok: tok * t.kv_token_bytes)
            need = (r.total_len - matched + 1) * t.kv_token_bytes + headroom
            if t.kv_used() + need > self._capacity(t):
                t.cache_reclaim(t.kv_used() + need - self._capacity(t))
                if t.kv_used() + need > self._capacity(t) \
                        and self.mode != "vllm":
                    self._on_pressure(t)
                if t.kv_used() + need > self._capacity(t):
                    if match is not None:
                        t.index.release(match.nodes)
                    break
            t.queue.popleft()
            if match is not None:
                t.index.record_lookup(matched, r.prompt_len)
                t._paths[r.rid] = list(match.nodes)
                t._shared[r.rid] = matched
                r.prefix_matched_tokens += matched
            # cold-start reload of remapped layers overlaps prefill (§5.3)
            alpha = self.store.models[t.name].remapped_alpha
            reload = t.perf.reload_time(alpha, self._unit_bytes(t.name)) \
                if alpha else 0.0
            if self.prefill_chunk_tokens > 0:
                # chunked: admission reserves capacity only; the prompt is
                # computed by _prefill_step in bounded chunks interleaved
                # with decode iterations (reload overlaps the first chunk)
                r._prefill_left = r.prompt_len - matched
                r._reload_pending = reload
                t.prefilling.append(r)
                self._tok_live += matched
                t._priv_tokens += r.prompt_len - matched
                continue
            t.running.append(r)
            tp = t.perf.prefill_time(r.prompt_len - matched,
                                     **self._prefill_remap_kw(t))
            dt += max(tp, reload)
            now = self.now + dt
            r.t_first_token = now
            r.generated.append(0)
            r.token_times.append(now)
            t._priv_tokens += r.prompt_len + 1 - matched
            self._note_enter_running(t, r)
            if self.prefix_dedup and t.index is not None:
                # pre-flight batch dedup: publish the prompt's blocks NOW
                # (their KV exists once this iteration's prefill runs), so
                # same-round arrivals sharing the prefix match and fork
                # instead of racing N identical prefills to a post-finish
                # publish. Monolithic path only — a chunked prefill's KV
                # does not exist until its chunks complete.
                self._publish_admitted(t, r, matched)
        return dt

    def _publish_admitted(self, t: SimTenant, r: Request,
                          matched: int) -> None:
        """Early-publish an admitted request's full prompt blocks into the
        local index (and the fleet listener). The blocks ARE the request's
        own pages, so (a) they move from private to cache accounting —
        counted once, like the engine's ``cache_hold`` on a published page
        — and (b) the full path is pinned until the request finishes."""
        real = getattr(r, "_real_prompt_len", r.prompt_len)
        nblk = real // t.index.page_size
        if nblk == 0:
            return
        vpages = list(range(t._next_vpage, t._next_vpage + nblk))
        _new, path = t.index.insert(r.prompt, vpages, max_tokens=real)
        t._next_vpage += nblk
        pub = nblk * t.index.page_size
        if pub > matched:
            t._priv_tokens -= pub - matched
            t._shared[r.rid] = pub
        old = t._paths.pop(r.rid, None)
        if old:
            t.index.release(old)
        t.index.acquire(path)
        t._paths[r.rid] = path
        if self._prefix_listener is not None:
            self._prefix_listener(t.name, r.prompt[:real], self.now)

    def _note_enter_running(self, t: SimTenant, r: Request) -> None:
        """Bookkeeping at the moment a request joins ``t.running`` (its
        first token was just emitted): progress/context counters, and —
        fast path — the deferred-materialization anchors (decode round at
        admission, admission epoch for stale-heap-entry detection) plus
        the finish-event heap entry. The finish round mirrors the
        reference check ``len(generated) >= max_new_tokens`` evaluated
        after each round's append, with the first token pre-counted."""
        self._tok_live += 1
        t._ctx_tokens += r.prompt_len + 1
        if not self.fast:
            return
        t._admit_seq += 1
        r._round0 = t._rounds
        r._epoch = getattr(r, "_epoch", 0) + 1
        t._fresh.append(r)
        heapq.heappush(
            t._finish_heap,
            (t._rounds + max(r.max_new_tokens - 1, 1),
             t._admit_seq, r._epoch, r))

    def _flush_tokens(self, t: SimTenant, r: Request) -> None:
        """Materialize a fast-path request's deferred decode tokens: every
        decode round since admission appended one token at the tenant's
        shared round timestamp, so the per-request lists are exactly the
        timeline slice from its admission round."""
        extra = t._rounds - r._round0
        if extra > 0:
            r.generated.extend([0] * extra)
            r.token_times.extend(t._timeline[r._round0:])

    def _finish_fast(self, t: SimTenant, r: Request) -> None:
        """Fast-path twin of the reference finish branch in ``_decode``."""
        self._flush_tokens(t, r)
        r.finished = True
        _discard(t.running, r)
        self.finished.append(r)
        gen = len(r.generated)
        sh = t._shared.get(r.rid, 0)
        self._tok_live += 1 - gen
        t._priv_tokens -= r.total_len - sh
        t._ctx_tokens -= r.total_len
        self._retire(t, r)

    def _prefill_step(self, t: SimTenant) -> float:
        """One bounded prefill chunk per prefilling request, mirroring the
        engine's state machine: the iteration charges chunk-sized compute
        instead of a whole prompt, so decode iterations of other requests
        (and, via the global clock, other tenants) interleave — the
        head-of-line blocking a monolithic prefill inflicts on tail TBT is
        bounded by the chunk budget."""
        if not t.prefilling:
            return 0.0
        dt = 0.0
        for r in list(t.prefilling):
            chunk = min(self.prefill_chunk_tokens, self._prefill_budget,
                        r._prefill_left)
            if chunk <= 0:
                continue
            self._prefill_budget -= chunk
            step = t.perf.prefill_time(chunk, **self._prefill_remap_kw(t))
            reload = getattr(r, "_reload_pending", 0.0)
            if reload:
                step = max(step, reload)
                r._reload_pending = 0.0
            dt += step
            r._prefill_left -= chunk
            self._tok_live += chunk
            if r._prefill_left <= 0:
                _discard(t.prefilling, r)
                t.running.append(r)
                now = self.now + dt
                r.t_first_token = now
                r.generated.append(0)
                r.token_times.append(now)
                # prefilling contributed prompt_len progress tokens and
                # prompt-matched private tokens; as a running request it
                # contributes its one generated token and prompt+1 context
                self._tok_live -= r.prompt_len
                t._priv_tokens += 1
                self._note_enter_running(t, r)
        return dt

    def _current_plan(self, name: str) -> RemapPlan:
        """Plan in effect for ``name`` — the interim plan mid-drain."""
        drain = self._drains.get(name)
        return drain.current_plan if drain is not None \
            else self._live_plan[name]

    def _unit_bytes(self, name: str) -> int:
        """Bytes of one remap unit: an expert for expert-granular tenants,
        a pattern repeat otherwise."""
        t = self.tenants[name]
        return t.perf.expert_bytes if name in self._expert \
            else t.perf.unit_bytes

    def _prefill_remap_kw(self, t: SimTenant) -> Dict[str, float]:
        """Remap-aware prefill charging: only resident params read from
        HBM, cycling layers stream once over the host link. Gated on the
        LIVE plan, not the store's α — mid-drain the interim plan still
        streams layers the store already considers restored."""
        if self.mode != "mirage":
            return {}
        plan = self._current_plan(t.name)
        if not plan.m:
            return {}
        ub = self._unit_bytes(t.name)
        if t.name in self._expert:
            # prefill routes through every expert, so all remapped experts
            # stream once; the resident fraction is byte-accurate (only
            # expert FFN bytes are remappable, not the whole stack)
            rf = 1.0 - plan.alpha * ub / max(t.perf.param_bytes, 1)
            return {"resident_fraction": rf, "streamed_bytes": plan.m * ub}
        return {
            "resident_fraction": 1.0 - plan.alpha / max(plan.n, 1),
            "streamed_bytes": plan.m * ub,
        }

    def _decode(self, t: SimTenant) -> float:
        if not t.running:
            return 0.0
        # per-token page demand
        need = len(t.running) * t.kv_token_bytes
        stall = 0.0
        if t.kv_used() + need > self._capacity(t):
            t.cache_reclaim(t.kv_used() + need - self._capacity(t))
        if t.kv_used() + need > self._capacity(t):
            stall += self._on_pressure(t)
        batch = len(t.running)
        if batch == 0:
            return stall
        avg_ctx = (t._ctx_tokens / batch) if self.fast \
            else sum(r.total_len for r in t.running) / batch
        info = self.store.models[t.name]
        plan = self._current_plan(t.name)
        if self.mode == "mirage" and t.name in self._expert:
            dt = self._decode_expert(t, batch, avg_ctx, plan)
        elif self.mode == "mirage" and plan.m:
            # event-based per-layer prefetch pipeline: bubble only when a
            # fetch misses its layer slot; the first step after a plan
            # switch runs cold (no prefetch from the previous iteration)
            timing = t.perf.decode_step_timing(
                batch, avg_ctx, plan, cold=self._cold.pop(t.name, False))
            dt = timing.total
            self.bubble_time_s += timing.bubble_time
            self.fetch_miss_events += len(timing.misses)
            self.host_link_busy_s += plan.m * t.perf.unit_bytes \
                / self.hw.host_link_bw
        else:
            resident_fraction = \
                1.0 - info.remapped_alpha / max(info.num_layers, 1)
            dt = t.perf.decode_step_time(batch, avg_ctx, resident_fraction)
        if self.mode == "swap":
            overflow = max(t.kv_used() - t.kv_capacity_base, 0)
            self.swap_overflow_peak = max(self.swap_overflow_peak, overflow)
            dt = max(dt, t.perf.swap_step_time(overflow))
        dt += stall
        self.decode_time_s += dt
        now = self.now + dt
        self._tok_live += batch
        t._priv_tokens += batch
        t._ctx_tokens += batch
        if self.fast:
            # one timeline append stands in for the per-request token
            # appends (deferred to _flush_tokens); finishes come off the
            # event heap in admission order — the reference's running-list
            # iteration order — with stale entries (preempted/re-admitted
            # requests) skipped by their epoch
            t._timeline.append(now)
            t._rounds += 1
            t._fresh.clear()
            heap = t._finish_heap
            while heap and heap[0][0] <= t._rounds:
                _, _, epoch, r = heapq.heappop(heap)
                if r.finished or r._epoch != epoch:
                    continue
                self._finish_fast(t, r)
        else:
            for r in list(t.running):
                r.generated.append(0)
                r.token_times.append(now)
                if len(r.generated) >= r.max_new_tokens:
                    r.finished = True
                    _discard(t.running, r)
                    self.finished.append(r)
                    gen = len(r.generated)
                    sh = t._shared.get(r.rid, 0)
                    self._tok_live += 1 - gen
                    t._priv_tokens -= r.total_len - sh
                    t._ctx_tokens -= r.total_len
                    self._retire(t, r)
        return dt

    def _decode_expert(self, t: SimTenant, batch: int, avg_ctx: float,
                       plan: RemapPlan) -> float:
        """One decode iteration for an expert-granular MoE tenant: feed the
        trace's routing profile into the smoothed stats, derive per-layer
        expected cold-expert fetches from the interim residency, and
        resolve the step through the shared event pipeline (same charging
        as ``TransferEngine.note_moe_decode_step``)."""
        es = self._expert[t.name]
        routing = self.expert_routing.get(t.name)
        if routing is not None:
            es.observe(routing.counts_at(self.now, batch))
        E = es.num_experts
        # per-layer remapped sets under the interim flattened plan
        rem = [[] for _ in range(es.num_moe_layers)]
        for u in plan.cycle_layers:
            rem[u // E].append(u % E)
        loads = es.stats.loads()
        cold_counts = []
        for l, r_ in enumerate(rem):
            if not r_:
                cold_counts.append(0)
                continue
            if routing is not None:
                pe = routing.routed_probability(self.now, batch)[r_]
            else:
                pe = 1.0 - (1.0 - np.minimum(
                    loads[l][r_] * es.top_k, 1.0)) ** max(batch, 1)
            cold_counts.append(min(len(r_), int(round(float(np.sum(pe))))))
        eb = max(t.perf.expert_bytes, 1)
        rf = 1.0 - plan.alpha * eb / max(t.perf.param_bytes, 1)
        timing = t.perf.expert_decode_timing(
            batch, avg_ctx, n_moe_layers=es.num_moe_layers, top_k=es.top_k,
            cold_counts=cold_counts, resident_fraction=rf,
            cold=self._cold.pop(t.name, False))
        self.bubble_time_s += timing.bubble_time
        self.fetch_miss_events += len(timing.misses)
        self.host_link_busy_s += sum(cold_counts) * eb / self.hw.host_link_bw
        es.note_step_compute(timing.compute, batch)
        return timing.total

    def _retire(self, t: SimTenant, r: Request) -> None:
        """Publish the finished prompt's blocks into the prefix cache (the
        next turn of the conversation forks them) and drop the request's
        references. Only the prompt is published: simulated decode emits
        placeholder tokens, which the trace's synthetic responses never
        match, so publishing them would only create phantom blocks."""
        if t.index is None:
            return
        # publish only real tokens: preemption pads the prompt with zero
        # placeholders for the recompute, which no future prompt can match
        real = getattr(r, "_real_prompt_len", r.prompt_len)
        nblk = real // t.index.page_size
        vpages = list(range(t._next_vpage, t._next_vpage + nblk))
        new, _path = t.index.insert(r.prompt, vpages, max_tokens=real)
        t._next_vpage += nblk
        path = t._paths.pop(r.rid, None)
        if path:
            t.index.release(path)
        t._shared.pop(r.rid, None)
        if self._prefix_listener is not None and nblk:
            self._prefix_listener(t.name, r.prompt[:real], self.now)

    # ------------------------------------------------------------- pressure
    def _handle_decisions(self, decisions) -> float:
        """Install each decision's target plan. Incremental apply queues
        the cycle->resident loads behind a ``PlanDrain`` (advanced one
        remap unit per iteration by ``_advance_drains``); synchronous
        apply — the old behaviour, kept for the fig21 comparison — charges
        the whole transition to this step. Returns stall seconds."""
        stall = 0.0
        for d in decisions:
            t = self.tenants[d.model]
            target = d.plan
            if not self.uniform_selection and target.m \
                    and d.model not in self._expert:
                # contiguous-selection ablation (§5.4): same m, worst
                # layout — the event model produces the wrap-gap stall
                # (layer plans only: expert victim sets are routing-driven)
                cyc = tuple(range(target.m))
                target = RemapPlan(
                    target.n, target.alpha, target.m, cyc,
                    tuple(range(target.m, target.n)))
            cur = self._current_plan(d.model)
            if self.shard_devices > 1:
                # the decision applies to the whole shard set: every device
                # drains its own slice of each remap unit over its own host
                # link — in lock-step (one logical drain) or naively
                # staggered (the fig24 baseline)
                drain = ShardedPlanDrain(
                    cur, target, self._unit_bytes(d.model),
                    shards=self.shard_devices,
                    lockstep=self.shard_lockstep)
            else:
                drain = PlanDrain(cur, target, self._unit_bytes(d.model))
            if self.incremental_apply and not drain.done:
                self._drains[d.model] = drain
            else:
                self._drains.pop(d.model, None)
                self._live_plan[d.model] = target
                if drain.remaining_bytes:
                    # synchronous apply: the whole plan transfer serializes
                    # ahead of the next step
                    t_load = drain.remaining_bytes / self.hw.host_link_bw
                    stall += t_load
                    self.host_link_busy_s += t_load
            if self._current_plan(d.model) != cur:
                self._cold[d.model] = True  # schedule changed: cold restart
        return stall

    def _advance_drains(self) -> float:
        """Move every pending tier switch forward by one remap unit; the
        restored bytes cross the same host link the streaming uses, so
        their transfer time is charged to the iteration."""
        dt = 0.0
        for name in list(self._drains):
            drain = self._drains[name]
            used, _completed = drain.advance(self._unit_bytes(name))
            if used:
                t_used = used / self.hw.host_link_bw
                dt += t_used
                self.host_link_busy_s += t_used
            if drain.done:
                del self._drains[name]
                self._live_plan[name] = drain.target
                self._cold[name] = True    # plan changed: pipeline restarts
            elif getattr(drain, "last_advance_completions", 0):
                # independent per-shard drains: a shard flipped to the
                # target while the set must keep serving the interim —
                # its pipeline restarts cold against the rest of the set
                self._cold[name] = True
        # cross-replica prefix fetches ride the same link at the same
        # unit granularity: a tick that advances both a tier-switch drain
        # and a fetch charges both transfers' time — β-slot contention
        # between remap traffic and prefix imports is emergent here
        if self._prefix_fetches:
            still: List[PrefixFetch] = []
            for f in self._prefix_fetches:
                used, _ = f.advance(f.chunk_bytes)
                if used:
                    t_used = used / self.hw.host_link_bw
                    dt += t_used
                    self.host_link_busy_s += t_used
                if not f.done:
                    still.append(f)
            self._prefix_fetches = still
        if any(getattr(d, "partial", False) for d in self._drains.values()):
            self.shard_partial_drain_ticks += 1
        return dt

    def _on_pressure(self, t: SimTenant) -> float:
        """Returns stall seconds charged to this iteration."""
        if self.mode == "vllm":
            return self._preempt_youngest(t)
        if self.mode == "swap":
            return 0.0
        t_compute = {
            n: (tt.perf.t_compute_layer_decode
                if self.store.models[n].active
                else tt.perf.prefill_time(512) / tt.perf.repeats)
            for n, tt in self.tenants.items()}
        decisions = self.controller.step(kv_pressure=True, t_compute=t_compute)
        return self._handle_decisions(decisions)

    def _idle_control(self) -> float:
        """Dynamic reversion opportunity once per scheduler iteration;
        returns the stall seconds charged (sync apply only — incremental
        restores drain through ``_advance_drains``)."""
        if self.mode != "mirage":
            return 0.0
        self._sync_memory()
        t_compute = {n: tt.perf.t_compute_layer_decode
                     for n, tt in self.tenants.items()}
        decisions = self.controller.step(kv_pressure=False, t_compute=t_compute)
        return self._handle_decisions(decisions)

    def _preempt_youngest(self, t: SimTenant) -> float:
        """The shared ``preemption_victim`` choice (youngest running,
        best-effort tenants first — same key as the engine's
        ``_preempt_one``)."""
        victim = preemption_victim(
            (r for tt in self.tenants.values() for r in tt.running),
            self.slo_specs)
        if victim is None:
            return 0.0
        vt = self.tenants[victim.model]
        if self.fast:
            # materialize the deferred tokens first — the recompute stall
            # and prompt padding below read generated/total_len — then
            # invalidate the pending finish-heap entry and fresh slot
            self._flush_tokens(vt, victim)
            victim._epoch += 1
            try:
                _discard(vt._fresh, victim)
            except ValueError:
                pass
        gen = len(victim.generated)
        sh = vt._shared.get(victim.rid, 0)
        self._tok_live -= gen
        vt._priv_tokens -= victim.total_len - sh
        vt._ctx_tokens -= victim.total_len
        _discard(vt.running, victim)
        victim.preemptions += 1
        # recompute: prompt+generated re-prefilled on re-admission (prompt
        # token values preserved so re-admission can re-match its prefix;
        # simulated decode tokens are placeholders — remember where the
        # real tokens end so _retire never publishes the padding)
        if not hasattr(victim, "_real_prompt_len"):
            victim._real_prompt_len = victim.prompt_len
        victim.prompt = np.concatenate(
            [victim.prompt,
             np.zeros(len(victim.generated), np.int32)])
        victim.generated = []
        vt.queue.appendleft(victim)
        if vt.index is not None:
            path = vt._paths.pop(victim.rid, None)
            if path:
                vt.index.release(path)
            vt._shared.pop(victim.rid, None)
        # the paper: decode pauses for all active requests during eviction +
        # recompute; charge the recompute time as the stall
        return vt.perf.prefill_time(victim.total_len)

    def tier_metrics(self) -> Dict[str, ServingMetrics]:
        """Tail metrics per SLO tier (seconds clock)."""
        return ServingMetrics.per_tier(self.finished, self.slo_specs,
                                       makespan=self.now)

    # controller's MemoryInfo free_fraction is driven by byte accounting
    def _sync_memory(self):
        used = sum(t.kv_used() for t in self.tenants.values())
        page = self.store.memory.page_bytes
        self.store.note_kv_usage(used // page)
