"""Unified serving-runtime protocol + single-source runtime configuration.

The repo grows two runtimes on purpose — the *functional* ``ServingEngine``
(really executes models; clock = engine steps) and the *event-driven*
``Simulator`` (analytic PerfModel timing; clock = seconds) — but multi-tenant
claims are cluster-level: a router, a replica group, and a coordinated remap
policy must sit *above* either runtime without caring which one it is.
``ServingRuntime`` is that seam: the tick-granular protocol both runtimes
implement, and everything in ``repro_torch.cluster`` is written against it
alone.

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

``TenantSpec``/``RuntimeConfig`` are the declare-once half of the redesign:
one tenant spec (SLO in seconds, memory knobs, optional trace binding) is
*lowered* to engine units (steps/pages, via ``steps_per_second``) or
simulator units (seconds/bytes) instead of hand-maintaining parallel
``TenantConfig``/``SimTenantConfig`` literals per backend.

This is the PyTorch/CUDA port of ``repro.serving.runtime``. The engine
lowering runs on the card unless ``build("engine", device="cpu")`` says
otherwise. A tenant with ``shards > 1`` lowers to the simulator's SPMD
shard-set model; the engine, which executes one device, refuses it with
``NotImplementedError``, as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Protocol, runtime_checkable

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.request import (
    DECODE_WATERMARK_TOKENS, Request, ServingMetrics,
)
from repro_torch.serving.slo import SLOSpec


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


def scale_slo(slo: SLOSpec, k: float) -> SLOSpec:
    """Convert an SLOSpec between clocks (seconds -> engine steps):
    multiply finite targets by ``k``; inf (no target) stays inf."""
    if k == 1.0:
        return slo
    return SLOSpec(ttft_target=slo.ttft_target * k,
                   tbt_target=slo.tbt_target * k, tier=slo.tier)


@dataclasses.dataclass
class TenantSpec:
    """One hosted model, declared once and lowered per backend.

    ``slo`` targets are in SECONDS (the canonical clock); lowering to the
    engine multiplies them into steps via ``steps_per_second``. ``params``
    is only needed by the functional engine (real weights: a tree of
    tensors, shared by every engine lowered from this spec, which never
    writes into it); the simulator ignores it. ``trace`` optionally binds this tenant's workload — a
    ``TraceSpec`` or ``DiurnalSpec`` whose ``model`` field is overwritten
    with the tenant's name at generation time (``RuntimeConfig.trace``),
    so the tenant and its workload live in one declaration.
    """
    cfg: ModelConfig
    slo: SLOSpec = dataclasses.field(default_factory=SLOSpec)
    max_batch: int = 8
    # engine-only knobs (steps/pages world; the simulator's victim
    # ordering is tier/slack-driven, so priority has no sim lowering)
    priority: int = 0
    max_context: int = 64
    paged: bool = False
    params: Any = None
    # simulator-only knobs (seconds/bytes world)
    mem_fraction: float = 0.35
    # optional workload binding (TraceSpec | DiurnalSpec)
    trace: Any = None
    # model-parallel shard degree: this tenant is striped across a
    # ``shards``-device shard set (lowered through the SERVING_RULES
    # logical-axis layout — heads/kv_heads/mlp/experts/vocab over "model");
    # 1 = a full replica per device, the historical behaviour
    shards: int = 1

    def to_engine(self, steps_per_second: float = 1.0):
        """Lower to the functional engine's ``TenantConfig`` (SLO targets
        converted seconds -> engine steps)."""
        from repro_torch.serving.engine import TenantConfig
        if self.params is None:
            raise ValueError(
                "TenantSpec.params (model weights) is required to lower a "
                "tenant to the functional engine")
        if self.shards > 1:
            raise NotImplementedError(
                "the functional engine executes one device; tenants with "
                "shards > 1 lower to the simulator's SPMD shard-set model "
                "(use backend='sim')")
        return TenantConfig(
            cfg=self.cfg, params=self.params, max_batch=self.max_batch,
            max_context=self.max_context, priority=self.priority,
            slo=scale_slo(self.slo, steps_per_second), paged=self.paged)

    def to_sim(self):
        """Lower to the simulator's ``SimTenantConfig`` (SLO stays in
        seconds — the simulator's native clock)."""
        from repro_torch.serving.simulator import SimTenantConfig
        return SimTenantConfig(
            cfg=self.cfg, max_batch=self.max_batch,
            mem_fraction=self.mem_fraction, slo=self.slo,
            shards=self.shards)


@dataclasses.dataclass
class RuntimeConfig:
    """Declare-once serving configuration shared by both runtimes.

    Holds the tenant specs plus the scheduling/memory knobs that used to
    be duplicated across ``ServingEngine(...)`` and ``Simulator(...)``
    call sites. ``build("engine")`` / ``build("sim")`` lower it; any
    backend-specific extras (e.g. the simulator's ``victim_policy`` or
    the engine's ``base_kv_pages``) pass through ``**kw``.
    """
    tenants: Dict[str, TenantSpec]
    mode: str = "mirage"                  # mirage | vllm | swap
    scheduler: str = "temporal"           # temporal | spatial | slo
    quantum_steps: int = 32
    prefill_chunk_tokens: int = 0
    step_tokens: int = 0
    watermark_tokens: int = DECODE_WATERMARK_TOKENS
    slack_margin: float = 0.0             # seconds (scaled for the engine)
    prefix_sharing: bool = False
    # engine lowering: one second of spec time equals this many steps
    steps_per_second: float = 1.0
    # False: naive per-shard independent drains (the fig24 baseline);
    # True: RemapDecision application + PlanDrain proceed in lock-step
    # across every shard of a layer (the invariant)
    shard_lockstep: bool = True

    def shard_devices(self) -> int:
        """Devices per serving unit: the max declared shard degree (a
        shards=1 tenant on a bigger set holds a full replica per device)."""
        return max((s.shards for s in self.tenants.values()), default=1)

    def validate_fit(self, hw) -> None:
        """Fail fast — BEFORE any allocator OOMs mid-run — when a tenant's
        per-device resident footprint (sharded params + unsharded
        recurrent state) cannot fit one shard's HBM, with the minimum
        shard degree that would fit in the message."""
        from repro_torch.serving.perf_model import (
            PerfModel, const_state_bytes,
        )
        for name, spec in self.tenants.items():
            pm = PerfModel(spec.cfg, hw, shards=spec.shards)
            state = const_state_bytes(spec.cfg)
            resident = pm.param_bytes + state
            if resident > hw.hbm_bytes:
                need = -(-pm.total_param_bytes
                         // max(hw.hbm_bytes - state, 1))
                raise ValueError(
                    f"tenant {name!r} needs {resident / 2**30:.1f} GiB per "
                    f"device but {hw.name} has {hw.hbm_bytes / 2**30:.1f} "
                    f"GiB HBM (declared shards={spec.shards}); declare "
                    f"TenantSpec(shards>={need}) to stripe it across a "
                    f"shard set")

    def build(self, backend: str = "sim", **kw) -> ServingRuntime:
        if backend == "sim":
            return self.build_simulator(**kw)
        if backend == "engine":
            return self.build_engine(**kw)
        raise ValueError(f"unknown backend {backend!r}")

    def build_simulator(self, **kw) -> ServingRuntime:
        from repro_torch.serving.hw import GH200
        from repro_torch.serving.simulator import Simulator
        self.validate_fit(kw.get("hw", GH200))
        shard_kw = {}
        if self.shard_devices() > 1:
            # keep the 1-shard lowering literally identical to the
            # pre-shard-set call (byte-identical transparency contract)
            shard_kw = dict(shard_devices=self.shard_devices(),
                            shard_lockstep=self.shard_lockstep)
        return Simulator(
            {n: s.to_sim() for n, s in self.tenants.items()},
            mode=self.mode, scheduler=self.scheduler,
            quantum_steps=self.quantum_steps,
            prefill_chunk_tokens=self.prefill_chunk_tokens,
            step_tokens=self.step_tokens,
            watermark_tokens=self.watermark_tokens,
            slack_margin=self.slack_margin,
            prefix_sharing=self.prefix_sharing, **shard_kw, **kw)

    def build_engine(self, **kw) -> ServingRuntime:
        """Lower to the port's ``ServingEngine``; ``kw`` passes through
        (``device`` among them: the card unless the caller says "cpu")."""
        from repro_torch.serving.engine import ServingEngine
        k = self.steps_per_second
        return ServingEngine(
            {n: s.to_engine(k) for n, s in self.tenants.items()},
            mode=self.mode, scheduler=self.scheduler,
            quantum_steps=self.quantum_steps,
            prefill_chunk_tokens=self.prefill_chunk_tokens,
            step_tokens=self.step_tokens,
            watermark_tokens=self.watermark_tokens,
            slack_margin=self.slack_margin * k,
            prefix_sharing=self.prefix_sharing, **kw)

    def trace(self, seed: int = 0) -> List[Request]:
        """Generate the merged workload from every tenant's bound trace
        spec (``TenantSpec.trace``), each rebound to its tenant's name.
        Per-spec RNG streams keep the usual seed-stability contract."""
        from repro_torch.serving.trace_replay import ReplaySpec
        from repro_torch.serving.traces import (
            DiurnalSpec, TraceSpec, diurnal_trace, make_trace,
        )
        plain, diurnal, replayed = [], [], []
        for name, spec in self.tenants.items():
            if spec.trace is None:
                continue
            if not isinstance(spec.trace,
                              (DiurnalSpec, TraceSpec, ReplaySpec)):
                raise TypeError(
                    f"unsupported trace spec for tenant {name!r}: "
                    f"{type(spec.trace).__name__}")
            bound = dataclasses.replace(spec.trace, model=name)
            if isinstance(bound, ReplaySpec):
                replayed.extend(bound.requests(seed=seed))
            elif isinstance(bound, DiurnalSpec):
                diurnal.append(bound)
            else:
                plain.append(bound)
        reqs = make_trace(plain, seed=seed) \
            + diurnal_trace(diurnal, seed=seed) + replayed
        reqs.sort(key=lambda r: r.arrival)
        return reqs
