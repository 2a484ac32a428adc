"""Shard sets: one tenant striped across N model-parallel devices.

A ``ShardSet`` is the cluster's routing/ticking unit for tenants too big
for one device: N shards spanning replicas serve one model under the
SERVING_RULES layout (heads/kv_heads/mlp/experts/vocab over the "model"
axis), and the whole set moves through the remap state machine together:

    SERVING ──RemapDecision──> DRAINING(lock-step) ──last slice──> SERVING'

The set wraps ONE backend runtime modeling a representative device (SPMD:
every shard executes the same schedule on its own slice — per-shard
param/KV/unit bytes from ``PerfModel(shards=N)``, collectives on the ICI
fabric, and each shard's remap slices crossing its own host link). The
**lock-step drain invariant**: a layer is never resident on some shards
while cycling on others — ``RemapDecision`` grant and ``PlanDrain``
advance are atomic over the set (``ShardedPlanDrain``), so
``draining()`` / ``partial_drain_ticks`` describe the set, not a device.

A 1-shard set is pure delegation and therefore byte-identical to the bare
runtime — the shard-set extension of the single-replica transparency
contract (tested for both backends).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.serving.request import Request, ServingMetrics
from repro_torch.serving.runtime import RuntimeConfig, ServingRuntime


class ShardSet:
    """``ServingRuntime`` facade over one tenant-striping shard set.

    Implements the full protocol by explicit delegation (so the
    ``runtime_checkable`` isinstance contract holds structurally) and
    forwards everything else (``run``, ``finished``, ``controller``, ...)
    to the wrapped runtime.
    """

    def __init__(self, runtime: ServingRuntime, shards: int = 1,
                 name: str = ""):
        self.runtime = runtime
        self.shards = max(int(shards), 1)
        self.name = name or f"shard_set_x{self.shards}"

    # ------------------------------------------------ ServingRuntime API
    def submit(self, reqs: List[Request]) -> None:
        self.runtime.submit(reqs)

    def tick(self) -> float:
        return self.runtime.tick()

    def busy(self) -> bool:
        return self.runtime.busy()

    def horizon(self) -> float:
        return self.runtime.horizon()

    def pressure(self) -> float:
        return self.runtime.pressure()

    def inflight(self) -> int:
        return self.runtime.inflight()

    def draining(self) -> bool:
        """True while ANY slice of a plan transition is in flight — the
        whole set is the drain unit, so the router's drain-awareness and
        the coordination policy's grants apply to all N shards at once."""
        return self.runtime.draining()

    def tenant_slacks(self) -> Dict[str, float]:
        return self.runtime.tenant_slacks()

    def set_reversion_enabled(self, enabled: bool) -> None:
        self.runtime.set_reversion_enabled(enabled)

    def metrics(self) -> ServingMetrics:
        return self.runtime.metrics()

    def tier_metrics(self) -> Dict[str, ServingMetrics]:
        return self.runtime.tier_metrics()

    # fleet prefix cache hooks delegate to the wrapped runtime (the whole
    # set shares one representative index, like everything else here)
    def set_prefix_listener(self, cb) -> None:
        self.runtime.set_prefix_listener(cb)

    def prefix_probe(self, model: str, tokens) -> int:
        return self.runtime.prefix_probe(model, tokens)

    def prefix_costs(self, model: str, span_tokens: int,
                     prompt_tokens: int):
        return self.runtime.prefix_costs(model, span_tokens, prompt_tokens)

    def export_prefix(self, model: str, tokens, n_tokens: int):
        return self.runtime.export_prefix(model, tokens, n_tokens)

    def import_prefix(self, model: str, tokens, n_tokens: int,
                      kv=None) -> int:
        return self.runtime.import_prefix(model, tokens, n_tokens, kv=kv)

    def prefix_snapshot(self, max_blocks: int = 0):
        return self.runtime.prefix_snapshot(max_blocks)

    # replica lifecycle: the whole set joins/leaves atomically, so the
    # respill and the forced teardown reversion delegate as one thing
    # (the sharded drain inside stays lock-step — ``ShardedPlanDrain``)
    def withdraw_pending(self) -> List[Request]:
        return self.runtime.withdraw_pending()

    def drain_for_removal(self) -> None:
        self.runtime.drain_for_removal()

    # ------------------------------------------------------------ extras
    @property
    def partial_drain_ticks(self) -> int:
        """Ticks where a layer was drained on some shards but not others
        (an invalid serving state; zero under lock-step coordination)."""
        return getattr(self.runtime, "shard_partial_drain_ticks", 0)

    def __getattr__(self, attr):
        return getattr(self.runtime, attr)

    def __repr__(self) -> str:
        return f"ShardSet({self.name}, shards={self.shards})"

    # ------------------------------------------------------- construction
    @classmethod
    def from_config(cls, config: RuntimeConfig, *, backend: str = "sim",
                    **kw) -> "ShardSet":
        """Lower a declare-once config to one shard set: the set's device
        count is the max declared ``TenantSpec.shards`` (fit-validated by
        the builder), and the backend models the representative device."""
        shards = config.shard_devices()
        return cls(config.build(backend, **kw), shards=shards)
