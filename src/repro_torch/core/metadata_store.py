"""Metadata Store (paper §4.1): model registry + memory accounting.

Host-side control plane (plain Python, like vLLM's scheduler): tracks which
tenants are active/inactive, their per-layer parameter footprint, current
remap state, and KV-pool utilization. The Remapping Controller reads and
writes only through this store, which keeps it scheduler-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class ModelInfo:
    name: str
    num_layers: int             # remappable units (pattern repeats)
    layer_bytes: int            # device bytes per remappable unit
    priority: int = 0           # lower = donates first (scheduler-provided)
    active: bool = False
    last_active_step: int = -1  # for MRU/LRU ordering
    remapped_alpha: int = 0     # units currently donated to KV
    max_remap_fraction: float = 0.5
    # SLO layer: tier drives victim/preemption ordering (best-effort
    # donates first); slack is the live signal fed by the runtime via
    # ``note_slack`` (inf = no deadline at risk / no SLO).
    slo_tier: str = "best_effort"
    slack: float = float("inf")

    @property
    def max_alpha_cap(self) -> int:
        return int(self.num_layers * self.max_remap_fraction)

    @property
    def remapped_bytes(self) -> int:
        return self.remapped_alpha * self.layer_bytes


@dataclasses.dataclass
class MemoryInfo:
    hbm_bytes: int
    page_bytes: int
    base_kv_pages: int          # statically reserved KV pool
    elastic_kv_pages: int = 0   # pages gained from remapped parameters
    used_pages: int = 0

    @property
    def total_pages(self) -> int:
        return self.base_kv_pages + self.elastic_kv_pages

    @property
    def free_pages(self) -> int:
        return self.total_pages - self.used_pages

    @property
    def free_fraction(self) -> float:
        t = self.total_pages
        return (self.free_pages / t) if t else 0.0


class MetadataStore:
    def __init__(self, memory: MemoryInfo):
        self.models: Dict[str, ModelInfo] = {}
        self.memory = memory
        self.step_counter = 0

    # ------------------------------------------------------------- registry
    def register(self, info: ModelInfo) -> None:
        if info.name in self.models:
            raise ValueError(f"model {info.name} already registered")
        self.models[info.name] = info

    def deregister(self, name: str) -> None:
        m = self.models.pop(name)
        if m.remapped_alpha:
            raise RuntimeError(f"deregistering {name} with remapped layers")

    # ------------------------------------------------------------- activity
    def mark_active(self, names: List[str]) -> None:
        self.step_counter += 1
        active = set(names)
        for m in self.models.values():
            m.active = m.name in active
            if m.active:
                m.last_active_step = self.step_counter

    def note_slack(self, slacks: Dict[str, float]) -> None:
        """Record per-model live SLO slack (runtime units). Victim
        selection reads it: high-slack models donate parameter memory
        first, low-slack (deadline-at-risk) models revert first."""
        for name, s in slacks.items():
            self.models[name].slack = s

    def inactive_models(self) -> List[ModelInfo]:
        return [m for m in self.models.values() if not m.active]

    def active_models(self) -> List[ModelInfo]:
        return [m for m in self.models.values() if m.active]

    # ---------------------------------------------------------------- memory
    def note_kv_usage(self, used_pages: int) -> None:
        self.memory.used_pages = used_pages

    def apply_remap(self, name: str, new_alpha: int) -> int:
        """Set a model's remap level; returns page delta added to the pool."""
        m = self.models[name]
        delta_units = new_alpha - m.remapped_alpha
        # per-unit page yield, so +1/-1 unit deltas are exactly symmetric
        delta_pages = delta_units * (m.layer_bytes // self.memory.page_bytes)
        m.remapped_alpha = new_alpha
        self.memory.elastic_kv_pages += delta_pages
        assert self.memory.elastic_kv_pages >= 0
        return delta_pages

    def total_remapped_bytes(self) -> int:
        return sum(m.remapped_bytes for m in self.models.values())
