"""Remapping Controller (paper §5, Algorithm 1).

Per serving-engine iteration (token granularity):
  1. *when to remap*   — out of KV pages => remap one unit from the next
     victim; *when to halt* — free fraction above the hysteresis threshold
     for `revert_patience` consecutive steps => revert one unit
     (Dynamic Reversion, §7.6.1).
  2. *which model*     — ``remap_policy.victim_order`` (inactive first,
     then best-effort tier, live SLO slack, priority, MRU/LRU; active
     models last).
  3. *how many layers* — α capped per model by (a) the per-model
     ``max_remap_fraction`` (cold-start guard) and (b) the event-pipeline
     feasibility bound ``transfer_pipeline.max_alpha_pipeline`` given
     measured T_c and profiled T_T: α is feasible when the simulated
     per-layer prefetch pipeline streams bubble-free, which honours the
     minimum circular gap instead of the closed-form scalar inequality
     T_T·N ≤ T_c (eqs. 4/5 remain in ``layer_selection`` as the analytic
     reference).
  4. *which layers*    — ``layer_selection.make_plan`` (uniform interval,
     m = α+1 or α+2 per eqs. 4/5).

The controller emits declarative ``RemapDecision``s; the serving engine (or
the simulator) owns execution — keeping this module scheduler- and
runtime-agnostic, as the paper requires.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import layer_selection as ls
from repro_torch.core import transfer_pipeline as tpl
from repro_torch.core.expert_remap import ExpertPlan, ExpertRemapState
from repro_torch.core.metadata_store import MetadataStore, ModelInfo
from repro_torch.core.remap_policy import next_revert, next_victim


@dataclasses.dataclass(frozen=True)
class RemapDecision:
    model: str
    new_alpha: int              # target remap level (units)
    plan: ls.RemapPlan          # uniform-interval schedule for new_alpha
    reverted: bool = False      # True when this is a Dynamic Reversion step
    # expert-granular models: the residency plan behind ``plan`` (which is
    # then its flattened unit-space projection); None for layer-granular
    expert_plan: Optional[ExpertPlan] = None


@dataclasses.dataclass
class ControllerConfig:
    victim_policy: str = "mru"
    use_priority: bool = True           # honour ModelInfo.priority in ordering
    double_buffer: bool = True
    buffer_mode: str = "dynamic"        # single (A) | double (B) | dynamic (C)
    # False = aggressive (paper Fig 17 "non-capped"): remap active models
    # beyond the transfer-overlap bound; decode absorbs the stall instead of
    # preempting. True = never let streaming become the bottleneck.
    pipeline_cap: bool = True
    dynamic_reversion: bool = True
    reversion_hysteresis: float = 0.2   # free fraction that triggers revert
    revert_patience: int = 8            # consecutive calm steps before revert
    units_per_step: int = 1             # remap granularity per iteration


class RemappingController:
    def __init__(self, store: MetadataStore, cfg: ControllerConfig,
                 t_transfer: Dict[str, float],
                 expert_state: Optional[Dict[str, ExpertRemapState]] = None):
        """``t_transfer``: per-model per-unit host->device transfer time,
        profiled offline (§5.3: sizes and link bandwidth known a priori).
        ``expert_state``: models remapped at EXPERT granularity — their
        Metadata Store unit is one expert (num_layers = L*E MoE units,
        layer_bytes = expert_bytes) and the manager supplies victim
        ordering (coldest routed experts, pins excluded) and the
        expected-cold-fetch feasibility bound in place of the layer
        pipeline bound."""
        self.store = store
        self.cfg = cfg
        self.t_transfer = t_transfer
        self.expert_state = expert_state or {}
        self._calm_steps = 0
        self.decisions_log: List[RemapDecision] = []

    # ------------------------------------------------------------------ api
    def step(self, *, kv_pressure: bool, t_compute: Dict[str, float]
             ) -> List[RemapDecision]:
        """One Algorithm-1 iteration.

        kv_pressure  — allocator could not serve this step's page demand.
        t_compute    — per-model current T_c estimate (decode iteration time
                       for active models, prefill time for inactive ones).
        """
        out: List[RemapDecision] = []
        if kv_pressure:
            self._calm_steps = 0
            for _ in range(self.cfg.units_per_step):
                d = self._remap_one(t_compute)
                if d is None:
                    break
                out.append(d)
        elif self.cfg.dynamic_reversion and self._calm():
            self._calm_steps += 1
            if self._calm_steps >= self.cfg.revert_patience:
                d = self._revert_one(t_compute)
                if d is not None:
                    out.append(d)
        else:
            self._calm_steps = 0
        self.decisions_log.extend(out)
        return out

    # ------------------------------------------------------------- internals
    def _calm(self) -> bool:
        mem = self.store.memory
        return (mem.free_fraction >= self.cfg.reversion_hysteresis
                and self.store.total_remapped_bytes() > 0)

    def _alpha_caps(self, t_compute: Dict[str, float]) -> Dict[str, int]:
        caps = {}
        for m in self.store.models.values():
            t_c = t_compute.get(m.name, 0.0)
            t_t = self.t_transfer.get(m.name, float("inf"))
            es = self.expert_state.get(m.name)
            if es is not None:
                # expert granularity: a donated expert only costs a fetch
                # on the steps it is routed to, so the bound is expected
                # cold-fetch time under the smoothed routing stats — far
                # looser than the every-token layer pipeline bound
                if m.active and self.cfg.pipeline_cap:
                    caps[m.name] = min(m.max_alpha_cap, es.feasible_alpha(t_t))
                else:
                    caps[m.name] = min(m.max_alpha_cap, es.max_alpha())
                continue
            if m.active:
                if not self.cfg.pipeline_cap:
                    caps[m.name] = m.max_alpha_cap
                else:
                    # transfers must hide under the model's own decode
                    # compute — decided by the event pipeline's bubble
                    # estimate, not the scalar T_c >= T_T inequality
                    caps[m.name] = tpl.max_alpha_pipeline(
                        m.num_layers, t_c, t_t, self.cfg.double_buffer,
                        self.cfg.buffer_mode)
            else:
                # inactive: bounded only by the cold-start fraction cap;
                # reload overlaps the (longer) prefill when reactivated
                caps[m.name] = m.max_alpha_cap
        return caps

    def _stride(self, name: str) -> int:
        """Units moved per decision: 1 layer, or a batch of experts (one
        expert is too small a step to relieve pressure in useful time)."""
        es = self.expert_state.get(name)
        return es.units_per_decision if es is not None else 1

    def _remap_one(self, t_compute) -> Optional[RemapDecision]:
        caps = self._alpha_caps(t_compute)
        victim = next_victim(self.store, self.cfg.victim_policy, caps,
                             self.cfg.use_priority)
        if victim is None:
            return None
        cap = min(victim.max_alpha_cap, caps.get(victim.name, victim.max_alpha_cap))
        new_alpha = min(victim.remapped_alpha + self._stride(victim.name), cap)
        plan, ep = self._plan(victim, new_alpha, t_compute)
        if plan is None:
            return None
        self.store.apply_remap(victim.name, new_alpha)
        return RemapDecision(victim.name, new_alpha, plan, expert_plan=ep)

    def _revert_one(self, t_compute) -> Optional[RemapDecision]:
        m = next_revert(self.store, self.cfg.victim_policy,
                        self.cfg.use_priority)
        if m is None:
            return None
        new_alpha = max(m.remapped_alpha - self._stride(m.name), 0)
        plan, ep = self._plan(m, new_alpha, t_compute)
        if plan is None:
            return None
        self.store.apply_remap(m.name, new_alpha)
        self._calm_steps = 0
        return RemapDecision(m.name, new_alpha, plan, reverted=True,
                             expert_plan=ep)

    def _plan(self, m: ModelInfo, alpha: int, t_compute):
        """(flattened RemapPlan, ExpertPlan | None) for ``alpha`` units."""
        es = self.expert_state.get(m.name)
        if es is not None:
            ep = es.plan_for_alpha(alpha)
            if ep is None:
                return None, None
            return ep.to_remap_plan(), ep
        if alpha == 0:
            return tpl.identity_plan(m.num_layers), None
        t_c = t_compute.get(m.name, 0.0)
        t_t = self.t_transfer.get(m.name, float("inf"))
        if m.active:
            try:
                return tpl.make_plan_pipeline(m.num_layers, alpha, t_c, t_t,
                                              self.cfg.double_buffer,
                                              self.cfg.buffer_mode), None
            except ValueError:
                if self.cfg.pipeline_cap:
                    return None, None
                # aggressive mode: schedule anyway; the pipeline stalls
        beta = 1 if self.cfg.buffer_mode == "single" or not self.cfg.double_buffer else 2
        m_layers = alpha + beta
        m_layers = min(m_layers, m.num_layers)
        cyc = tuple(ls.uniform_interval_layers(m.num_layers, m_layers))
        res = tuple(i for i in range(m.num_layers) if i not in set(cyc))
        return ls.RemapPlan(m.num_layers, alpha, m_layers, cyc, res), None
