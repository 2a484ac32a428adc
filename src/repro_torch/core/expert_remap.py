"""Expert-granular parameter remapping for MoE tenants (paper §4/§5 at a
finer unit).

The paper reclaims the parameter memory of whole models (or, per-token,
whole layers); for the MoE architectures this repo ships the natural remap
unit is far smaller: ONE EXPERT of one MoE layer. At any moment only
``top_k`` of ``num_experts`` experts per layer are touched per token, so
roughly ``1 - top_k/E`` of the expert FFN weights are cold — reclaimable
KV fuel even while the model is actively decoding, which layer-granular
remapping cannot touch (a whole MoE layer streams every expert it holds).

This module extends the remapping stack to that unit while **reusing** the
layer machinery unchanged:

  * experts flatten onto the circular unit index space
    ``unit = moe_layer * num_experts + expert`` (execution order), so
    ``RemapPlan``, ``PlanDrain``, the elastic page accounting, and the
    β ring-buffer event model (``simulate_decode_step``) all apply;
  * ``ExpertPlan`` — per-MoE-layer bitmask of resident experts, plus the
    *pinned* hot set (never victimized);
  * ``ExpertRoutingStats`` — exponentially-smoothed routing counts
    collected from ``MoE`` dispatch (or the simulator's synthetic router);
  * ``ExpertRemapState`` — the per-model manager the Remapping Controller
    consults: coldest-first victim selection under pins and per-layer
    residency floors, and the expected-cold-fetch feasibility bound (the
    expert analog of ``max_alpha_pipeline``: a donated expert only costs a
    host-link fetch on the steps it is actually routed to);
  * ``step_fetch_plan`` — the per-token fetch schedule: routed-to cold
    experts cycle through β double-buffered slots, resolved by the shared
    event pipeline exactly like cycling layers;
  * ``split_experts`` / ``merge_experts`` — the data-plane split along the
    expert axis (the expert analog of ``transfer_engine.split_blocks``);
  * ``residency_states`` — the {resident, remapped, in_flight} partition
    the residency fuzz suite asserts after every step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.layer_selection import RemapPlan, uniform_interval_layers
from repro_torch.core.transfer_pipeline import PlanDrain


EXPERT_PARAM_KEYS = ("w_in", "w_gate", "w_out")


def expert_unit(layer: int, expert: int, num_experts: int) -> int:
    """Flattened circular unit index of (moe_layer, expert)."""
    return layer * num_experts + expert


def unit_expert(unit: int, num_experts: int) -> Tuple[int, int]:
    """Inverse of ``expert_unit``."""
    return unit // num_experts, unit % num_experts


# ---------------------------------------------------------------------------
# residency plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExpertPlan:
    """Expert residency for one model: per-MoE-layer bitmask of resident
    experts. ``pinned`` is the hot set (subset of resident) that victim
    selection must never touch. The remapped complement is donated to the
    KV pool; a remapped expert streams over the host link on the steps it
    is routed to (``step_fetch_plan``)."""
    num_moe_layers: int
    num_experts: int
    resident: Tuple[Tuple[int, ...], ...]   # per layer, sorted expert ids
    pinned: Tuple[Tuple[int, ...], ...]     # per layer, subset of resident

    def __post_init__(self):
        if len(self.resident) != self.num_moe_layers \
                or len(self.pinned) != self.num_moe_layers:
            raise ValueError("per-layer tuples must cover every MoE layer")
        for res, pin in zip(self.resident, self.pinned):
            if list(res) != sorted(set(res)) or list(pin) != sorted(set(pin)):
                raise ValueError("expert sets must be sorted and unique")
            if not set(pin) <= set(res):
                raise ValueError("pinned experts must be resident")
            if res and not (0 <= res[0] and res[-1] < self.num_experts):
                raise ValueError("expert id out of range")

    @property
    def remapped(self) -> Tuple[Tuple[int, ...], ...]:
        all_e = set(range(self.num_experts))
        return tuple(tuple(sorted(all_e - set(r))) for r in self.resident)

    @property
    def alpha(self) -> int:
        """Donated expert units (the flattened plan's α)."""
        return sum(self.num_experts - len(r) for r in self.resident)

    def is_resident(self, layer: int, expert: int) -> bool:
        return expert in self.resident[layer]

    def freed_bytes(self, expert_bytes: int) -> int:
        return self.alpha * expert_bytes

    def to_remap_plan(self) -> RemapPlan:
        """Flatten onto the circular unit space (``unit = l*E + e``). The
        cycle set is the remapped experts (m == α: unlike cycling layers,
        a donated expert transfers only on the steps it is routed to, so
        no extra β units join the residency-level cycle — β buffers enter
        at the per-step ``step_fetch_plan``)."""
        n = self.num_moe_layers * self.num_experts
        cyc = tuple(sorted(
            expert_unit(l, e, self.num_experts)
            for l, rem in enumerate(self.remapped) for e in rem))
        res = tuple(u for u in range(n) if u not in set(cyc))
        return RemapPlan(n, len(cyc), len(cyc), cyc, res)


def identity_expert_plan(num_moe_layers: int, num_experts: int) -> ExpertPlan:
    all_res = tuple(tuple(range(num_experts)) for _ in range(num_moe_layers))
    empty = tuple(() for _ in range(num_moe_layers))
    return ExpertPlan(num_moe_layers, num_experts, all_res, empty)


def expert_plan_from_units(num_moe_layers: int, num_experts: int,
                           remapped_units: Sequence[int],
                           pinned: Optional[Sequence[Sequence[int]]] = None
                           ) -> ExpertPlan:
    """Rebuild an ``ExpertPlan`` from flattened remapped unit ids."""
    rem = [set() for _ in range(num_moe_layers)]
    for u in remapped_units:
        l, e = unit_expert(u, num_experts)
        rem[l].add(e)
    res = tuple(tuple(sorted(set(range(num_experts)) - r)) for r in rem)
    pin = tuple(tuple(sorted(p)) for p in pinned) if pinned is not None \
        else tuple(() for _ in range(num_moe_layers))
    return ExpertPlan(num_moe_layers, num_experts, res, pin)


def residency_states(plan: RemapPlan,
                     drain: Optional[PlanDrain] = None) -> Dict[int, str]:
    """Classify every flattened expert unit as exactly one of
    ``resident`` / ``remapped`` / ``in_flight``. Mid-drain, the interim
    plan's cycle set still carries the pending loads (they stream until
    paid for), so in_flight ⊂ interim cycle — the partition the residency
    fuzz asserts after every controller step."""
    cur = drain.current_plan if drain is not None and not drain.done else plan
    inflight = set(drain.to_load) if drain is not None else set()
    cyc = set(cur.cycle_layers)
    out = {}
    for u in range(cur.n):
        if u in inflight:
            out[u] = "in_flight"
        elif u in cyc:
            out[u] = "remapped"
        else:
            out[u] = "resident"
    return out


# ---------------------------------------------------------------------------
# routing statistics (EMA over dispatch counts)
# ---------------------------------------------------------------------------

class ExpertRoutingStats:
    """Exponentially-smoothed per-(MoE layer, expert) routing counts.

    ``observe`` takes raw assignment counts from ``MoE`` dispatch
    (``return_stats=True``) — shape [E] (one layer / broadcast) or [L, E].
    With no observations yet the load estimate is uniform (cold start:
    every expert equally hot, nothing is confidently cold)."""

    def __init__(self, num_moe_layers: int, num_experts: int,
                 decay: float = 0.8):
        self.num_moe_layers = num_moe_layers
        self.num_experts = num_experts
        self.decay = float(decay)
        self.counts = np.zeros((num_moe_layers, num_experts))
        self.updates = 0

    def observe(self, counts) -> None:
        c = np.asarray(counts, dtype=float)
        if c.ndim == 1:
            c = np.broadcast_to(c, (self.num_moe_layers, self.num_experts))
        if c.shape != (self.num_moe_layers, self.num_experts):
            raise ValueError(f"counts shape {c.shape}")
        self.counts = self.decay * self.counts + (1.0 - self.decay) * c
        self.updates += 1

    def loads(self) -> np.ndarray:
        """Per-layer routing probabilities, rows summing to 1."""
        if self.updates == 0:
            return np.full((self.num_moe_layers, self.num_experts),
                           1.0 / self.num_experts)
        tot = self.counts.sum(axis=1, keepdims=True)
        uniform = 1.0 / self.num_experts
        with np.errstate(invalid="ignore", divide="ignore"):
            p = np.where(tot > 0, self.counts / np.maximum(tot, 1e-12),
                         uniform)
        return p

    def hot_sets(self, k_hot: int) -> Tuple[Tuple[int, ...], ...]:
        """Per-layer top-``k_hot`` experts by smoothed load (the pin set)."""
        k = max(min(k_hot, self.num_experts), 0)
        if k == 0:
            return tuple(() for _ in range(self.num_moe_layers))
        p = self.loads()
        out = []
        for l in range(self.num_moe_layers):
            # stable hot set: ties broken by expert id
            order = np.lexsort((np.arange(self.num_experts), -p[l]))
            out.append(tuple(sorted(int(e) for e in order[:k])))
        return tuple(out)


# ---------------------------------------------------------------------------
# per-step fetch schedule (β ring-buffer event model, reused)
# ---------------------------------------------------------------------------

def step_fetch_plan(num_moe_layers: int, top_k: int,
                    cold_counts: Sequence[int], beta: int = 2) -> RemapPlan:
    """Per-token expert fetch schedule on the routed-slot circle.

    A decode step walks ``num_moe_layers * top_k`` routed-expert slots in
    execution order; ``cold_counts[l]`` of layer ``l``'s slots hit remapped
    experts and must cross the host link, double-buffered through β slots —
    the exact constraint set ``simulate_decode_step`` resolves for cycling
    layers. Cold slots spread uniformly inside each layer's slot range (the
    dispatch order within a layer is ours to choose, and uniform spacing
    maximizes the min circular gap — the paper's layer-selection theorem at
    expert grain)."""
    k = max(int(top_k), 1)
    n = max(num_moe_layers, 1) * k
    cyc: List[int] = []
    for l, c in enumerate(cold_counts):
        c = int(min(max(c, 0), k))
        if c:
            cyc.extend(l * k + s for s in uniform_interval_layers(k, c))
    cyc_t = tuple(sorted(cyc))
    m = len(cyc_t)
    res = tuple(i for i in range(n) if i not in set(cyc_t))
    return RemapPlan(n, max(m - max(beta, 1), 0), m, cyc_t, res)


# ---------------------------------------------------------------------------
# per-model manager (controller plug-in)
# ---------------------------------------------------------------------------

class ExpertRemapState:
    """Per-model expert-granular remap manager.

    The Remapping Controller stays unit-agnostic: an expert model registers
    ``L*E`` units of ``expert_bytes`` each in the Metadata Store, and the
    controller consults this manager for the two things that differ from
    layers — *which* units to victimize (coldest routed first, pinned hot
    experts and a per-layer residency floor excluded) and *how many* are
    feasible (expected cold-fetch time must hide under step compute, not
    the all-m-units-every-token layer bound)."""

    def __init__(self, num_moe_layers: int, num_experts: int, top_k: int,
                 expert_bytes: int, *, pin_fraction: float = 0.125,
                 min_resident: Optional[int] = None, decay: float = 0.8,
                 units_per_decision: Optional[int] = None,
                 hide_fraction: float = 0.5, batch_hint: int = 8):
        self.num_moe_layers = num_moe_layers
        self.num_experts = num_experts
        self.top_k = top_k
        self.expert_bytes = int(expert_bytes)
        self.stats = ExpertRoutingStats(num_moe_layers, num_experts, decay)
        self.pin_k = max(1, int(round(pin_fraction * num_experts)))
        self.min_resident = max(top_k if min_resident is None
                                else min_resident, 1)
        self.units_per_decision = max(
            1, num_experts // 8 if units_per_decision is None
            else int(units_per_decision))
        self.hide_fraction = hide_fraction
        self.batch_hint = max(int(batch_hint), 1)
        self._t_step = 0.0        # latest per-step compute estimate (s)
        # per-stats-version caches (victim order and pin sets only change
        # when the smoothed routing stats do — the controller re-derives
        # them many times per observation otherwise)
        self._victim_cache: Tuple[int, List[Tuple[int, int]]] = (-1, [])
        self._pin_cache: Tuple[int, Tuple[Tuple[int, ...], ...]] = (-1, ())

    # ------------------------------------------------------------- signals
    def observe(self, counts) -> None:
        self.stats.observe(counts)

    def note_step_compute(self, t_step: float, batch: int = 0) -> None:
        """Runtime feedback: latest decode-step compute time (and batch),
        the denominators of the feasibility bound."""
        if t_step > 0:
            self._t_step = float(t_step)
        if batch > 0:
            self.batch_hint = int(batch)

    # ---------------------------------------------------------------- plans
    def max_alpha(self) -> int:
        """Reclaimable bound: pins and the per-layer residency floor."""
        keep = max(self.pin_k, self.min_resident)
        return self.num_moe_layers * max(self.num_experts - keep, 0)

    def _pins(self) -> Tuple[Tuple[int, ...], ...]:
        """Cached per-layer pin sets for the current stats generation."""
        if self._pin_cache[0] != self.stats.updates:
            self._pin_cache = (self.stats.updates,
                               self.stats.hot_sets(self.pin_k))
        return self._pin_cache[1]

    def victim_order(self) -> List[Tuple[int, int]]:
        """(layer, expert) pairs coldest-first, excluding pinned hot sets
        and per-layer floors — the donation order ``plan_for_alpha``
        consumes a prefix of. Cached per stats generation: the controller
        probes many α values between routing observations."""
        if self._victim_cache[0] == self.stats.updates:
            return self._victim_cache[1]
        loads = self.stats.loads()
        pins = self._pins()
        keep = max(self.pin_k, self.min_resident)
        order: List[Tuple[float, int, int]] = []
        for l in range(self.num_moe_layers):
            pinned = set(pins[l])
            # per-layer floor: the keep hottest experts never donate
            floor_order = np.lexsort(
                (np.arange(self.num_experts), -loads[l]))
            protected = pinned | {int(e) for e in floor_order[:keep]}
            for e in range(self.num_experts):
                if e not in protected:
                    order.append((float(loads[l][e]), l, e))
        order.sort()
        result = [(l, e) for _, l, e in order]
        self._victim_cache = (self.stats.updates, result)
        return result

    def plan_for_alpha(self, alpha: int) -> Optional[ExpertPlan]:
        """Residency plan donating the ``alpha`` coldest eligible experts.
        Returns None when ``alpha`` exceeds the reclaimable bound."""
        if alpha < 0 or alpha > self.max_alpha():
            return None
        victims = self.victim_order()[:alpha]
        rem = [set() for _ in range(self.num_moe_layers)]
        for l, e in victims:
            rem[l].add(e)
        res = tuple(tuple(sorted(set(range(self.num_experts)) - rem[l]))
                    for l in range(self.num_moe_layers))
        return ExpertPlan(self.num_moe_layers, self.num_experts, res,
                          self._pins())

    # ---------------------------------------------------------- feasibility
    def expected_cold_fetches(self, plan: ExpertPlan,
                              batch: Optional[int] = None) -> np.ndarray:
        """Per-layer expected number of DISTINCT remapped experts routed
        to by a batch of ``batch`` tokens in one step — each costs one
        host-link fetch. P(expert e touched) = 1 - (1 - min(k·p_e, 1))^B
        under the usual independence approximation."""
        b = max(batch or self.batch_hint, 1)
        loads = self.stats.loads()
        out = np.zeros(self.num_moe_layers)
        for l, rem in enumerate(plan.remapped):
            if not rem:
                continue
            p = np.minimum(loads[l][list(rem)] * self.top_k, 1.0)
            out[l] = float(np.sum(1.0 - (1.0 - p) ** b))
        return out

    def feasible_alpha(self, t_fetch_expert: float,
                       batch: Optional[int] = None) -> int:
        """Largest α whose *expected* cold-expert fetch time hides under
        ``hide_fraction`` of the step compute — the expert analog of
        ``max_alpha_pipeline``. Coldest-first victims make the expected
        fetch load monotone in α, so binary search applies. With no
        compute estimate yet, donate nothing beyond the free tier (α whose
        expected fetches are ~0)."""
        hi = self.max_alpha()
        if hi == 0:
            return 0
        if t_fetch_expert <= 0:
            return hi
        budget = self.hide_fraction * self._t_step
        victims = self.victim_order()
        if not victims:
            return 0
        # cost(α) is a prefix sum over the coldest-first victim list: each
        # donated expert contributes its expected-touch probability × one
        # host-link fetch, independently of the others. One cumsum replaces
        # a binary search that rebuilt the plan per probe.
        b = max(batch or self.batch_hint, 1)
        loads = self.stats.loads()
        ls = np.fromiter((l for l, _ in victims), dtype=int, count=len(victims))
        es = np.fromiter((e for _, e in victims), dtype=int, count=len(victims))
        p = np.minimum(loads[ls, es] * self.top_k, 1.0)
        cum = np.cumsum(1.0 - (1.0 - p) ** b) * t_fetch_expert
        return min(int(np.searchsorted(cum, budget, side="right")), hi)


# ---------------------------------------------------------------------------
# data-plane split along the expert axis
# ---------------------------------------------------------------------------

def _map_expert_leaves(tree, fn):
    """Apply ``fn`` to expert-stacked leaves (keys in EXPERT_PARAM_KEYS),
    recursing through dicts/tuples/lists; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: (fn(v) if k in EXPERT_PARAM_KEYS else
                    _map_expert_leaves(v, fn))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map_expert_leaves(v, fn) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree


def split_experts(tree, resident: Sequence[int], expert_axis: int = 0):
    """Split expert-stacked params (``w_in``/``w_gate``/``w_out``, expert
    dimension at ``expert_axis``) into (resident_tree, cold_tree, ids) —
    the expert analog of ``transfer_engine.split_blocks``. Non-expert
    leaves (router, norms, attention) stay in the resident tree and are
    dropped from the cold tree."""
    res_ids = np.asarray(sorted(resident), np.int32)
    num = None
    for leaf in _expert_leaves(tree):
        num = leaf.shape[expert_axis]
        break
    if num is None:
        raise ValueError("tree has no expert-stacked leaves")
    cold_ids = np.asarray(
        [e for e in range(num) if e not in set(res_ids.tolist())], np.int32)

    def take(ids):
        def fn(a):
            return np.take(a, ids, axis=expert_axis) \
                if isinstance(a, np.ndarray) else a.take(ids, axis=expert_axis)
        return fn
    resident_tree = _map_expert_leaves(tree, take(res_ids))
    cold_tree = _prune_non_expert(_map_expert_leaves(tree, take(cold_ids)))
    return resident_tree, cold_tree, {
        "resident_ids": res_ids, "cold_ids": cold_ids, "num_experts": num}


def merge_experts(resident_tree, cold_tree, maps, expert_axis: int = 0,
                  absent: str = "host"):
    """Inverse of ``split_experts``: scatter both stacks back to the full
    expert dimension (bit-exact — the values only move). ``absent='zero'``
    zeroes the cold experts instead (test/ablation semantics: any routed-to
    remapped expert changes the output, so bit-identity against the dense
    run proves no routed expert was victimized)."""
    res_ids, cold_ids = maps["resident_ids"], maps["cold_ids"]
    num = maps["num_experts"]
    cold_leaves = iter(_expert_leaves(cold_tree))

    def fn(a_res):
        shape = list(a_res.shape)
        shape[expert_axis] = num
        out = np.zeros(shape, dtype=np.asarray(a_res).dtype)
        idx = [slice(None)] * out.ndim
        idx[expert_axis] = res_ids
        out[tuple(idx)] = np.asarray(a_res)
        if absent == "host" and len(cold_ids):
            a_cold = next(cold_leaves)
            idx[expert_axis] = cold_ids
            out[tuple(idx)] = np.asarray(a_cold)
        elif absent == "host":
            next(cold_leaves, None)
        return out
    return _map_expert_leaves(resident_tree, fn)


def _expert_leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in EXPERT_PARAM_KEYS:
                yield v
            else:
                yield from _expert_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _expert_leaves(v)


def _prune_non_expert(tree):
    """Keep only expert-stacked leaves (cold stacks hold no router etc.)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in EXPERT_PARAM_KEYS:
                out[k] = v
            else:
                sub = _prune_non_expert(v)
                if sub is not None:
                    out[k] = sub
        return out or None
    if isinstance(tree, (tuple, list)):
        subs = [_prune_non_expert(v) for v in tree]
        subs = [s for s in subs if s is not None]
        if not subs:
            return None
        return tuple(subs) if isinstance(tree, tuple) else subs
    return None
