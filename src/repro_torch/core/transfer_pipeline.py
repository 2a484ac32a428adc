"""Event-based model of the per-layer parameter-fetch pipeline (paper
§4.1/§6) — THE shared transfer-timing source of truth for both runtimes.

The paper's headline mechanism is a per-layer prefetch pipeline: a decode
iteration walks the layer schedule in circular order; cycling layers are
fetched host->HBM into one of β transfer-buffer slots while earlier layers
compute. A scalar ``max(compute, hbm, stream)`` collapses the pipeline's
bubble structure — it cannot tell a fetch that hides perfectly from one
that misses its layer slot by a hair every round. This module replaces the
scalar with a small discrete-event simulation:

  * the host link is a single FIFO resource (fetches serialize);
  * a fetch for the k-th cycling layer may start once the link is free AND
    its ring-buffer slot (k mod β) is free — a slot is released when the
    compute of the layer previously occupying it finishes;
  * compute of layer i starts at max(previous layer's finish, the layer's
    fetch-ready time); the difference is a *bubble* (a fetch-miss event).

Because every constraint is monotone, evaluating a fetch's start time
lazily when the walk reaches its layer is equivalent to an eager
prefetcher that issues fetches as early as possible — exactly XLA's
latency-hiding scheduler, and the paper's double-buffered pipeline.

``simulate_decode_step`` runs the cyclic schedule for a few rounds and
reports either the cold first round (the step right after a plan switch,
when no prefetch from a previous iteration exists) or the converged
steady-state round. With m == 0 it reduces exactly to ``n * t_c`` — the
scalar model — a property the PerfModel asserts.

``PlanDrain`` is the runtime-agnostic pending-plan state machine behind
the Transfer Engine's async apply queue: a tier switch from plan A to
plan B must load every layer that moves cycle->resident over the host
link (layer_bytes each) while drops (resident->cycle) are free — the host
always holds the full copy. Mid-drain, the *interim* plan keeps the
not-yet-loaded layers in the cycle set so per-token fetches stay
consistent; ``advance(budget_bytes)`` moves the transition forward one
budget slice at a time, so a remap decision's first decode step no longer
pays the whole plan transfer up front.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.layer_selection import RemapPlan, uniform_interval_layers


# ---------------------------------------------------------------------------
# step timing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FetchMiss:
    """A cycling layer whose fetch was not ready when compute reached it."""
    layer: int
    wait: float          # bubble seconds contributed by this miss


@dataclasses.dataclass(frozen=True)
class StepTiming:
    """One decode iteration, resolved by the event model."""
    total: float                       # iteration wall time
    compute: float                     # stall-free lower bound (n * t_c)
    bubble_time: float                 # sum of fetch-miss waits
    misses: Tuple[FetchMiss, ...]      # per-layer fetch-miss events
    link_busy: float                   # host-link busy time this iteration

    @property
    def bubble_fraction(self) -> float:
        return self.bubble_time / self.total if self.total > 0 else 0.0


def identity_plan(n: int) -> RemapPlan:
    """The m=0 no-remap plan (every layer resident)."""
    return RemapPlan(n, 0, 0, (), tuple(range(n)))


def _round(n: int, cyc: frozenset, tf: float,
           link_free: float, slot_free: Tuple[float, ...], t: float, k: int):
    """Walk one round of the circular layer schedule (t_c normalized to 1;
    the ring-buffer width is ``len(slot_free)``).

    Returns (round_time, bubble, misses, link_busy, state') where state' is
    the carried pipeline state (link_free, slot_free, t, k)."""
    slot_free = list(slot_free)
    start = t
    bubble = 0.0
    link_busy = 0.0
    misses: List[Tuple[int, float]] = []
    for layer in range(n):
        if layer in cyc:
            slot = k % len(slot_free)
            s = max(link_free, slot_free[slot])
            ready = s + tf
            link_free = ready
            link_busy += tf
            wait = ready - t
            if wait > 1e-12:
                bubble += wait
                misses.append((layer, wait))
                t = ready
            t += 1.0
            slot_free[slot] = t     # buffer released once compute consumed it
            k += 1
        else:
            t += 1.0
    return (t - start, bubble, tuple(misses), link_busy,
            (link_free, tuple(slot_free), t, k))


@lru_cache(maxsize=1 << 16)
def _simulate_norm(n: int, cycle: Tuple[int, ...], beta: int, ratio: float,
                   cold: bool, max_rounds: int = 8):
    """Normalized (t_c = 1, t_f = ratio) pipeline run. Returns the measured
    round: round 0 for a cold pipeline (no prefetch from a previous
    iteration), else the converged steady-state round."""
    cyc = frozenset(cycle)
    state = (0.0, tuple([0.0] * max(beta, 1)), 0.0, 0)
    prev_time = None
    out = None
    for r in range(max_rounds):
        rt, bubble, misses, busy, state = _round(n, cyc, ratio, *state)
        out = (rt, bubble, misses, busy)
        if cold and r == 0:
            return out
        if prev_time is not None and abs(rt - prev_time) <= 1e-12:
            break
        prev_time = rt
    return out


def _quantize(x: float, digits: int = 4) -> float:
    """Round to ``digits`` significant figures — cache key for the
    normalized simulation (timing error << model error, hit rate high)."""
    if x <= 0.0 or not math.isfinite(x):
        return x
    mag = 10.0 ** (digits - 1 - math.floor(math.log10(x)))
    return round(x * mag) / mag


def simulate_decode_step(plan: RemapPlan, t_layer_compute: float,
                         t_layer_fetch: float, *,
                         cold: bool = False) -> StepTiming:
    """Resolve one decode iteration under ``plan``.

    ``t_layer_compute`` — per-layer compute budget (the bandwidth-bound
    scalar iteration time / n, so the HBM term is folded in);
    ``t_layer_fetch`` — host->HBM time for one cycling layer's parameters;
    ``cold=True`` — the first iteration after a plan switch, when no
    prefetch from the previous iteration exists (β slots start empty).
    """
    n = max(plan.n, 1)
    base = n * t_layer_compute
    if plan.m == 0 or t_layer_fetch <= 0.0:
        return StepTiming(base, base, 0.0, (), 0.0)
    if t_layer_compute <= 0.0:
        # degenerate: pure serial fetch chain
        total = plan.m * t_layer_fetch
        misses = tuple(FetchMiss(l, t_layer_fetch) for l in plan.cycle_layers)
        return StepTiming(total, 0.0, total, misses, total)
    beta = max(plan.m - plan.alpha, 1)
    ratio = _quantize(t_layer_fetch / t_layer_compute)
    rt, bubble, misses, busy = _simulate_norm(
        n, plan.cycle_layers, beta, ratio, cold)
    s = t_layer_compute
    return StepTiming(
        total=rt * s, compute=base, bubble_time=bubble * s,
        misses=tuple(FetchMiss(l, w * s) for l, w in misses),
        link_busy=busy * s)


def sync_step_time(plan: RemapPlan, t_layer_compute: float,
                   t_layer_fetch: float) -> float:
    """The no-overlap reference: compute and transfers fully serialize.
    Its stall over the compute bound is ``m * t_fetch`` — the quantity the
    pipeline must strictly beat whenever fetches can hide (β ≥ 2,
    t_fetch < t_compute)."""
    return plan.n * t_layer_compute + plan.m * t_layer_fetch


# ---------------------------------------------------------------------------
# pipeline-based feasibility (supersedes the closed-form eqs. 4/5 caps)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1 << 12)
def uniform_plan(n: int, alpha: int, m: int) -> RemapPlan:
    """Uniform-interval plan with explicit m — THE plan constructor shared
    by feasibility scans, benchmarks, and tests. Cached: RemapPlan is
    frozen and the controller rebuilds the same handful of plans on every
    feasibility scan."""
    cyc = tuple(uniform_interval_layers(n, m))
    res = tuple(i for i in range(n) if i not in set(cyc))
    return RemapPlan(n, alpha, m, cyc, res)


def plan_bubble(plan: RemapPlan, t_c: float, t_t: float) -> float:
    """Steady-state bubble seconds per iteration for ``plan``."""
    return simulate_decode_step(plan, t_c, t_t).bubble_time


def _hides(n: int, alpha: int, beta: int, t_c: float, t_t: float) -> bool:
    """True when the uniform plan with m = alpha + beta streams bubble-free
    in steady state — the event-model replacement for eqs. 4/5."""
    m = alpha + beta
    if m > n:
        return False
    if t_c <= 0.0:
        return t_t <= 0.0
    bubble = plan_bubble(uniform_plan(n, alpha, m), t_c, t_t)
    return bubble <= 1e-9 * n * t_c


def choose_m_pipeline(n: int, alpha: int, t_c: float, t_t: float,
                      double_buffer: bool = True,
                      mode: str = "dynamic") -> int:
    """``layer_selection.choose_m`` with feasibility decided by the event
    pipeline's bubble estimate instead of the closed-form inequalities.
    The event model honours the *minimum* circular gap (the real
    per-transfer budget), so it is strictly more accurate on uneven
    floor-spaced schedules. Returns 0 when the scheme cannot hide the
    transfers."""
    if alpha <= 0:
        return 0
    if not double_buffer:
        mode = "single"
    if mode == "single":
        return alpha + 1 if _hides(n, alpha, 1, t_c, t_t) else 0
    if mode == "double":
        return alpha + 2 if _hides(n, alpha, 2, t_c, t_t) else 0
    if _hides(n, alpha, 1, t_c, t_t):
        return alpha + 1
    if _hides(n, alpha, 2, t_c, t_t):
        return alpha + 2
    return 0


def max_alpha_pipeline(n: int, t_c: float, t_t: float,
                       double_buffer: bool = True,
                       mode: str = "dynamic") -> int:
    """Largest α whose transfers still hide under compute (event model)."""
    best = 0
    for a in range(1, n):
        if choose_m_pipeline(n, a, t_c, t_t, double_buffer, mode):
            best = a
        else:
            break
    return best


def make_plan_pipeline(n: int, alpha: int, t_c: float, t_t: float,
                       double_buffer: bool = True,
                       mode: str = "dynamic") -> RemapPlan:
    """Uniform-interval plan validated by the event pipeline (α=0 no-op).
    Raises ValueError when no buffering scheme hides the transfers, same
    contract as ``layer_selection.make_plan``."""
    if alpha == 0:
        return identity_plan(n)
    m = choose_m_pipeline(n, alpha, t_c, t_t, double_buffer, mode)
    if m == 0:
        raise ValueError(
            f"alpha={alpha} infeasible for n={n}, Tc={t_c}, Tt={t_t}"
            " (pipeline bubble)")
    return uniform_plan(n, alpha, m)


# ---------------------------------------------------------------------------
# pending-plan state machine (async tier switches)
# ---------------------------------------------------------------------------

class PlanDrain:
    """Incremental transition ``current`` -> ``target``.

    Layers moving resident->cycle are dropped immediately when the switch
    *shrinks* device residency (a remap: the donated memory is gone now —
    the host holds the full copy, so drops are free). Layers moving
    cycle->resident must each cross the host link (``layer_bytes``);
    until the whole transition is paid for they stay in the *interim*
    plan's cycle set, so per-token fetches remain consistent mid-drain:

      * **reversion** (target α < current α): nothing must be dropped
        early — the current schedule stays valid and feasible while the
        restored layers come home, so the interim IS the current plan
        (no cold restart, no extra streamed layers);
      * **remap / relayout** (target α ≥ current α): drops apply now;
        interim cycle = target cycle ∪ pending loads. β is a hardware
        resource (the ring-buffer slot count), not a function of how
        many layers happen to be in flight: the interim keeps the
        target's β by carrying α = m' − β, so in-flight layers never get
        phantom buffer slots (and the HBM charge 1 − α/n reads only the
        n − m' + β device-held stacks).

    The interim plan is fixed at construction and hops to the target in
    ONE step when the drain completes — re-deriving it per completed
    layer would force the functional engine into a full re-split (and a
    fresh XLA executable) per layer.
    """

    def __init__(self, current: RemapPlan, target: RemapPlan,
                 layer_bytes: int):
        if current.n != target.n:
            raise ValueError("plan transition across different layer counts")
        self.target = target
        self.layer_bytes = max(int(layer_bytes), 1)
        resident_t = set(target.resident_layers)
        self.to_load: List[int] = [
            l for l in current.cycle_layers if l in resident_t]
        self.transition_bytes = len(self.to_load) * self.layer_bytes
        self._partial = 0          # bytes paid toward to_load[0]
        if not self.to_load:
            self._interim = target
        elif target.alpha < current.alpha:
            self._interim = current
        else:
            beta = target.m - target.alpha if target.m \
                else max(current.m - current.alpha, 1)
            cyc = tuple(sorted(
                set(target.cycle_layers) | set(self.to_load)))
            res = tuple(i for i in range(target.n) if i not in set(cyc))
            self._interim = RemapPlan(
                target.n, max(len(cyc) - beta, 0), len(cyc), cyc, res)

    # ------------------------------------------------------------- inspect
    @property
    def done(self) -> bool:
        return not self.to_load

    @property
    def remaining_bytes(self) -> int:
        return len(self.to_load) * self.layer_bytes - self._partial

    @property
    def current_plan(self) -> RemapPlan:
        """The plan in effect right now (== target once drained)."""
        return self.target if not self.to_load else self._interim

    # ------------------------------------------------------------- advance
    def advance(self, budget_bytes) -> Tuple[int, List[int]]:
        """Move up to ``budget_bytes`` of the transition over the link.
        Returns (bytes actually used, layers that became resident)."""
        if not self.to_load:
            return 0, []
        used = min(budget_bytes, self.remaining_bytes)
        used = int(used) if math.isfinite(used) else self.remaining_bytes
        self._partial += used
        completed: List[int] = []
        while self.to_load and self._partial >= self.layer_bytes:
            self._partial -= self.layer_bytes
            completed.append(self.to_load.pop(0))
        return used, completed


class ShardedPlanDrain:
    """``PlanDrain`` generalized to a layer striped across N model-parallel
    shards: each shard owns a ``slice_bytes`` slice of every remap unit and
    drains it over its *own* host link.

    Two coordination regimes (the fig24 comparison):

      * **lockstep** (the invariant this repo enforces in production): all
        shards advance the same transition in the same tick — their drains
        are one logical drain over the per-shard slice, the interim plan is
        shared, and a layer is never resident on some shards but cycling on
        others. One cold restart when the set flips to the target plan.
      * **independent** (the naive baseline): each shard's controller
        applies the decision on its own clock, modeled as per-shard drains
        staggered ``skew`` ticks apart. The *set* can only serve the target
        plan once the LAST shard finishes, so the effective plan stays the
        interim for the whole stagger window; every shard that flips early
        forces a set-wide pipeline cold restart, and every tick where some
        shards are done while others are not is a **partially-drained
        layer** — an invalid serving state the lock-step regime makes
        unrepresentable.

    API-compatible with ``PlanDrain`` (``done`` / ``remaining_bytes`` /
    ``current_plan`` / ``target`` / ``advance``) so the simulator's drain
    registry holds either interchangeably. ``advance`` additionally records
    ``last_advance_completions`` (shards that finished this call) and the
    ``partial`` property reports the invalid some-done-some-not state.
    """

    def __init__(self, current: RemapPlan, target: RemapPlan,
                 slice_bytes: int, *, shards: int = 1,
                 lockstep: bool = True, skew: int = 1):
        self.shards = max(int(shards), 1)
        self.lockstep = lockstep
        self.target = target
        if lockstep or self.shards == 1:
            self._drains = [PlanDrain(current, target, slice_bytes)]
            self._delays = [0]
        else:
            self._drains = [PlanDrain(current, target, slice_bytes)
                            for _ in range(self.shards)]
            self._delays = [i * max(int(skew), 0)
                            for i in range(self.shards)]
        self.layer_bytes = self._drains[0].layer_bytes
        self.transition_bytes = self._drains[0].transition_bytes
        self.last_advance_completions = 0

    # ------------------------------------------------------------- inspect
    @property
    def done(self) -> bool:
        return all(d.done for d in self._drains)

    @property
    def partial(self) -> bool:
        """Some shards drained, some not — a layer partially resident
        across its shard set (never true under lockstep)."""
        done = sum(1 for d in self._drains if d.done)
        return 0 < done < len(self._drains)

    @property
    def remaining_bytes(self) -> int:
        return max(d.remaining_bytes for d in self._drains)

    @property
    def current_plan(self) -> RemapPlan:
        """The plan the SET can serve: the shared interim until every
        shard is done (all inner drains share one interim by
        construction), the target after."""
        for d in self._drains:
            if not d.done:
                return d.current_plan
        return self.target

    # ------------------------------------------------------------- advance
    def advance(self, budget_bytes) -> Tuple[int, List[int]]:
        """One tick of per-shard link budget. Each not-yet-started shard
        burns a delay tick instead (the independent regime's stagger);
        wall-clock cost is the max over shards since links run in
        parallel. Returns (max bytes used on any shard, layers that
        became resident on the LAST shard to hold them — i.e. resident
        set-wide)."""
        used_max = 0
        flips = 0
        completed_set: List[int] = []
        for i, d in enumerate(self._drains):
            if d.done:
                continue
            if self._delays[i] > 0:
                self._delays[i] -= 1
                continue
            used, _completed = d.advance(budget_bytes)
            used_max = max(used_max, used)
            if d.done:
                flips += 1
                if all(o.done for o in self._drains):
                    completed_set = list(_completed)
        self.last_advance_completions = flips
        return used_max, completed_set


class PrefixFetch:
    """A shared-prefix KV span crossing the host link from a warm replica
    into a cold one (the fleet prefix cache's transfer path).

    API-matches ``PlanDrain``'s byte-drain surface (``done`` /
    ``remaining_bytes`` / ``advance(budget) -> (used, _)``) so the runtime
    accounts prefix fetches and remap drains through the SAME per-tick
    link budget: both draw β-slot-sized chunks from ``host_link_bw``, so a
    tier-switch drain in flight stretches a concurrent prefix fetch and
    vice versa — the contention is emergent, not configured.
    """

    def __init__(self, total_bytes: int, chunk_bytes: int, label: str = ""):
        self.total_bytes = max(int(total_bytes), 0)
        #: per-advance budget — one β-slot-sized unit, the same granularity
        #: remap traffic moves at (callers pass the runtime's unit size)
        self.chunk_bytes = max(int(chunk_bytes), 1)
        self.label = label
        self._paid = 0

    @property
    def done(self) -> bool:
        return self._paid >= self.total_bytes

    @property
    def remaining_bytes(self) -> int:
        return self.total_bytes - self._paid

    def advance(self, budget_bytes) -> Tuple[int, List[int]]:
        """Move up to ``budget_bytes`` of the fetch over the link.
        Returns (bytes actually used, []) — the empty list keeps the
        ``PlanDrain.advance`` shape (no layers flip residency here)."""
        if self.done:
            return 0, []
        used = min(budget_bytes, self.remaining_bytes)
        used = int(used) if math.isfinite(used) else self.remaining_bytes
        self._paid += used
        return used, []
