"""Layer selection (paper §5.4): uniform-interval placement on the circular
layer execution order, plus the α+β buffering feasibility conditions.

Definitions (paper notation):
  n      total layers
  α      layers whose parameter memory is donated to KV cache
  m      layers transferred per token generation; m = α + β, β ∈ {1, 2}
  T_c    per-layer compute time, T_T per-layer transfer time

Feasibility:
  β=1 (single shared slot):   T_T · (α + 1) ≤ T_c · (n − α − 1)     (eq. 4)
  β=2 (double buffering):     T_T · (α + 2) ≤ T_c · n               (eq. 5)

Optimality (paper theorem): the m transferred layers must be evenly spaced
on the circle — equal spacing maximizes the minimum circular gap, which is
the per-transfer compute budget. ``min_circular_gap`` lets tests verify this
property against brute force.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple


def uniform_interval_layers(n: int, m: int, offset: int = 0) -> List[int]:
    """m evenly-spaced layer indices on a circle of n (paper's strategy)."""
    if m <= 0:
        return []
    if m > n:
        raise ValueError(f"cannot select {m} of {n} layers")
    sel = sorted({(offset + (i * n) // m) % n for i in range(m)})
    # floor spacing guarantees distinctness because m <= n
    assert len(sel) == m
    return sel


def min_circular_gap(selection: Sequence[int], n: int) -> int:
    """Minimum circular distance between consecutive selected layers."""
    if len(selection) <= 1:
        return n
    s = sorted(selection)
    gaps = [s[i + 1] - s[i] for i in range(len(s) - 1)]
    gaps.append(n - s[-1] + s[0])
    return min(gaps)


def beta1_feasible(n: int, alpha: int, t_c: float, t_t: float) -> bool:
    return t_t * (alpha + 1) <= t_c * (n - alpha - 1)


def beta2_feasible(n: int, alpha: int, t_c: float, t_t: float) -> bool:
    return t_t * (alpha + 2) <= t_c * n


def choose_m(n: int, alpha: int, t_c: float, t_t: float,
             double_buffer: bool = True, mode: str = "dynamic") -> int:
    """Buffering schemes of paper §7.5:
      (A) mode="single"  — always m = α+1 (eq. 4)
      (B) mode="double"  — always m = α+2 (eq. 5)
      (C) mode="dynamic" — α+1 while eq. 4 holds, else α+2 (the default)

    Returns 0 when the chosen scheme cannot hide the transfers (remapping
    this α would stall the pipeline — the controller must cap α).
    """
    if alpha <= 0:
        return 0
    if not double_buffer:
        mode = "single"
    if mode == "single":
        return alpha + 1 if beta1_feasible(n, alpha, t_c, t_t) else 0
    if mode == "double":
        return alpha + 2 if beta2_feasible(n, alpha, t_c, t_t) else 0
    if beta1_feasible(n, alpha, t_c, t_t):
        return alpha + 1
    if beta2_feasible(n, alpha, t_c, t_t):
        return alpha + 2
    return 0


def max_alpha(n: int, t_c: float, t_t: float, double_buffer: bool = True,
              mode: str = "dynamic") -> int:
    """Largest α whose transfers still hide under compute."""
    best = 0
    for a in range(1, n):
        if choose_m(n, a, t_c, t_t, double_buffer, mode):
            best = a
        else:
            break
    return best


@dataclasses.dataclass(frozen=True)
class RemapPlan:
    """A concrete per-token transfer schedule for one model.

    ``cycle_layers`` — the m uniformly spaced layers cycling through the
    shared slots; ``slots`` — number of shared GPU-memory slots (β);
    ``resident_layers`` — layers that stay in device memory permanently.
    """
    n: int
    alpha: int
    m: int
    cycle_layers: Tuple[int, ...]
    resident_layers: Tuple[int, ...]

    @property
    def beta(self) -> int:
        return self.m - self.alpha

    def slot_of(self, layer: int) -> int:
        """Ring-buffer slot (0..beta-1) a cycling layer loads into."""
        return self.cycle_layers.index(layer) % self.beta

    def freed_layer_bytes(self, layer_bytes: int) -> int:
        return self.alpha * layer_bytes


def make_plan(n: int, alpha: int, t_c: float, t_t: float,
              double_buffer: bool = True, mode: str = "dynamic") -> RemapPlan:
    """Uniform-interval plan for remapping α of n layers (α=0 -> no-op)."""
    if alpha == 0:
        return RemapPlan(n, 0, 0, (), tuple(range(n)))
    m = choose_m(n, alpha, t_c, t_t, double_buffer, mode)
    if m == 0:
        raise ValueError(
            f"alpha={alpha} infeasible for n={n}, Tc={t_c}, Tt={t_t}")
    cyc = tuple(uniform_interval_layers(n, m))
    res = tuple(i for i in range(n) if i not in set(cyc))
    return RemapPlan(n, alpha, m, cyc, res)


def naive_contiguous_plan(n: int, alpha: int) -> Tuple[int, ...]:
    """Strawman the paper argues against (contiguous selection): used by the
    layer-selection benchmark to show the throughput gap."""
    return tuple(range(alpha + 1))
