"""Async Transfer Engine (paper §4.1/§6) — PyTorch/CUDA realization.

Two cooperating mechanisms, as in ``repro.core.transfer_engine``:

1. **In-step streaming of cycling layers.** A model's stacked layer
   parameters are split into a *resident* stack (device memory) and a
   *cycle* stack. On CUDA the cycle stack lives in pinned host memory and
   holds only the cycle layers. The decode step's layer loop fetches each
   repeat through ``make_fetch``: a resident layer is a view into the
   device stack; a cycling layer is copied host->device into one of β
   device slot buffers on a dedicated copy stream, up to β layers ahead,
   and the layer's compute waits on a CUDA event recorded after its copy.
   A slot is refilled only after the compute that read it was enqueued
   (the copy stream waits on an event of the compute stream). This is the
   per-layer prefetch pipeline that XLA's latency-hiding scheduler builds
   on the TPU, written out by hand. On the CPU the fetch is an index.

2. **Host-side tier switching**: increasing α drops device layers (the
   full stack is kept, as the host copy is in vLLM) and donates their bytes
   to the KV allocator; Dynamic Reversion restores them over the host link.
   ``TransferEngine`` does this bookkeeping and accounts every byte moved;
   tier switches drain asynchronously through ``submit_plan``/``advance``
   exactly as in the JAX package (that part is a copy).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.expert_remap import (
    EXPERT_PARAM_KEYS, ExpertPlan, identity_expert_plan, residency_states,
    step_fetch_plan, unit_expert,
)
from repro_torch.core.layer_selection import RemapPlan, make_plan
from repro_torch.core.transfer_pipeline import (
    PlanDrain, StepTiming, identity_plan, simulate_decode_step,
)
from repro_torch.models.common import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# stacked-tree split / merge / fetch
# ---------------------------------------------------------------------------

def _take(a: torch.Tensor, sel: np.ndarray) -> torch.Tensor:
    """a[sel] along the stack axis; a view when sel is one contiguous run."""
    if len(sel) == 0:
        return a[:0]
    lo = int(sel[0])
    if np.array_equal(sel, np.arange(lo, lo + len(sel))):
        return a[lo:lo + len(sel)]
    return a.index_select(0, torch.as_tensor(sel, device=a.device))


def _pinned(a: torch.Tensor) -> torch.Tensor:
    out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    out.copy_(a)
    return out


def split_blocks(blocks, plan: RemapPlan, pin_cycle: bool = False):
    """Split stacked layer params (leaves [R, ...]) into resident/cycle
    stacks per ``plan``. Returns (resident, cycle, index_maps). With
    ``pin_cycle`` the cycle stack is copied to pinned host memory."""
    res = np.array(plan.resident_layers, np.int32)
    cyc = np.array(plan.cycle_layers, np.int32)
    r_total = plan.n
    is_resident = np.zeros(r_total, bool)
    is_resident[res] = True
    # position of repeat r inside its stack
    idx_in_stack = np.zeros(r_total, np.int32)
    idx_in_stack[res] = np.arange(len(res))
    idx_in_stack[cyc] = np.arange(len(cyc))
    resident = tree_map(lambda a: _take(a, res), blocks)
    cycle = tree_map(lambda a: _take(a, cyc), blocks)
    if pin_cycle:
        cycle = tree_map(_pinned, cycle)
    maps = {"is_resident": is_resident, "idx_in_stack": idx_in_stack}
    return resident, cycle, maps


def merge_blocks(resident, cycle, plan: RemapPlan):
    """Inverse of split_blocks (used at reversion tier switches)."""
    def merge(a_res, a_cyc):
        out = torch.zeros((plan.n,) + tuple(a_res.shape[1:]),
                          dtype=a_res.dtype, device=a_res.device)
        if len(plan.resident_layers):
            out[list(plan.resident_layers)] = a_res
        if len(plan.cycle_layers):
            out[list(plan.cycle_layers)] = a_cyc.to(a_res.device)
        return out
    return tree_map(merge, resident, cycle)


class StreamingFetch:
    """``fetch(r)`` for one decode step whose cycle stack is in pinned host
    memory: cycle layers stream into ``slots`` device buffers on a copy
    stream, up to ``slots`` layers ahead of the compute. Call it for
    r = 0, 1, ..., R-1 in order, at the start of each layer's compute."""

    def __init__(self, resident, cycle, maps, slots: int):
        self.resident, self.cycle = resident, cycle
        self.is_resident = maps["is_resident"]
        self.idx = maps["idx_in_stack"]
        self.device = tree_leaves(resident)[0].device
        self.order = [r for r in range(len(self.is_resident))
                      if not self.is_resident[r]]
        self.slots = max(1, min(slots, len(self.order)))
        self.buffers = [
            tree_map(lambda a: torch.empty(a.shape[1:], dtype=a.dtype,
                                           device=self.device), cycle)
            for _ in range(self.slots)]
        self.layer_bytes = sum(a[0].numel() * a.element_size()
                               for a in tree_leaves(cycle))
        self.stream = torch.cuda.Stream(self.device)
        self.reset()

    def reset(self) -> None:
        """Start a new step's walk over the repeats (the stream and the
        slot buffers stay: a captured decode step reuses them)."""
        self.ready: Dict[int, Tuple[torch.cuda.Event, Any]] = {}
        self.issued = 0
        self.h2d_bytes = 0

    def _issue(self, r: int) -> None:
        """Start every copy whose slot's previous layer (order[k - slots])
        has had its compute enqueued, i.e. lies below r."""
        compute = torch.cuda.current_stream(self.device)
        freed = None
        while self.issued < len(self.order) and (
                self.issued < self.slots
                or self.order[self.issued - self.slots] < r):
            k = self.issued
            if freed is None:
                freed = torch.cuda.Event()
                freed.record(compute)
            buf = self.buffers[k % self.slots]
            i = int(self.idx[self.order[k]])
            self.stream.wait_event(freed)
            with torch.cuda.stream(self.stream):
                tree_map(lambda dst, src: dst.copy_(src[i], non_blocking=True),
                         buf, self.cycle)
                done = torch.cuda.Event()
                done.record(self.stream)
            self.ready[self.order[k]] = (done, buf)
            self.h2d_bytes += self.layer_bytes
            self.issued += 1

    def __call__(self, r: int):
        self._issue(r)
        if self.is_resident[r]:
            i = int(self.idx[r])
            return tree_map(lambda a: a[i], self.resident)
        done, buf = self.ready.pop(r)
        torch.cuda.current_stream(self.device).wait_event(done)
        return buf


def make_fetch(resident, cycle, maps: Dict[str, np.ndarray],
               slots: int = 2) -> Callable[[int], Any]:
    """Build the per-repeat parameter fetch for ``LM.decode_step_paged``.

    A cycle stack in host memory beside a resident stack on a CUDA device
    streams (``StreamingFetch``, ``slots`` = β device buffers). Otherwise
    both stacks share a device and the fetch is an index, as in the JAX
    reference's CPU path."""
    res_leaf, cyc_leaf = tree_leaves(resident)[0], tree_leaves(cycle)[0]
    if res_leaf.is_cuda and cyc_leaf.device.type == "cpu" \
            and cyc_leaf.shape[0] > 0:
        return StreamingFetch(resident, cycle, maps, slots)
    is_resident = maps["is_resident"]
    idx = maps["idx_in_stack"]

    def fetch(r):
        stack = resident if is_resident[r] else cycle
        i = int(idx[r])
        return tree_map(lambda a: a[i], stack)

    return fetch


def tier_plan(repeats: int, tier: float) -> RemapPlan:
    """The plan of a MIRAGE remap tier over ``repeats`` repeats, as the
    reference's dry run makes it: alpha = max(round(tier * repeats), 1)
    repeats donated, planned with t_c = 1, t_t = 1e-9 and double
    buffering (so m = alpha + beta layers cycle)."""
    alpha = max(int(round(tier * repeats)), 1)
    return make_plan(repeats, alpha, t_c=1.0, t_t=1e-9, double_buffer=True)


def tier_split(blocks, tier: float):
    """A remap tier on stacked blocks (this rank's, under a mesh): (plan,
    resident, cycle, maps), the cycle stack in pinned host memory where
    the blocks lie on a CUDA device (``split_blocks``). A decode step
    streams it through ``make_fetch(resident, cycle, maps,
    slots=plan.beta)``, made anew each step."""
    plan = tier_plan(_repeats(blocks), tier)
    resident, cycle, maps = split_blocks(
        blocks, plan, pin_cycle=tree_leaves(blocks)[0].is_cuda)
    return plan, resident, cycle, maps


def cross_kv_to_host(cross):
    """Enc-dec's cross K/V (stacked [R, ...], immutable after prefill)
    remapped like parameters: (the stack in pinned host memory where it
    lies on a CUDA device, else a copy, ``cross_transform``): the hook
    ``EncDec.decode_step`` applies to each repeat's slice, which copies
    the slice to the stack's device (on the current stream)."""
    dev = tree_leaves(cross)[0].device
    host = tree_map(_pinned if dev.type == "cuda" else torch.clone, cross)

    def cross_transform(sl):
        return tree_map(lambda a: a.to(dev, non_blocking=True), sl)
    return host, cross_transform


# ---------------------------------------------------------------------------
# host-side engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransferStats:
    remap_drops_bytes: int = 0          # device bytes donated to KV
    revert_bytes: int = 0               # donation-level restore debt (Δα)
    stream_bytes: int = 0               # per-token cycling transfers
    tier_switches: int = 0
    drain_bytes: int = 0                # host->device bytes moved by advance()
    bubble_time_s: float = 0.0          # modeled pipeline stall (event model)
    decode_time_s: float = 0.0          # modeled decode time incl. stalls


class TransferEngine:
    """Owns per-model (resident, cycle) stacks + the full host copy.

    ``plans[name]`` is always the plan the *split reflects right now* —
    the interim plan while a submitted tier switch drains, the target once
    ``advance`` has paid for every cycle->resident load.
    """

    def __init__(self):
        self.host_copy: Dict[str, Any] = {}        # full stacked blocks
        self.split: Dict[str, Tuple[Any, Any, Dict[str, np.ndarray]]] = {}
        self.plans: Dict[str, RemapPlan] = {}
        self.layer_bytes: Dict[str, int] = {}
        self.pending: Dict[str, PlanDrain] = {}
        self.stats = TransferStats()
        self._target_alpha: Dict[str, int] = {}
        self._cold: Dict[str, bool] = {}   # plan switched since last decode
        # expert-granular state (MoE tenants; unit = one expert's weights)
        self.expert_host: Dict[str, Any] = {}
        self.expert_unit_bytes: Dict[str, int] = {}
        self.expert_dims: Dict[str, Tuple[int, int]] = {}
        self.expert_plans: Dict[str, ExpertPlan] = {}
        self.expert_pending: Dict[str, PlanDrain] = {}
        self._expert_flat: Dict[str, RemapPlan] = {}
        self._expert_cold: Dict[str, bool] = {}
        # host->device bytes the streaming fetch really copied (CUDA only;
        # stream_bytes above is the plan's nominal per-token traffic)
        self.host_fetch_bytes = 0

    def register(self, name: str, blocks, layer_bytes: int) -> None:
        self.host_copy[name] = blocks
        self.layer_bytes[name] = layer_bytes
        self._target_alpha[name] = 0
        self._install(name, identity_plan(_repeats(blocks)))

    def _install(self, name: str, plan: RemapPlan) -> None:
        """Tier switch: re-split the stack. On CUDA the cycle stack goes to
        pinned host memory (only the cycle layers) and the resident stack
        stays on the device."""
        self.plans[name] = plan
        blocks = self.host_copy[name]
        self.split[name] = split_blocks(
            blocks, plan, pin_cycle=tree_leaves(blocks)[0].is_cuda)
        self._cold[name] = True

    def submit_plan(self, name: str, plan: RemapPlan) -> None:
        """Begin an async tier switch. Drops (resident->cycle) happen now;
        loads (cycle->resident) queue behind ``advance``. Re-submitting
        mid-drain transitions from the current interim plan (in-flight
        drain progress is discarded — the superseded loads are re-queued
        if the new target still wants them resident)."""
        cur = self.pending[name].current_plan if name in self.pending \
            else self.plans[name]
        lb = self.layer_bytes[name]
        old_alpha = self._target_alpha[name]
        if plan.alpha > old_alpha:
            self.stats.remap_drops_bytes += (plan.alpha - old_alpha) * lb
        elif plan.alpha < old_alpha:
            self.stats.revert_bytes += (old_alpha - plan.alpha) * lb
        self._target_alpha[name] = plan.alpha
        self.stats.tier_switches += 1
        drain = PlanDrain(cur, plan, lb)
        if drain.done:
            self.pending.pop(name, None)
        else:
            self.pending[name] = drain
        # a reversion's interim IS the current plan — skip the no-op
        # re-split (and the cold-start restart) in that case
        if drain.current_plan != self.plans[name]:
            self._install(name, drain.current_plan)

    def advance(self, name: str, budget_bytes) -> int:
        """Drain up to ``budget_bytes`` of the pending tier switch over the
        host link. The split stays at the interim plan until the LAST
        layer is paid for, then hops to the target in one re-split —
        paid-but-uninstalled layers keep streaming from host (correct,
        conservatively timed) instead of forcing a full re-split and a
        fresh jit executable per layer. Returns the bytes consumed."""
        drain = self.pending.get(name)
        if drain is None:
            return 0
        used, _completed = drain.advance(budget_bytes)
        self.stats.drain_bytes += used
        if drain.done:
            del self.pending[name]
            self._install(name, drain.target)
        return used

    def pending_bytes(self, name: str) -> int:
        """Host->device bytes still owed by an in-flight tier switch."""
        drain = self.pending.get(name)
        return drain.remaining_bytes if drain is not None else 0

    def apply_plan(self, name: str, plan: RemapPlan) -> None:
        """Synchronous tier switch: submit + drain the whole transition."""
        self.submit_plan(name, plan)
        self.advance(name, float("inf"))

    def fetch_for(self, name: str):
        resident, cycle, maps = self.split[name]
        return make_fetch(resident, cycle, maps,
                          slots=max(self.plans[name].beta, 1))

    def note_decode_step(self, name: str, t_compute_layer: float = None,
                         t_fetch_layer: float = None) -> Optional[StepTiming]:
        """Account the per-token streaming traffic of the active plan.
        With per-layer compute/fetch times, additionally resolve the step
        through the shared event pipeline and accumulate the modeled
        bubble — the same accounting the simulator charges, so both
        runtimes agree on bubbles for the same plan."""
        plan = self.plans[name]
        self.stats.stream_bytes += plan.m * self.layer_bytes[name]
        if t_compute_layer is None or t_fetch_layer is None or not plan.m:
            return None
        timing = simulate_decode_step(
            plan, t_compute_layer, t_fetch_layer,
            cold=self._cold.pop(name, False))
        self.stats.bubble_time_s += timing.bubble_time
        self.stats.decode_time_s += timing.total
        return timing

    def params_with_blocks(self, params, name: str):
        """Return params with blocks rebuilt dense (for non-remapped paths)."""
        return dict(params, blocks=self.host_copy[name])

    # ------------------------------------------------------------------
    # expert-granular remapping (MoE tenants)
    # ------------------------------------------------------------------
    # The same PlanDrain state machine and byte counters, at the unit
    # ``unit = moe_layer * num_experts + expert`` (one expert's 3*d*d_expert
    # SwiGLU weights). Residency plans have m == alpha (a donated expert
    # only streams on the steps it is routed to); the β double-buffered
    # slots enter per decode step via ``step_fetch_plan``.

    def register_experts(self, name: str, moe_blocks, expert_bytes: int,
                         num_moe_layers: int, num_experts: int) -> None:
        """Register a model's expert-stacked MoE params: tree whose
        EXPERT_PARAM_KEYS leaves have shape [num_moe_layers, num_experts,
        ...] (the ``p["ffn"]`` sub-tree of the stacked blocks)."""
        self.expert_host[name] = moe_blocks
        self.expert_unit_bytes[name] = int(expert_bytes)
        self.expert_dims[name] = (num_moe_layers, num_experts)
        plan = identity_expert_plan(num_moe_layers, num_experts)
        self.expert_plans[name] = plan
        self._expert_flat[name] = plan.to_remap_plan()
        self._expert_cold[name] = True

    def submit_expert_plan(self, name: str, plan: ExpertPlan) -> None:
        """Begin an async expert-residency switch. Donations (resident ->
        remapped) are free drops; restores queue behind
        ``advance_experts``. Re-submitting mid-drain retargets from the
        interim plan, exactly like ``submit_plan``."""
        L, E = self.expert_dims[name]
        if (plan.num_moe_layers, plan.num_experts) != (L, E):
            raise ValueError("plan shape mismatch")
        flat = plan.to_remap_plan()
        cur = self.expert_pending[name].current_plan \
            if name in self.expert_pending else self._expert_flat[name]
        eb = self.expert_unit_bytes[name]
        old_alpha = cur.alpha if name not in self.expert_pending \
            else self.expert_pending[name].target.alpha
        if flat.alpha > old_alpha:
            self.stats.remap_drops_bytes += (flat.alpha - old_alpha) * eb
        elif flat.alpha < old_alpha:
            self.stats.revert_bytes += (old_alpha - flat.alpha) * eb
        self.stats.tier_switches += 1
        drain = PlanDrain(cur, flat, eb)
        if drain.done:
            self.expert_pending.pop(name, None)
        else:
            self.expert_pending[name] = drain
        if drain.current_plan != self._expert_flat[name]:
            self._expert_flat[name] = drain.current_plan
            self._expert_cold[name] = True
        self.expert_plans[name] = plan

    def advance_experts(self, name: str, budget_bytes) -> int:
        """Drain up to ``budget_bytes`` of the pending expert restores."""
        drain = self.expert_pending.get(name)
        if drain is None:
            return 0
        used, _ = drain.advance(budget_bytes)
        self.stats.drain_bytes += used
        if drain.done:
            del self.expert_pending[name]
            self._expert_flat[name] = drain.target
            self._expert_cold[name] = True
        return used

    def expert_residency(self, name: str) -> Dict[str, set]:
        """Partition of flattened expert units into exactly one of
        {resident, remapped, in_flight} under the live interim plan."""
        states = residency_states(self._expert_flat[name],
                                  self.expert_pending.get(name))
        out = {"resident": set(), "remapped": set(), "in_flight": set()}
        for u, s in states.items():
            out[s].add(u)
        return out

    def expert_params_for(self, name: str, absent: str = "host"):
        """Effective MoE params under the live residency. ``absent='host'``
        returns values identical to the dense tree (cold experts stream
        from the host copy — production semantics, bit-exact).
        ``absent='zero'`` zeroes every non-resident expert instead: any
        routed-to cold expert then perturbs the output, so bit-identity
        against the dense run *proves* no routed expert was victimized."""
        tree = self.expert_host[name]
        if absent == "host":
            return tree
        L, E = self.expert_dims[name]
        flat = self._expert_flat[name]
        cold = [unit_expert(u, E) for u in flat.cycle_layers]

        def zero(a):
            out = np.array(a)
            for l, e in cold:
                out[l, e] = 0
            return out

        def walk(t):
            if isinstance(t, dict):
                return {k: (zero(v) if k in EXPERT_PARAM_KEYS else walk(v))
                        for k, v in t.items()}
            if isinstance(t, (tuple, list)):
                out = [walk(v) for v in t]
                return tuple(out) if isinstance(t, tuple) else out
            return t
        return walk(tree)

    def note_moe_decode_step(self, name: str, t_compute_slot: float,
                             t_fetch_expert: float, cold_counts,
                             top_k: int, beta: int = 2) -> StepTiming:
        """Account one decode step's cold-expert fetches: build the routed
        -slot fetch schedule and resolve it through the shared event
        pipeline — the same model ``PerfModel.expert_decode_timing``
        charges, so engine and simulator agree by construction."""
        L, _E = self.expert_dims[name]
        plan = step_fetch_plan(L, top_k, cold_counts, beta=beta)
        self.stats.stream_bytes += plan.m * self.expert_unit_bytes[name]
        timing = simulate_decode_step(
            plan, t_compute_slot, t_fetch_expert,
            cold=self._expert_cold.pop(name, False))
        self.stats.bubble_time_s += timing.bubble_time
        self.stats.decode_time_s += timing.total
        return timing


def _repeats(blocks) -> int:
    return tree_leaves(blocks)[0].shape[0]
