"""Analytic per-iteration performance model (Vidur-style).

Used by (a) the Remapping Controller for its T_c / T_T feasibility inputs
(paper §5.3 profiles these offline) and (b) the event-driven simulator for
iteration timing.

``shards=1`` (the default) is the paper's single-accelerator multi-tenant
setup and is bit-identical to the historical model. ``shards=N`` models ONE
representative device of an N-way model-parallel shard set (SPMD): param /
KV / remap-unit bytes divide by the effective degree lowered through
``distributed/sharding.SERVING_RULES``, a collective term derived from
``distributed/analytic_cost`` rides the ICI fabric, and — crucially for the
remap math — ``t_transfer_unit`` becomes the *per-shard slice* over that
shard's own host link, so the β-slot prefetch schedule runs against
per-shard host bandwidth.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.expert_remap import step_fetch_plan
from repro_torch.core.layer_selection import RemapPlan
from repro_torch.core.transfer_pipeline import StepTiming, simulate_decode_step
from repro_torch.distributed.analytic_cost import decode_collective_bytes
from repro_torch.distributed.sharding import serving_shard_degrees
from repro_torch.models.lm import block_pattern
from repro_torch.serving.hw import HardwareSpec


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """KV-cache bytes appended per generated token (all layers)."""
    per_attn = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * dtype_bytes
    n_attn = sum(1 for k in cfg.layer_kinds() if k.startswith("attn"))
    if cfg.is_encoder_decoder:
        n_attn = cfg.num_layers  # decoder self-attention
    return per_attn * n_attn


def const_state_bytes(cfg: ModelConfig, dtype_bytes: int = 4) -> int:
    """O(1) per-sequence recurrent state (mamba / mLSTM)."""
    total = 0
    for kind in cfg.layer_kinds():
        if kind.startswith("ssm"):
            if cfg.ssm and cfg.ssm.kind == "mamba":
                d_in = cfg.ssm.expand * cfg.d_model
                total += (d_in // 64) * cfg.ssm.d_state * 64 * dtype_bytes
                total += (cfg.ssm.d_conv - 1) * d_in * 2
            else:
                hd = cfg.resolved_head_dim
                total += cfg.num_heads * hd * (hd + 1) * dtype_bytes
    return total


@dataclasses.dataclass
class PerfModel:
    cfg: ModelConfig
    hw: HardwareSpec
    dtype_bytes: int = 2
    shards: int = 1            # model-parallel degree; models ONE shard

    def __post_init__(self):
        self._t_compute_cache: Optional[float] = None
        self._const_state_bytes = const_state_bytes(self.cfg)
        self._n_attn = sum(1 for k in self.cfg.layer_kinds()
                           if k.startswith("attn"))
        self.pattern, self.repeats = block_pattern(self.cfg)
        self.param_bytes = self.cfg.param_count() * self.dtype_bytes
        self.active_param_bytes = self.cfg.active_param_count() * self.dtype_bytes
        self.total_param_bytes = self.param_bytes
        self.shard_kv_token_bytes = kv_bytes_per_token(self.cfg,
                                                       self.dtype_bytes)
        self.degrees = None
        if self.shards > 1:
            self.degrees = serving_shard_degrees(self.cfg, self.shards)
            self.param_bytes //= self.shards
            self.active_param_bytes //= self.shards
            self.shard_kv_token_bytes //= self.degrees.kv_heads
            # collective wire bytes scale linearly with tokens; the count
            # (latency floor) does not — precompute both at one token
            wire1, n_coll = decode_collective_bytes(
                self.cfg, 1, self.shards, self.dtype_bytes)
            self._coll_wire_per_token = wire1
            self._coll_count = n_coll

    # ------------------------------------------------------------ collectives
    def collective_time(self, tokens: int) -> float:
        """Per-forward-pass TP collective time on the ICI fabric for this
        shard (ring all-reduces + MoE all-to-alls + logits all-gather, cf.
        ``analytic_cost.decode_collective_bytes``). Zero at ``shards=1``."""
        if self.shards <= 1 or tokens <= 0:
            return 0.0
        return (self._coll_wire_per_token * tokens / self.hw.ici_bw
                + self._coll_count * self.hw.ici_latency_s)

    # ------------------------------------------------------------ remap unit
    @property
    def unit_bytes(self) -> int:
        """Bytes per remappable unit (one pattern repeat); the *per-shard
        slice* of the repeat when the tenant spans a shard set."""
        v = self.cfg.vocab_size * self.cfg.d_model * self.dtype_bytes
        per_set = max((self.total_param_bytes - 2 * v) // self.repeats, 1)
        if self.shards == 1:
            return per_set
        return max(per_set // self.shards, 1)

    @property
    def t_transfer_unit(self) -> float:
        """Host->HBM time for one remap unit (unidirectional)."""
        return self.unit_bytes / self.hw.host_link_bw

    @property
    def t_compute_layer_decode(self) -> float:
        """Per-unit decode compute time at batch=1 (conservative T_c).
        A pure function of the immutable model/hardware pair, cached: the
        mirage control loop reads it for every tenant on every iteration."""
        if self._t_compute_cache is None:
            self._t_compute_cache = self.decode_step_time(1, 512) \
                / self.repeats
        return self._t_compute_cache

    # ------------------------------------------------------------- decode/TBT
    def _decode_scalar(self, batch: int, avg_ctx: float,
                       resident_fraction: float = 1.0,
                       streamed_bytes: int = 0) -> float:
        """Scalar bandwidth-bound model: every resident parameter byte is
        read once; KV cache bytes grow with batch*ctx; compute term uses
        2*active_params*batch FLOPs; streamed bytes ride the host link
        concurrently — max(compute, hbm, host-stream)."""
        flops = 2.0 * (self.active_param_bytes / self.dtype_bytes) * batch
        t_compute = flops / (self.hw.flops_bf16 * self.hw.mfu_ceiling)
        kv = (self.shard_kv_token_bytes * avg_ctx
              + self._const_state_bytes) * batch
        hbm = self.param_bytes * resident_fraction + kv
        t_hbm = hbm / self.hw.hbm_bw
        t_stream = streamed_bytes / self.hw.host_link_bw
        t = max(t_compute, t_hbm, t_stream)
        if self.shards > 1:
            t += self.collective_time(batch)
        return t

    def pipeline_inputs(self, batch: int, avg_ctx: float,
                        plan: RemapPlan) -> tuple:
        """(t_layer_compute, t_layer_fetch) for the shared event pipeline
        — THE one derivation both runtimes feed it: per-layer compute
        budget is the bandwidth-bound scalar time / n (HBM term folded
        in, resident fraction from the plan's α), per-layer fetch is the
        remap unit's host-link time."""
        n = max(plan.n, 1)
        rf = 1.0 - plan.alpha / n
        return (self._decode_scalar(batch, avg_ctx, rf, 0) / n,
                self.t_transfer_unit)

    def decode_step_timing(self, batch: int, avg_ctx: float, plan: RemapPlan,
                           *, cold: bool = False) -> StepTiming:
        """One decode iteration under ``plan``, resolved by the shared
        event pipeline (``core/transfer_pipeline``). ``cold=True`` models
        the first step after a plan switch (no prefetch from a previous
        iteration)."""
        t_c, t_f = self.pipeline_inputs(batch, avg_ctx, plan)
        return simulate_decode_step(plan, t_c, t_f, cold=cold)

    def decode_step_time(self, batch: int, avg_ctx: float,
                         resident_fraction: float = 1.0,
                         streamed_bytes: int = 0,
                         plan: Optional[RemapPlan] = None) -> float:
        """One decode iteration for ``batch`` sequences.

        With a ``plan`` carrying cycling layers, the event-based pipeline
        model resolves the iteration (bubbles only when a fetch misses its
        layer slot). The scalar path serves the non-remapped fast case —
        and the m=0 pipeline reduces to it exactly (asserted here,
        property-tested in tests/test_transfer_pipeline.py).
        """
        if plan is not None and plan.m:
            return self.decode_step_timing(batch, avg_ctx, plan).total
        t = self._decode_scalar(batch, avg_ctx, resident_fraction,
                                streamed_bytes)
        if plan is not None:
            timing = self.decode_step_timing(batch, avg_ctx, plan)
            assert math.isclose(timing.total, self._decode_scalar(
                batch, avg_ctx, 1.0, 0), rel_tol=1e-9)
        return t

    def next_token_time(self, batch: int, avg_ctx: float) -> float:
        """Predicted time to the next emitted token for the running batch —
        the earliest-deadline-first signal the SLO scheduler's slack
        computation consumes (``serving/slo.tenant_slack``)."""
        return self.decode_step_time(batch, avg_ctx)

    # ------------------------------------------------------------ prefill/TTFT
    def prefill_time(self, prompt_tokens: int, batch: int = 1,
                     resident_fraction: float = 1.0,
                     streamed_bytes: int = 0) -> float:
        """Prefill is compute-bound with a quadratic attention term. A
        remapped model reads only its *resident* parameters from HBM and
        streams the cycling layers over the host link, exactly like
        decode — a full-``param_bytes`` HBM charge regardless of α would
        overbill the very model whose layers were donated."""
        flops = 2.0 * (self.active_param_bytes / self.dtype_bytes) \
            * prompt_tokens * batch
        # quadratic attention term (head-sharded across the set)
        n_attn = self._n_attn
        attn = (2.0 * n_attn * prompt_tokens ** 2 * self.cfg.num_heads
                * self.cfg.resolved_head_dim * 2 * batch)
        if self.shards > 1:
            attn /= self.degrees.heads
        flops += attn
        t_compute = flops / (self.hw.flops_bf16 * self.hw.mfu_ceiling)
        t_hbm = self.param_bytes * resident_fraction / self.hw.hbm_bw
        t_stream = streamed_bytes / self.hw.host_link_bw
        t = max(t_compute, t_hbm, t_stream)
        if self.shards > 1:
            t += self.collective_time(prompt_tokens * batch)
        return t

    def prefix_transfer_costs(self, span_tokens: int, prompt_tokens: int,
                              kv_token_bytes: Optional[int] = None
                              ) -> Tuple[int, float, float]:
        """SwiftCache-style transfer-vs-recompute costs for reusing a
        ``span_tokens`` cached prefix of a ``prompt_tokens`` prompt held
        on another replica. Returns ``(bytes, t_fetch_s, t_recompute_s)``;
        fetch wins when ``t_fetch < t_recompute``.

        ``t_fetch`` is the span's KV crossing the host link. The recompute
        side is ``prefill_time`` of the matched span measured *marginally*
        — ``prefill_time(prompt) - prefill_time(suffix)`` — because the
        unmatched suffix must prefill either way: the suffix prefill
        already pays the full resident-parameter HBM read, so billing the
        span a second whole-model pass would make fetch win unconditionally
        on every ``hw.HOST_LINKS`` class. Marginally, short spans on short
        prompts cost ~nothing to recompute (the prefill is HBM-bound and
        the floor is paid anyway) while long spans cost the full quadratic
        attention + FLOP term — which is where the per-link crossover
        lives."""
        span = max(min(int(span_tokens), int(prompt_tokens) - 1), 0)
        kb = int(kv_token_bytes) if kv_token_bytes else \
            max(self.shard_kv_token_bytes, 1)
        nbytes = span * kb
        t_fetch = nbytes / self.hw.host_link_bw
        suffix = max(prompt_tokens - span, 1)
        t_rec = max(self.prefill_time(prompt_tokens)
                    - self.prefill_time(suffix), 0.0)
        return nbytes, t_fetch, t_rec

    # --------------------------------------------------- expert granularity
    @property
    def expert_bytes(self) -> int:
        """Bytes of one expert's FFN weights — the expert remap unit."""
        return self.cfg.expert_bytes(self.dtype_bytes)

    @property
    def t_transfer_expert(self) -> float:
        """Host->HBM time for one expert (the expert-granular T_T)."""
        return self.expert_bytes / self.hw.host_link_bw

    def expert_decode_timing(self, batch: int, avg_ctx: float, *,
                             n_moe_layers: int, top_k: int, cold_counts,
                             resident_fraction: float = 1.0,
                             beta: int = 2, cold: bool = False) -> StepTiming:
        """One decode iteration under expert-granular remapping, resolved
        by the shared event pipeline over the routed-slot circle
        (``n_moe_layers * top_k`` slots). ``cold_counts[l]`` is the number
        of distinct remapped experts the batch routes to in MoE layer
        ``l`` this step; each crosses the host link once, double-buffered
        through ``beta`` slots. The per-slot compute budget is the
        bandwidth-bound scalar time spread over the routed slots — the
        expert analog of ``pipeline_inputs``, and the same derivation
        ``TransferEngine.note_moe_decode_step`` charges, so engine and
        simulator agree on bubbles by construction."""
        plan = step_fetch_plan(n_moe_layers, top_k, cold_counts, beta=beta)
        t_slot = self._decode_scalar(batch, avg_ctx, resident_fraction, 0) \
            / max(plan.n, 1)
        return simulate_decode_step(plan, t_slot, self.t_transfer_expert,
                                    cold=cold)

    # -------------------------------------------------------------- cold start
    def reload_time(self, alpha_units: int,
                    unit_bytes: Optional[int] = None) -> float:
        ub = self.unit_bytes if unit_bytes is None else unit_bytes
        return alpha_units * ub / self.hw.host_link_bw

    def swap_step_time(self, swapped_bytes: int) -> float:
        """Pie-style KV swap traffic for one iteration: bidirectional
        transfers at degraded effective bandwidth (paper §3.2)."""
        return 2.0 * swapped_bytes / self.hw.host_link_bw_bidir
