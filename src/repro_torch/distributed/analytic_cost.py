"""Closed-form FLOPs/bytes model per (arch x shape x step-kind).

PRIMARY source for the roofline compute/memory terms. XLA's
``cost_analysis()`` counts each ``while``(scan) body once (verified in
EXPERIMENTS.md §Dry-run), so for scan-over-layers models it underestimates
by ~the layer count; this model is exact for the einsums we emit —
*implementation-faithful*, e.g. the chunked reference attention computes the
full S x S rectangle under the causal mask, and MoE capacity padding
inflates expert FLOPs by the capacity factor. MODEL_FLOPS = 6·N·D is
reported alongside as the "useful compute" yardstick.

All numbers are GLOBAL (whole step, all devices); divide by chip count for
per-device roofline terms.

The port's copy of ``repro.distributed.analytic_cost``: pure arithmetic
on the configs, equal to the original's to the last bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import block_pattern, layer_defs
from repro_torch.models.registry import WHISPER_DECODER_LEN

FLASH_CHUNK = 512          # must match attention_ops defaults
DECODE_CHUNK = 1024


def _model_flops(cfg: ModelConfig, batch: int, s_q: int, s_kv: int,
                 train: bool, decode_tokens: int = 0) -> float:
    """'Useful' FLOPs yardstick: 6·N·tokens (train) / 2·N·tokens (inference)
    with the per-token N being the *active, non-input-embedding* params.
    Enc-dec models process encoder and decoder tokens through different
    parameter subsets, so the yardstick splits by stack."""
    mult = 6.0 if train else 2.0
    n_active = cfg.active_param_count()
    # the input-embedding lookup performs no FLOPs; prefill additionally
    # computes logits only for the last position (not per token)
    embed = cfg.vocab_size * cfg.d_model
    n_active -= embed
    if not train and not decode_tokens:      # prefill
        n_active -= 0 if cfg.tie_embeddings else embed
    if not cfg.is_encoder_decoder:
        tokens = batch * (decode_tokens or s_q)
        return mult * n_active * tokens
    d = cfg.d_model
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    attn = d * (hq * hd) + 2 * d * (hkv * hd) + (hq * hd) * d
    ffn = 3 * d * cfg.d_ff
    enc_params = cfg.num_encoder_layers * (attn + ffn)
    dec_params = cfg.num_layers * (2 * attn + ffn) + cfg.vocab_size * d
    enc_tokens = 0 if decode_tokens else batch * s_kv
    dec_tokens = batch * (decode_tokens or s_q)
    return mult * (enc_params * enc_tokens + dec_params * dec_tokens)


@dataclasses.dataclass
class StepCost:
    flops: Dict[str, float]          # by component
    hbm_bytes: Dict[str, float]      # by component (per step, global)
    model_flops: float               # 6·N_active·tokens (train) / 2· (inference)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.hbm_bytes.values())

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / max(self.total_flops, 1.0)


def _attn_flops_full(cfg: ModelConfig, s_q: int, s_kv: int) -> float:
    """One layer, one sequence: scores + PV, full rectangle (impl-faithful;
    the Pallas kernel's causal block-skip would halve this on TPU)."""
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    if cfg.sliding_window:
        # kernel/ref skip blocks outside the window
        s_kv_eff = min(s_kv, cfg.sliding_window + FLASH_CHUNK)
    else:
        s_kv_eff = s_kv
    return 2.0 * 2.0 * s_q * s_kv_eff * hq * hd


def _ssd_flops(cfg: ModelConfig, t: int, mixer: str) -> float:
    """Chunked SSD / mLSTM per layer per sequence."""
    s = cfg.ssm
    chunk = s.chunk_size
    if mixer == "mamba":
        d_in = s.expand * cfg.d_model
        h = d_in // 64
        dk, dv = s.d_state, 64
        proj = 2.0 * t * cfg.d_model * (2 * d_in + 2 * dk + h) \
            + 2.0 * t * d_in * cfg.d_model
    else:  # mlstm
        h, dv = cfg.num_heads, cfg.resolved_head_dim
        dk = dv
        dv = dv + 1  # normalizer channel
        proj = 2.0 * t * cfg.d_model * (4 * h * cfg.resolved_head_dim) \
            + 2.0 * t * cfg.d_model * 2 * h
    intra = 2.0 * t * chunk * h * (dk + dv)          # scores + PV per chunk
    inter = 2.0 * t * h * dk * dv * 2                # state read + update
    return proj + intra + inter


def _slstm_flops(cfg: ModelConfig, t: int) -> float:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    return 2.0 * t * cfg.d_model * 4 * h * hd \
        + 2.0 * t * h * 4 * hd * hd + 2.0 * t * h * hd * cfg.d_model


def _moe_ffn_flops(cfg: ModelConfig, tokens: int, data_shards: int) -> Tuple[float, float]:
    m = cfg.moe
    if tokens * m.top_k <= 8 * m.num_experts:      # decode-adaptive grouping
        g = 1
    else:
        g = math.gcd(tokens, data_shards) or 1
    tg = tokens // g
    lam = tg * m.top_k / m.num_experts
    cap = min(tg, max(math.ceil(lam * m.capacity_factor),
                      math.ceil(lam + 3.0 * math.sqrt(max(lam, 1e-9))),
                      m.min_capacity))
    dispatched = g * m.num_experts * cap             # includes padding
    ffn = 6.0 * dispatched * cfg.d_model * m.d_expert
    router = 2.0 * tokens * cfg.d_model * m.num_experts
    return ffn, router


def _dense_ffn_flops(cfg: ModelConfig, tokens: int) -> float:
    return 6.0 * tokens * cfg.d_model * cfg.d_ff


def _attn_proj_flops(cfg: ModelConfig, tokens: int) -> float:
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return 2.0 * tokens * cfg.d_model * (2 * hq * hd + 2 * hkv * hd)


def forward_flops(cfg: ModelConfig, batch: int, s_q: int, s_kv: int,
                  data_shards: int, decode: bool = False) -> Dict[str, float]:
    tokens = batch * s_q
    out: Dict[str, float] = {k: 0.0 for k in
                             ("attn_proj", "attn_score", "ffn", "moe", "router",
                              "ssd", "slstm", "logits")}
    defs = layer_defs(cfg)
    for i, ld in enumerate(defs):
        if ld.mixer == "attn":
            out["attn_proj"] += _attn_proj_flops(cfg, tokens)
            out["attn_score"] += batch * _attn_flops_full(cfg, s_q, s_kv)
        elif ld.mixer == "mamba":
            out["ssd"] += batch * _ssd_flops(cfg, s_q, "mamba") if not decode \
                else batch * _ssd_flops(cfg, 1, "mamba")
        elif ld.mixer == "mlstm":
            out["ssd"] += batch * _ssd_flops(cfg, s_q, "mlstm") if not decode \
                else batch * _ssd_flops(cfg, 1, "mlstm")
        elif ld.mixer == "slstm":
            out["slstm"] += batch * _slstm_flops(cfg, s_q)
        if ld.ffn == "dense":
            out["ffn"] += _dense_ffn_flops(cfg, tokens)
        elif ld.ffn == "moe":
            f, r = _moe_ffn_flops(cfg, tokens, data_shards)
            out["moe"] += f
            out["router"] += r
    if cfg.is_encoder_decoder:
        # encoder layers over the source + decoder cross attention
        enc_tokens = batch * s_kv if not decode else 0
        for _ in range(cfg.num_encoder_layers):
            if enc_tokens:
                out["attn_proj"] += _attn_proj_flops(cfg, enc_tokens)
                out["attn_score"] += batch * _attn_flops_full(cfg, s_kv, s_kv)
                out["ffn"] += _dense_ffn_flops(cfg, enc_tokens)
        cross_kv = min(s_kv, cfg.max_source_len)
        for _ in range(cfg.num_layers):
            out["attn_proj"] += _attn_proj_flops(cfg, tokens)
            out["attn_score"] += batch * 2.0 * 2.0 * s_q * cross_kv \
                * cfg.num_heads * cfg.resolved_head_dim
    return out


def train_cost(cfg: ModelConfig, shape: ShapeConfig, data_shards: int,
               remat_policy: str = "dots_saveable",
               dtype_bytes: int = 2) -> StepCost:
    b = shape.global_batch
    if cfg.is_encoder_decoder:
        s_q, s_kv = WHISPER_DECODER_LEN, shape.seq_len
    else:
        s_q = s_kv = shape.seq_len
    tokens = b * s_q
    fwd = forward_flops(cfg, b, s_q, s_kv, data_shards)
    fwd["logits"] = 2.0 * tokens * cfg.d_model * cfg.vocab_size
    total_fwd = sum(fwd.values())
    # bwd: dgrad + wgrad = 2x fwd matmuls; remat recompute on top
    remat_mult = {"none": 0.0, "dots_saveable": 0.35, "full": 1.0}[remat_policy]
    flops = {f"fwd_{k}": v for k, v in fwd.items()}
    flops["bwd"] = 2.0 * total_fwd
    flops["remat"] = remat_mult * total_fwd
    n_params = cfg.param_count()
    model_flops = _model_flops(cfg, b, s_q, s_kv, train=True)
    p_bytes = n_params * dtype_bytes
    act_unit = tokens * cfg.d_model * dtype_bytes
    hbm = {
        "params_fwd": p_bytes,
        "params_bwd": p_bytes,
        "grads": n_params * 4.0,
        "opt": n_params * 4.0 * (2 if n_params < 15e9 else 0.02),
        "activations": act_unit * cfg.num_layers * (2 if remat_policy == "none" else 1) * 2,
        "logits": tokens * cfg.vocab_size * 4.0 * 2 / 8,   # chunked loss
    }
    return StepCost(flops, hbm, model_flops)


def prefill_cost(cfg: ModelConfig, shape: ShapeConfig, data_shards: int,
                 dtype_bytes: int = 2) -> StepCost:
    b = shape.global_batch
    if cfg.is_encoder_decoder:
        s_q, s_kv = WHISPER_DECODER_LEN, shape.seq_len
    else:
        s_q = s_kv = shape.seq_len
    tokens = b * s_q
    fwd = forward_flops(cfg, b, s_q, s_kv, data_shards)
    fwd["logits"] = 2.0 * b * cfg.d_model * cfg.vocab_size  # last position
    from repro_torch.serving.perf_model import (
        const_state_bytes, kv_bytes_per_token,
    )
    hbm = {
        "params": cfg.param_count() * dtype_bytes,
        "activations": tokens * cfg.d_model * dtype_bytes * cfg.num_layers,
        "kv_write": kv_bytes_per_token(cfg, dtype_bytes) * tokens
        + const_state_bytes(cfg) * b,
    }
    model_flops = _model_flops(cfg, b, s_q, s_kv, train=False)
    return StepCost({f"fwd_{k}": v for k, v in fwd.items()}, hbm, model_flops)


def decode_cost(cfg: ModelConfig, shape: ShapeConfig, data_shards: int,
                dtype_bytes: int = 2,
                resident_fraction: float = 1.0) -> StepCost:
    """One decode iteration: one new token per sequence, ctx = seq_len."""
    b, ctx = shape.global_batch, shape.seq_len
    fwd = forward_flops(cfg, b, 1, ctx, data_shards, decode=True)
    fwd["logits"] = 2.0 * b * cfg.d_model * cfg.vocab_size
    from repro_torch.serving.perf_model import (
        const_state_bytes, kv_bytes_per_token,
    )
    kv_read = kv_bytes_per_token(cfg, dtype_bytes)
    if cfg.sliding_window:
        kv_read = kv_read * min(ctx, cfg.sliding_window) / max(ctx, 1)
    hbm = {
        "params": cfg.param_count() * dtype_bytes * resident_fraction,
        "kv_read": kv_read * ctx * b,
        "state": const_state_bytes(cfg) * b * 2.0,
    }
    model_flops = _model_flops(cfg, b, 1, ctx, train=False, decode_tokens=1)
    return StepCost({f"fwd_{k}": v for k, v in fwd.items()}, hbm, model_flops)


def _collective_terms(cfg: ModelConfig, tokens: int, shards: int,
                      dtype_bytes: int) -> Tuple[float, int]:
    """Per-device wire bytes + collective count for one forward pass over
    ``tokens`` on a ``shards``-way model-parallel set (SERVING_RULES layout:
    heads/kv_heads/mlp/experts/vocab over "model", activations replicated).

    Ring all-reduce moves 2(N-1)/N of the payload per device; all-gather and
    all-to-all move (N-1)/N. Per block: one all-reduce after the mixer's
    output projection, one after the FFN; MoE adds dispatch+combine
    all-to-alls of the routed token copies. The vocab-sharded logits need a
    final all-gather. The count feeds the per-collective latency floor
    (``HardwareSpec.ici_latency_s``), which dominates at decode sizes.
    """
    if shards <= 1 or tokens <= 0:
        return 0.0, 0
    ring = 2.0 * (shards - 1) / shards
    gather = (shards - 1) / shards
    act = float(tokens) * cfg.d_model * dtype_bytes
    wire, n = 0.0, 0
    for ld in layer_defs(cfg):
        wire += ring * act                       # mixer out-proj all-reduce
        n += 1
        if ld.ffn == "moe":
            m = cfg.moe
            wire += 2.0 * gather * tokens * m.top_k * cfg.d_model * dtype_bytes
            wire += ring * act                   # combine all-reduce
            n += 3                               # a2a x2 + all-reduce
        elif ld.ffn == "dense":
            wire += ring * act
            n += 1
    wire += gather * float(tokens) * cfg.vocab_size * dtype_bytes
    n += 1                                       # logits all-gather
    return wire, n


def decode_collective_bytes(cfg: ModelConfig, batch: int, shards: int,
                            dtype_bytes: int = 2) -> Tuple[float, int]:
    """One decode step (one token per sequence): (per-device wire bytes,
    collective count). Zero at ``shards == 1``."""
    return _collective_terms(cfg, batch, shards, dtype_bytes)


def prefill_collective_bytes(cfg: ModelConfig, tokens: int, shards: int,
                             dtype_bytes: int = 2) -> Tuple[float, int]:
    """One prefill pass over ``tokens``: (per-device wire bytes, collective
    count). Zero at ``shards == 1``."""
    return _collective_terms(cfg, tokens, shards, dtype_bytes)


def cost_for(cfg: ModelConfig, shape: ShapeConfig, data_shards: int,
             **kw) -> StepCost:
    if shape.kind == "train":
        return train_cost(cfg, shape, data_shards, **kw)
    if shape.kind == "prefill":
        return prefill_cost(cfg, shape, data_shards)
    return decode_cost(cfg, shape, data_shards)
