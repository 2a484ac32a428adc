"""Config system: model architecture, input shapes, hardware, runtime.

Every assigned architecture is a ``ModelConfig`` in its own module
(``src/repro/configs/<id>.py``) and registered in ``configs.registry``.
Configs are plain frozen dataclasses — hashable, picklable, and safe to use
as static args to ``jax.jit``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (GShard-style capacity routing)."""
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    min_capacity: int = 8
    router_jitter: float = 0.0
    # every `period`-th layer is MoE (1 = all layers, 2 = alternating, ...)
    period: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent block sub-config (mLSTM / sLSTM / mamba)."""
    kind: str = "mlstm"           # "mlstm" | "slstm" | "mamba"
    d_state: int = 16             # mamba SSM state size
    d_conv: int = 4               # mamba conv width
    expand: int = 2               # mamba expansion factor
    chunk_size: int = 128         # chunkwise-parallel scan chunk
    # For xLSTM: one sLSTM block every `slstm_period` layers (0 = never).
    slstm_period: int = 0


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Field names follow the assignment table."""
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                     # dense FFN hidden (0 = no separate FFN)
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention
    rope_theta: float = 500000.0
    sliding_window: int = 0       # 0 = full attention; >0 = SWA window
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): attention every `attn_period` layers, rest are SSM.
    attn_period: int = 0          # 0 = all layers attention
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    max_source_len: int = 1500    # encoder output length used for decode cells
    # vlm (llava)
    num_image_patches: int = 0    # prefix patch embeddings supplied by stub
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # provenance, e.g. "[arXiv:2407.21783; unverified]"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length == num_layers (decoder stack).

        Kinds: "attn", "attn_moe", "ssm", "ssm_moe".
        """
        kinds = []
        for i in range(self.num_layers):
            if self.attn_period:
                # jamba-style: attention on every attn_period-th layer
                # (layer index attn_period-1 within each group), SSM otherwise.
                is_attn = (i % self.attn_period) == self.attn_period - 1
            elif self.family == "ssm":
                is_attn = False
            else:
                is_attn = True
            base = "attn" if is_attn else "ssm"
            if self.moe is not None and (i % self.moe.period) == (self.moe.period - 1):
                base += "_moe"
            kinds.append(base)
        return tuple(kinds)

    def _layer_params(self, kind: str, active: bool = False) -> int:
        """Params of one decoder layer of the given kind (norms + mixer +
        FFN/MoE). ``active=True`` counts only the params touched per token
        (MoE: router + top_k experts instead of all num_experts)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        total = 2 * d  # norms
        total += attn if kind.startswith("attn") else self._ssm_params()
        if kind.endswith("_moe"):
            m = self.moe
            n_e = m.top_k if active else m.num_experts
            total += d * m.num_experts + n_e * 3 * d * m.d_expert
        elif self.d_ff:
            total += 3 * d * self.d_ff  # SwiGLU
        return total

    def param_count(self) -> int:
        """Analytic parameter count (embedding + decoder stack [+ encoder])."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        total = embed
        for kind in self.layer_kinds():
            total += self._layer_params(kind)
        if self.is_encoder_decoder:
            # encoder self-attn + FFN + cross-attn params in decoder
            enc = self.num_encoder_layers * (attn + 2 * d * self.d_ff + 2 * d)
            cross = self.num_layers * (attn + d)
            total += enc + cross
        return total

    def _ssm_params(self) -> int:
        d = self.d_model
        s = self.ssm or SSMConfig()
        if s.kind == "mamba":
            d_in = s.expand * d
            return (d * 2 * d_in            # in_proj (x, z)
                    + d_in * s.d_conv       # conv
                    + d_in * (2 * s.d_state + 1) + d_in  # B,C,dt proj + A,D
                    + d_in * d)             # out_proj
        # mLSTM: q,k,v,o projections + i/f gates (matches MLSTM.specs)
        hd = self.resolved_head_dim
        nh = self.num_heads
        return 4 * d * (nh * hd) + 2 * d * nh + 2 * nh

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for k in self.layer_kinds() if k.endswith("_moe"))
        expert_params = n_moe_layers * m.num_experts * 3 * self.d_model * m.d_expert
        active_expert = n_moe_layers * m.top_k * 3 * self.d_model * m.d_expert
        return total - expert_params + active_expert

    @property
    def dtype_bytes(self) -> int:
        return {"float32": 4, "float64": 8}.get(self.dtype, 2)

    def bytes_for_layer(self, i: int, dtype_bytes: Optional[int] = None) -> int:
        """Parameter bytes of decoder layer ``i`` — the layer-granular remap
        unit. For MoE layers this includes ALL experts; expert-granular
        plans charge ``expert_bytes()`` per donated expert instead."""
        b = self.dtype_bytes if dtype_bytes is None else dtype_bytes
        return self._layer_params(self.layer_kinds()[i]) * b

    def expert_bytes(self, dtype_bytes: Optional[int] = None) -> int:
        """Bytes of ONE expert's FFN weights (``3 * d_model * d_expert``
        SwiGLU params) — the expert-granular remap unit. 0 for non-MoE."""
        if self.moe is None:
            return 0
        b = self.dtype_bytes if dtype_bytes is None else dtype_bytes
        return 3 * self.d_model * self.moe.d_expert * b

    def num_moe_layers(self) -> int:
        return sum(1 for k in self.layer_kinds() if k.endswith("_moe"))

    def active_params_per_token(self) -> int:
        """Per-layer decomposition of ``active_param_count`` — embedding plus
        each layer's per-token-active params. Equal to ``active_param_count``
        by construction; exists so PerfModel and expert plans can charge
        ``top_k`` experts per MoE layer rather than whole-layer totals."""
        d = self.d_model
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = embed
        for kind in self.layer_kinds():
            total += self._layer_params(kind, active=True)
        if self.is_encoder_decoder:
            hd = self.resolved_head_dim
            attn = (d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                    + (self.num_heads * hd) * d)
            enc = self.num_encoder_layers * (attn + 2 * d * self.d_ff + 2 * d)
            cross = self.num_layers * (attn + d)
            total += enc + cross
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned (seq_len, global_batch) input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class RuntimeConfig:
    """Knobs for a concrete run (training or serving)."""
    # parallelism
    mesh_shape: Tuple[int, ...] = (1, 1)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    fsdp_over_pod: bool = True        # shard params over pod axis too (>=1T)
    context_parallel: bool = True     # shard long-seq KV over model axis
    # training
    remat_policy: str = "dots_saveable"  # none|full|dots_saveable
    microbatches: int = 1
    optimizer: str = "adamw"          # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # serving / MIRAGE
    page_size: int = 16               # tokens per KV page
    max_remap_fraction: float = 0.5   # paper: capped remapping percentage
    remap_tiers: Tuple[float, ...] = (0.0, 0.125, 0.25, 0.5)
    double_buffer: bool = True        # beta=2 (m = alpha+2)
    victim_policy: str = "mru"        # mru | lru
    reversion_hysteresis: float = 0.2 # free-fraction above which we revert
    dynamic_reversion: bool = True


def scaled_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced-size config of the same family for CPU smoke tests."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe,
            num_experts=min(moe.num_experts, 8),
            top_k=min(moe.top_k, 2),
            d_expert=min(moe.d_expert, 64),
        )
    small = dataclasses.replace(
        cfg,
        num_layers=min(cfg.num_layers, 4),
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=32,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        num_image_patches=min(cfg.num_image_patches, 16) if cfg.num_image_patches else 0,
        max_source_len=64,
        moe=moe,
        dtype="float32",
    )
    if cfg.attn_period:
        small = dataclasses.replace(small, attn_period=min(cfg.attn_period, 4))
    if cfg.ssm is not None:
        small = dataclasses.replace(
            small, ssm=dataclasses.replace(cfg.ssm, chunk_size=16, d_state=8))
    return dataclasses.replace(small, **overrides)
