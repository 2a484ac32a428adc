"""Model blocks for attention stacks: RMSNorm, RoPE, GQA attention and the
SwiGLU FFN (PyTorch counterpart of ``repro.models.blocks``).

Conventions as in the JAX package: x is [B, S, D] (sequence) or [B, D]
(decode); weights keep the JAX layouts (``wq`` [d, Hq, hd], ``wo`` [Hq, hd,
d]); K/V are cached post-RoPE at absolute positions. MoE, mamba, mLSTM and
sLSTM blocks wait for later slices (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import Spec, dtype_of


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D] or [..., H, D] (decode); positions [..., S] or [...]."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.float()[..., None] * freqs      # [..., S, half]
    angles = angles.unsqueeze(-2)                      # broadcast heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _einsum(subs: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product accumulated in f32, returned in f32 (the JAX ``_einsum``
    with ``preferred_element_type=f32``). f32 operands multiply in f32.
    bf16 operands multiply on the tensor cores, which accumulate in f32 and
    round the result to bf16 once; that result is then widened."""
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    return torch.einsum(subs, a, b).float()


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

class Attention:
    """GQA self-attention with RoPE and optional sliding window."""

    def specs(self, cfg: ModelConfig) -> Dict[str, Spec]:
        d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim)
        dt = dtype_of(cfg)
        return {
            "wq": Spec((d, hq, hd), ("embed", "heads", "head_dim"), dt, fan_in=d),
            "wk": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), dt, fan_in=d),
            "wv": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), dt, fan_in=d),
            "wo": Spec((hq, hd, d), ("heads", "head_dim", "embed"), dt, fan_in=hq * hd),
        }

    def _qkv(self, p, x, cfg):
        return tuple(
            _einsum("...d,dhk->...hk", x, p[w]).to(x.dtype).contiguous()
            for w in ("wq", "wk", "wv"))

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        """Prefill over a full sequence. ctx: dict with 'positions' [B, S]
        (= arange, the positions the flash kernel assumes) and an optional
        'bidirectional' flag. On CUDA the attention is the hand-written
        flash kernel; on the CPU its plain version (the JAX model calls the
        same plain function at blocks.py:123)."""
        positions = ctx["positions"]
        q, k, v = self._qkv(p, x, cfg)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        causal = not ctx.get("bidirectional", False)
        out = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
        y = _einsum("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)
        return y, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

class SwiGLU:
    def specs(self, cfg: ModelConfig) -> Dict[str, Spec]:
        d, f = cfg.d_model, cfg.d_ff
        dt = dtype_of(cfg)
        return {
            "w_in": Spec((d, f), ("embed", "mlp"), dt, fan_in=d),
            "w_gate": Spec((d, f), ("embed", "mlp"), dt, fan_in=d),
            "w_out": Spec((f, d), ("mlp", "embed"), dt, fan_in=f),
        }

    def __call__(self, p, x):
        h = _einsum("...d,df->...f", x, p["w_in"])
        g = _einsum("...d,df->...f", x, p["w_gate"])
        h = F.silu(g) * h
        # f32 weights: the f32 hidden meets w_out as in the JAX model. bf16
        # weights: the hidden is rounded to bf16 first, so the product stays
        # on the tensor cores (the JAX model widens w_out instead).
        return _einsum("...f,fd->...d", h.to(p["w_out"].dtype),
                       p["w_out"]).to(x.dtype)
