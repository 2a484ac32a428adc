"""Model blocks: RMSNorm, RoPE, GQA attention, the SwiGLU FFN, the chunked
SSD recurrence and the xLSTM mixers mLSTM and sLSTM (PyTorch counterpart of
``repro.models.blocks``).

Conventions as in the JAX package: x is [B, S, D] (sequence) or [B, D]
(decode); weights keep the JAX layouts (``wq`` [d, Hq, hd], ``wo`` [Hq, hd,
d]); K/V are cached post-RoPE at absolute positions. A recurrent mixer's
``fwd_seq`` returns its final state as its cache, and ``fwd_dec`` maps
(x, state) to (out, new state). MoE, mamba and the attention block's
dense decode wait for later slices (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
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


# ---------------------------------------------------------------------------
# Chunked scalar-decay linear attention (SSD): shared by mamba & mLSTM.
#   y_t = q_t . S_t ;  S_t = a_t * S_{t-1} + k_t v_t^T        (per head)
# ---------------------------------------------------------------------------

def ssd_chunked(
    q: torch.Tensor,        # [B, T, H, dk]
    k: torch.Tensor,        # [B, T, H, dk]
    v: torch.Tensor,        # [B, T, H, dv]
    log_a: torch.Tensor,    # [B, T, H]  (log decay in (-inf, 0])
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, dk, dv]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel linear recurrence (mamba-2 SSD / GLA style).
    Returns (y [B,T,H,dv], final_state [B,H,dk,dv]), f32 internally. The
    plain version of the ``ssd_scan`` kernel; the chunk is shrunk to the
    largest divisor of T not above the request, as in the JAX package."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    while t % chunk:          # largest divisor of t not above the request
        chunk -= 1
    n = t // chunk
    qc = q.reshape(b, n, chunk, h, dk).float()
    kc = k.reshape(b, n, chunk, h, dk).float()
    vc = v.reshape(b, n, chunk, h, dv).float()
    la = log_a.reshape(b, n, chunk, h).float()

    cum = torch.cumsum(la, dim=2)                    # [B,n,L,H] inclusive
    total = cum[:, :, -1]                            # [B,n,H]
    s = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device) \
        if init_state is None else init_state.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    ys = []
    for c in range(n):
        qi, ki, vi, cumi, toti = qc[:, c], kc[:, c], vc[:, c], cum[:, c], \
            total[:, c]
        # inter-chunk: y_inter_t = (q_t * exp(cum_t)) . S_prev
        q_dec = qi * torch.exp(cumi)[..., None]
        y_inter = _einsum("blhk,bhkv->blhv", q_dec, s)
        # intra-chunk: scores[t,s] = q_t.k_s * exp(cum_t - cum_s), t >= s
        scores = _einsum("blhk,bmhk->bhlm", qi, ki)
        decay = cumi[:, :, None, :] - cumi[:, None, :, :]     # [B,l,m,H]
        decay = decay.movedim(-1, 1)                          # [B,H,l,m]
        scores = torch.where(mask, scores * torch.exp(decay), 0.0)
        y_intra = _einsum("bhlm,bmhv->blhv", scores, vi)
        # state update: S = exp(total) S + sum_s exp(total - cum_s) k_s v_s^T
        k_dec = ki * torch.exp(toti[:, None] - cumi)[..., None]
        s = s * torch.exp(toti)[..., None, None] + _einsum(
            "blhk,blhv->bhkv", k_dec, vi)
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(b, t, h, dv)
    return y, s


def ssd_decode_step(q, k, v, log_a, state):
    """One-token recurrence. q/k [B,H,dk], v [B,H,dv], log_a [B,H],
    state [B,H,dk,dv] -> (y [B,H,dv], new_state)."""
    a = torch.exp(log_a.float())[..., None, None]
    state = state * a + _einsum("bhk,bhv->bhkv", k.float(), v.float())
    y = _einsum("bhk,bhkv->bhv", q.float(), state)
    return y, state


# ---------------------------------------------------------------------------
# mLSTM mixer (xLSTM matrix memory; sigmoid input gate for stability —
# documented simplification of the exponential gate).
#   C_t = f_t C + i_t v k^T ; n_t = f_t n + i_t k ; h = C q / max(|n.q|, 1)
# Implemented on the shared SSD primitive with v augmented by a ones column
# (the normalizer is just one extra value channel).
# ---------------------------------------------------------------------------

class MLSTM:
    def specs(self, cfg: ModelConfig) -> Dict[str, Spec]:
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        dt = dtype_of(cfg)
        f32 = torch.float32
        return {
            "wq": Spec((d, h, hd), ("embed", "heads", "head_dim"), dt, fan_in=d),
            "wk": Spec((d, h, hd), ("embed", "heads", "head_dim"), dt, fan_in=d),
            "wv": Spec((d, h, hd), ("embed", "heads", "head_dim"), dt, fan_in=d),
            "w_if": Spec((d, 2, h), ("embed", None, "heads"), f32,
                         "small_normal", fan_in=d),
            "b_if": Spec((2, h), (None, "heads"), f32, "zeros"),
            "wo": Spec((h, hd, d), ("heads", "head_dim", "embed"), dt, fan_in=d),
        }

    def init_state(self, cfg: ModelConfig, batch: int, _max_context: int):
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        return {
            "c": Spec((batch, h, hd, hd + 1),
                      ("batch", None, None, None), torch.float32, "zeros"),
        }

    def _gates(self, p, x):
        gf = _einsum("...d,dgh->...gh", x, p["w_if"]) + p["b_if"]
        i_gate = torch.sigmoid(gf[..., 0, :])
        log_f = F.logsigmoid(gf[..., 1, :])
        return i_gate, log_f

    def _qkv(self, p, x, cfg):
        hd = cfg.resolved_head_dim
        q = _einsum("...d,dhk->...hk", x, p["wq"]).to(x.dtype) * (hd ** -0.5)
        k = _einsum("...d,dhk->...hk", x, p["wk"]).to(x.dtype) * (hd ** -0.25)
        v = _einsum("...d,dhk->...hk", x, p["wv"]).to(x.dtype)
        return q, k, v

    @staticmethod
    def _v_aug(v, i_gate):
        ones = torch.ones(v.shape[:-1] + (1,), dtype=torch.float32,
                          device=v.device)
        return torch.cat([v.float(), ones], dim=-1) * i_gate[..., None]

    @staticmethod
    def _read(y):
        """y [..., hd+1] -> normalized h (last channel = normalizer n.q)."""
        num, den = y[..., :-1], y[..., -1:]
        return num / torch.clamp(den.abs(), min=1.0)

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        """On CUDA the recurrence is the hand-written ``ssd_scan`` kernel;
        on the CPU its plain version (the JAX model calls the same plain
        ``ssd_chunked`` at blocks.py:573)."""
        q, k, v = self._qkv(p, x, cfg)
        i_gate, log_f = self._gates(p, x)              # [b,t,h]
        v_aug = self._v_aug(v, i_gate)
        y, final = ssd_scan(q.contiguous(), k.contiguous(),
                            v_aug.contiguous(), log_f.contiguous(),
                            chunk=cfg.ssm.chunk_size)
        hh = self._read(y).to(x.dtype)
        out = _einsum("bthk,hkd->btd", hh, p["wo"]).to(x.dtype)
        return out, {"c": final}

    def fwd_dec(self, p, x, state, shared, cfg: ModelConfig):
        q, k, v = self._qkv(p, x, cfg)
        i_gate, log_f = self._gates(p, x)              # [b,h]
        y, new_c = ssd_decode_step(q, k, self._v_aug(v, i_gate), log_f,
                                   state["c"])
        hh = self._read(y).to(x.dtype)
        out = _einsum("bhk,hkd->bd", hh, p["wo"]).to(x.dtype)
        return out, {"c": new_c}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, per-head block-diagonal recurrence). Strictly
# sequential: a plain loop over time in f32 (no Pallas kernel on the TPU
# either; the JAX model scans it).
# ---------------------------------------------------------------------------

class SLSTM:
    def specs(self, cfg: ModelConfig) -> Dict[str, Spec]:
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        dt = torch.float32  # recurrent cell in fp32
        return {
            "w": Spec((d, 4, h, hd), ("embed", None, "heads", "head_dim"), dt,
                      fan_in=d),
            "r": Spec((h, 4, hd, hd), ("heads", None, "head_dim", None), dt,
                      "small_normal", fan_in=hd),
            "b": Spec((4, h, hd), (None, "heads", "head_dim"), dt, "zeros"),
            "wo": Spec((h, hd, d), ("heads", "head_dim", "embed"),
                       dtype_of(cfg), fan_in=d),
        }

    def init_state(self, cfg: ModelConfig, batch: int, _max_context: int):
        h, hd = cfg.num_heads, cfg.resolved_head_dim

        def z():
            return Spec((batch, h, hd), ("batch", "heads", None),
                        torch.float32, "zeros")
        return {"c": z(), "n": z(), "h": z()}

    @staticmethod
    def _cell(p, wx, state):
        """wx [B,4,H,hd] pre-activations; state {c,n,h}."""
        rec = _einsum("bhk,hgkl->bghl", state["h"], p["r"])
        za = wx + rec + p["b"][None]
        z = torch.tanh(za[:, 0])
        i = torch.sigmoid(za[:, 1])
        f = torch.sigmoid(za[:, 2])
        o = torch.sigmoid(za[:, 3])
        c = f * state["c"] + i * z
        n = f * state["n"] + i
        h = o * c / torch.clamp(n.abs(), min=1.0)
        return {"c": c, "n": n, "h": h}

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        b, t, _ = x.shape
        wx = _einsum("btd,dghk->btghk", x, p["w"])     # [b,t,4,h,hd]
        zeros = torch.zeros((b, cfg.num_heads, cfg.resolved_head_dim),
                            dtype=torch.float32, device=x.device)
        state = {"c": zeros, "n": zeros, "h": zeros}
        hs = []
        for i in range(t):
            state = self._cell(p, wx[:, i], state)
            hs.append(state["h"])
        hs = torch.stack(hs, dim=1).to(x.dtype)        # [b,t,h,hd]
        out = _einsum("bthk,hkd->btd", hs, p["wo"]).to(x.dtype)
        return out, state

    def fwd_dec(self, p, x, state, shared, cfg: ModelConfig):
        wx = _einsum("bd,dghk->bghk", x, p["w"])
        s2 = self._cell(p, wx, state)
        out = _einsum("bhk,hkd->bd", s2["h"].to(x.dtype), p["wo"]).to(x.dtype)
        return out, s2
