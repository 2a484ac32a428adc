"""Model blocks: RMSNorm, RoPE, GQA attention (with its dense and ring
decode caches), the SwiGLU and MoE FFNs, the chunked SSD recurrence and the
mixers built on it (Mamba, mLSTM), and sLSTM (PyTorch counterpart of
``repro.models.blocks``).

Conventions as in the JAX package: x is [B, S, D] (sequence) or [B, D]
(decode); weights keep the JAX layouts (``wq`` [d, Hq, hd], ``wo`` [Hq, hd,
d], the experts' ``w_in`` [E, d, f]); K/V are cached post-RoPE at absolute
positions. A mixer's ``fwd_seq`` returns its cache (attention: the prompt's
K/V; a recurrent mixer: its final state), and ``fwd_dec`` maps (x, state)
to (out, new state). ``Attention(cross=True)`` is enc-dec's
cross-attention: queries from the decoder, K/V from the encoder's output,
no RoPE, no mask; its cache is computed once at prefill and only read after.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.graphs import replayable
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.distributed.collectives import (
    all_gather_dim, all_to_all_dim, copy_to_region, fsdp_gather, gather_over,
    gather_region, reduce_from_region, scatter_region, sum_over, tp_gather,
)
from repro_torch.distributed.sharding import (
    axis_sizes, batch_axis_names, get_mesh, get_rules, mesh_group,
    mesh_index, spec_axes, spec_for,
)
from repro_torch.models.attention_ops import (
    decode_attention, distributed_decode_attention,
)
from repro_torch.models.common import Spec, dtype_of, remat


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
    """GQA self-attention with RoPE and optional sliding window, or, with
    ``cross=True``, enc-dec cross-attention over the encoder's output."""

    def __init__(self, cross: bool = False):
        self.cross = cross

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

    @staticmethod
    def _whole(w, sp, name: str, a, mesh, hd):
        """The projection of rows ``a`` by leaf ``name`` (wq, wk or wv),
        every head with its whole head_dim, from the rank's block under a
        head_dim split over ``hd`` (``_head_dim_axes``): gathered over
        ``hd`` along the dimension the leaf's spec splits (head_dim, or the
        KV heads where the axes divide them); a leaf kept whole enters the
        region through a *copy to region*. The gather's backward
        reduce-scatters, so the rank's block gets the whole gradient."""
        dims = [d for d in (1, 2) if spec_axes(sp[name], d)]
        wn = w[name] if dims else copy_to_region(w[name], mesh, hd)
        t = _einsum("...d,dhk->...hk", a, wn).to(a.dtype)
        if dims:
            t = gather_region(t, mesh, hd, t.dim() - 3 + dims[0], "head_dim")
        return t.contiguous()

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        """Prefill over a full sequence. ctx: dict with 'positions' [B, S]
        (= arange, the positions the flash kernel assumes), an optional
        'bidirectional' flag and, for cross-attention, 'enc_out' [B, Senc,
        D]: q from the decoder rows x, k/v from the encoder's rows, no
        RoPE, unmasked (Sq = S against Sk = Senc). On CUDA the attention is
        the hand-written flash kernel; on the CPU its plain version (the
        JAX model calls the same plain function at blocks.py:115 and
        :123). Returns (y, cache {k, v}).

        ``ctx["mesh"]``: the block on the rank's blocks of the weights
        (``_gathered``): q/k/v column-parallel over the heads' axes, ``wo``
        row-parallel, its partial sums reduced over them. Each spec is read
        as the fallback left it: heads that stay whole run on every rank,
        with no collective. Where the query heads split and the KV heads
        stay whole, each rank takes the KV heads its query heads read,
        through a *copy to region* of wk/wv whose backward sums their
        partial gradients over the heads' axes. The activations that enter
        the region (x, and the encoder's output, whole on every rank of
        those axes) enter through a *copy to region* too, so that their
        gradients are the sums over the heads' axes: the encoder's leaves,
        which the decoder reaches only through cross-attention, get the
        whole gradient. With no mesh every collective is the identity.

        Where the rules split head_dim instead (``_head_dim_axes``: the
        ``head-tp`` profile), every head runs on every rank: the rank's
        head_dim blocks of q, k and v are gathered whole over those axes
        (``_whole``), the kernel runs on them unchanged, and ``wo`` is
        row-parallel over head_dim on the rank's block of the output. The
        cache is then every KV head, whole."""
        mesh = ctx.get("mesh")
        w, sp = _gathered(self, p, cfg, mesh)
        hd = _head_dim_axes(sp)
        if hd:
            x_in = copy_to_region(x, mesh, hd)
            src = copy_to_region(ctx["enc_out"], mesh, hd) if self.cross \
                else x_in
            q, k, v = (self._whole(w, sp, n, a, mesh, hd) for n, a in
                       (("wq", x_in), ("wk", src), ("wv", src)))
            if self.cross:
                out = flash_attention(q, k, v, causal=False)
            else:
                positions = ctx["positions"]
                q = rope(q, positions, cfg.rope_theta)
                k = rope(k, positions, cfg.rope_theta)
                out = flash_attention(
                    q, k, v, causal=not ctx.get("bidirectional", False),
                    window=cfg.sliding_window)
            y = reduce_from_region(
                _einsum("bshk,hkd->bsd", _own_block(out, w, mesh, hd),
                        w["wo"]), mesh, hd)
            return y.to(x.dtype), {"k": k, "v": v}
        axes = _attn_heads_axes(sp)
        if axes and not spec_axes(sp["wk"], 1):
            heads = _kv_heads_read(cfg, w["wq"].shape[1],
                                   mesh_index(mesh, axes))
            w = dict(w, **{n: copy_to_region(w[n], mesh, axes)[:, heads]
                           for n in ("wk", "wv")})
        x_in = copy_to_region(x, mesh, axes)
        if self.cross:
            # the projections come out contiguous, as the kernel's TMA maps
            # need
            enc = copy_to_region(ctx["enc_out"], mesh, axes)
            q = _einsum("bsd,dhk->bshk", x_in, w["wq"]).to(x.dtype)\
                .contiguous()
            k, v = (_einsum("bsd,dhk->bshk", enc, w[n]).to(x.dtype)
                    .contiguous() for n in ("wk", "wv"))
            out = flash_attention(q, k, v, causal=False)
        else:
            positions = ctx["positions"]
            q, k, v = self._qkv(w, x_in, cfg)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            causal = not ctx.get("bidirectional", False)
            out = flash_attention(q, k, v, causal=causal,
                                  window=cfg.sliding_window)
        y = reduce_from_region(_einsum("bshk,hkd->bsd", out, w["wo"]),
                               mesh, axes)
        return y.to(x.dtype), {"k": k, "v": v}

    # ------------------------------------------------ dense and ring decode
    def cache_len(self, cfg: ModelConfig, max_context: int) -> int:
        if cfg.sliding_window:
            return min(max_context, cfg.sliding_window)
        return max_context

    def init_state(self, cfg: ModelConfig, batch: int, max_context: int):
        """The dense decode cache {k, v} [batch, cache_len, Hkv, hd]: the
        sequence over "kv_seq", or, for a batch of one, "kv_seq_full" (the
        reference's pure context parallelism over every axis); every KV
        head on every rank."""
        hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        s = self.cache_len(cfg, max_context)
        dt = dtype_of(cfg)
        logical = ("batch", _seq_logical(batch), None, None)
        return {"k": Spec((batch, s, hkv, hd), logical, dt, "zeros"),
                "v": Spec((batch, s, hkv, hd), logical, dt, "zeros")}

    def seq_cache_to_state(self, cfg: ModelConfig, cache, max_context: int,
                           mesh=None, batch: int = 0):
        """Prefill K/V [..., S, Hkv, hd] (any leading dims: the LM passes
        them stacked [R, B, ...]) into a decode cache [..., cache_len, Hkv,
        hd]. A ring (sliding-window) cache whose prompt fills it keeps the
        last ``window`` tokens, token t at slot t % window. Cross-attention
        keeps the encoder's K/V as they are.

        ``mesh`` (with the global ``batch``): ``cache`` holds the rank's
        rows and the KV heads its ``fwd_seq`` computed, over the whole
        prompt; the result is the rank's block of the decode state
        (``init_state``'s layout): every KV head over the rank's slice of
        the sequence (``_cache_layout``); cross-attention's, every KV head
        over the whole source."""
        k, v = cache["k"], cache["v"]
        if self.cross:                  # the encoder's K/V, as they are
            return {n: _all_kv_heads(self, cfg, a, mesh)
                    for n, a in (("k", k), ("v", v))}
        s = k.shape[-3]
        s_c = self.cache_len(cfg, max_context)
        if cfg.sliding_window and s >= s_c:
            last = s - s_c
            ar = torch.arange(s_c, device=k.device)
            take = (last + ar)[torch.argsort((last + ar) % s_c)]
            k, v = k.index_select(-3, take), v.index_select(-3, take)
        else:
            def pad(a):
                out = a.new_zeros(a.shape[:-3] + (s_c,) + a.shape[-2:])
                out[..., :s, :, :] = a
                return out
            k, v = pad(k), pad(v)
        if mesh is None:
            return {"k": k, "v": v}
        return {n: _cache_layout(self, cfg, a, mesh, batch)
                for n, a in (("k", k), ("v", v))}

    def fwd_dec(self, p, x, state, shared, cfg: ModelConfig):
        """Decode one token. x [B, D]; state {k, v} [B, Sc, Hkv, hd];
        shared: pos [B], slot [B], kv_pos [B, Sc], kv_valid [B, Sc]. The new
        token's K/V row is written IN PLACE at ``slot`` (the JAX block
        returns an updated copy), so the state it returns is empty: nothing
        is left for the caller to write back.

        Under a mesh (``mesh_context``) x, pos and slot are the rank's rows
        of the batch and the state, kv_pos and kv_valid the rank's block of
        the cache (``decode_cache_slices``: ``init_state``'s layout, every
        KV head); shared also holds ``cache_len``, the whole cache's
        length, and ``batch``, the global batch (default: x's rows, a batch
        no axis splits). The weights are the rank's blocks (``_gathered``:
        FSDP-gathered, the heads split over their axes) or whole (their
        full shapes: nothing split). q, k and v are projected for the
        rank's heads and gathered over the heads' axes to every head; the
        rank whose slice holds ``slot`` writes the new row; the attention
        is the flash-decode over the axes that split the sequence
        (``distributed_decode_attention``), local where none does; ``wo``
        is row-parallel on the rank's heads, its partial sums reduced over
        their axes.

        Cross-attention: Q only, against the cross cache ``state`` {k, v}
        [B, Ssrc, Hkv, hd] (every KV head) under ``shared["cross_pos"]``/
        ``["cross_valid"]`` [B, Ssrc], unmasked otherwise; it writes
        nothing. Over a mesh, heads-parallel: the rank's query heads
        against the KV heads they read.

        Under a head_dim split (``_head_dim_axes``) the rank's blocks of q
        and the new K/V row are gathered whole (``_whole``), the attention
        runs on every head, and ``wo`` is row-parallel over head_dim."""
        mesh = get_mesh()
        w, sp = _gathered(self, p, cfg, mesh)
        hd = _head_dim_axes(sp)
        axes = _attn_heads_axes(sp)
        pos = shared["pos"]
        if self.cross:
            if hd:
                q = self._whole(w, sp, "wq", x, mesh, hd)
            else:
                q = _einsum("bd,dhk->bhk", x, w["wq"]).to(x.dtype)
            kv = _kv_index(cfg, w, sp, mesh)
            out = decode_attention(q, state["k"][:, :, kv],
                                   state["v"][:, :, kv], pos,
                                   shared["cross_pos"], shared["cross_valid"],
                                   causal=False)
            y = reduce_from_region(
                _einsum("bhk,hkd->bd", _own_block(out, w, mesh, hd),
                        w["wo"]), mesh, axes or hd, "decode_tp_all_reduce")
            return y.to(x.dtype), {}
        if hd:
            q, k_new, v_new = (self._whole(w, sp, n, x, mesh, hd)
                               for n in ("wq", "wk", "wv"))
            q = rope(q, pos, cfg.rope_theta)
            k_new = rope(k_new, pos, cfg.rope_theta)
        else:
            q, k_new, v_new = self._qkv(w, x, cfg)
            q = _all_heads(rope(q, pos, cfg.rope_theta), mesh, axes)
            kv_w = spec_axes(sp["wk"], 1)
            k_new = _all_heads(rope(k_new, pos, cfg.rope_theta), mesh, kv_w)
            v_new = _all_heads(v_new, mesh, kv_w)
        kv_axes, s0 = _mesh_decode_layout(mesh, x, state, shared)
        s_l = state["k"].shape[1]
        slot = shared["slot"].long() - s0
        mine = ((slot >= 0) & (slot < s_l))[:, None, None]
        idx = (torch.arange(slot.shape[0], device=x.device),
               slot.clamp(0, s_l - 1))
        # rows whose slot lies on another rank write back what they hold:
        # no host sync on a boolean index
        for name, new in (("k", k_new), ("v", v_new)):
            cache = state[name]
            cache[idx] = torch.where(mine, new, cache[idx])
        if kv_axes:
            out = distributed_decode_attention(
                mesh, kv_axes, q, state["k"], state["v"], pos,
                shared["kv_pos"], shared["kv_valid"],
                window=cfg.sliding_window)
        else:
            out = decode_attention(q, state["k"], state["v"], pos,
                                   shared["kv_pos"], shared["kv_valid"],
                                   window=cfg.sliding_window)
        hq = w["wq"].shape[1]
        h0 = mesh_index(mesh, axes) * hq
        y = reduce_from_region(
            _einsum("bhk,hkd->bd", _own_block(out[:, h0:h0 + hq], w, mesh,
                                              hd), w["wo"]),
            mesh, axes or hd, "decode_tp_all_reduce")
        return y.to(x.dtype), {}


def _specs(block, cfg: ModelConfig, mesh):
    """Each leaf's spec of a block on ``mesh`` as the rules and the
    divisibility fallback resolve it."""
    rules = get_rules()
    return {n: spec_for(s.logical, s.shape, mesh, rules)
            for n, s in block.specs(cfg).items()}


def _gathered(block, p, cfg: ModelConfig, mesh):
    """(weights, specs) of a block's leaves ``p`` on ``mesh``: each spec as
    the rules and the divisibility fallback resolve it, each weight
    FSDP-gathered over its data axes where it is used (its tensor-parallel
    splits stay). With no mesh, or leaves of their full shapes (weights
    kept whole on every rank): ``p``, nothing split."""
    full = block.specs(cfg)
    if mesh is None or all(tuple(p[n].shape) == tuple(s.shape)
                           for n, s in full.items()):
        return p, dict.fromkeys(p, ())
    sp = _specs(block, cfg, mesh)
    return {n: fsdp_gather(p[n], sp[n], mesh) for n in sp}, sp


def _head_dim_axes(sp) -> Tuple[str, ...]:
    """The axes that split an attention block's head_dim (the ``head-tp``
    profile: ``wq`` and ``wo`` split head_dim, the heads stay whole; ``wk``
    and ``wv`` split the KV heads over them where they divide, head_dim
    otherwise, or stay whole); () where head_dim stays whole."""
    hd = spec_axes(sp["wq"], 2)
    if not hd and not spec_axes(sp["wo"], 1):
        return ()
    kv = {spec_axes(sp[n], d) for n in ("wk", "wv") for d in (1, 2)} - {()}
    if (spec_axes(sp["wq"], 1) or spec_axes(sp["wo"], 0)
            or spec_axes(sp["wo"], 1) != hd or kv - {hd}
            or spec_axes(sp["wk"], 1) != spec_axes(sp["wv"], 1)):
        raise ValueError(f"a head_dim split over {hd} takes whole heads, wo "
                         f"split alike and wk/wv split over it or whole: "
                         f"{sp}")
    return hd


def _own_block(out: torch.Tensor, w, mesh, hd) -> torch.Tensor:
    """out [..., H, hd] cut to the rank's head_dim block of ``wo`` [H,
    hd_local, d] under a head_dim split over ``hd`` (``out`` itself where
    there is none)."""
    if not hd:
        return out
    n = w["wo"].shape[1]
    return out.narrow(-1, mesh_index(mesh, hd) * n, n)


def _attn_heads_axes(sp) -> Tuple[str, ...]:
    """The axes that split an attention block's query heads; its KV heads
    split over the same axes or stay whole, and ``wo``'s heads follow the
    query heads'. () under a head_dim split (``_head_dim_axes``): every
    rank computes every head, and its caches hold them all."""
    if _head_dim_axes(sp):
        return ()
    axes = spec_axes(sp["wq"], 1)
    kv_axes = spec_axes(sp["wk"], 1)
    if (kv_axes and kv_axes != axes) or spec_axes(sp["wo"], 0) != axes:
        raise ValueError(f"the heads of wq, wk/wv and wo split over "
                         f"{axes}, {kv_axes}, {spec_axes(sp['wo'], 0)}")
    return axes


def _all_heads(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """t [B, H_local, ...], the rank's block of the heads over ``axes``,
    gathered to every head (``t`` itself where ``axes`` is empty)."""
    if not axes:
        return t
    return all_gather_dim(t, mesh_group(mesh, axes), 1,
                          "decode_heads_all_gather")


def _kv_held(cfg: ModelConfig, sp, hq_local: int, hkv_local: int,
             block: int):
    """The KV heads of the rank at ``block`` along the query heads' axes:
    its block of them where they split, else the heads its query heads
    read (``_kv_heads_read``: a slice, or a list in their order, repeats
    included); its ``fwd_seq`` computes their K/V."""
    if spec_axes(sp["wk"], 1):
        return slice(block * hkv_local, (block + 1) * hkv_local)
    return _kv_heads_read(cfg, hq_local, block)


def _kv_index(cfg: ModelConfig, w, sp, mesh):
    """The heads of a cache that holds every KV head which the rank's
    query heads read (``_kv_held``); every head where the heads stay
    whole."""
    axes = _attn_heads_axes(sp)
    if not axes:
        return slice(None)
    return _kv_held(cfg, sp, w["wq"].shape[1], w["wk"].shape[1],
                    mesh_index(mesh, axes))


def _dedup_heads(a: torch.Tensor, ids, dim: int) -> torch.Tensor:
    """The KV heads 0..Hkv-1 of ``a``, whose dimension ``dim`` holds the
    heads ``ids`` (every head at least once), each from its first
    place."""
    first = {}
    for j, h in enumerate(ids):
        first.setdefault(h, j)
    order = [first[h] for h in range(len(first))]
    if order == list(range(a.shape[dim])):
        return a
    return a.index_select(dim, torch.tensor(order, device=a.device))


def _rank_kv_ids(block, cfg: ModelConfig, mesh):
    """(the heads' axes, each rank's KV head ids along them, in rank
    order) of the prefill caches ``block``'s ``fwd_seq`` makes on the
    ranks of ``mesh``; ((), None) where every rank holds every head."""
    if mesh is None:
        return (), None
    sp = _specs(block, cfg, mesh)
    axes = _attn_heads_axes(sp)
    if not axes:
        return (), None
    n = math.prod(axis_sizes(mesh)[ax] for ax in axes)
    every = list(range(cfg.num_kv_heads))
    ids = []
    for i in range(n):
        held = _kv_held(cfg, sp, cfg.num_heads // n, cfg.num_kv_heads // n, i)
        ids += every[held] if isinstance(held, slice) else held
    return axes, ids


def _all_kv_heads(block, cfg: ModelConfig, a: torch.Tensor, mesh):
    """A prefill cache ``a`` [..., S, Hk_local, hd] of the rank's KV heads
    gathered over the heads' axes to every KV head."""
    axes, ids = _rank_kv_ids(block, cfg, mesh)
    if not axes:
        return a
    a = all_gather_dim(a, mesh_group(mesh, axes), a.dim() - 2,
                       "cache_heads_all_gather")
    return _dedup_heads(a, ids, a.dim() - 2).contiguous()


def _cache_layout(block, cfg: ModelConfig, a: torch.Tensor, mesh,
                  batch: int):
    """The rank's block of a decode cache in ``init_state``'s layout, from
    ``a`` [..., B_local, Sc, Hk_local, hd]: the rank's rows, the decode
    cache's whole sequence, the KV heads the rank's ``fwd_seq`` computed.
    Where the heads' axes also split the sequence (they are the last of
    its axes, as "model" is), one all-to-all over them turns heads into
    sequence (each rank sends each other rank that rank's slice of its
    heads) inside the block of the sequence that the other axes give the
    rank; where they do not, an all-gather of the heads, then the rank's
    slice of the sequence."""
    s_c = a.shape[-3]
    kv_axes, _ = decode_layout(mesh, batch, s_c)
    axes, ids = _rank_kv_ids(block, cfg, mesh)
    seq_dim = a.dim() - 3
    if axes and kv_axes[len(kv_axes) - len(axes):] == axes:
        outer = kv_axes[:len(kv_axes) - len(axes)]
        blk = _block(mesh, outer, s_c)
        a = all_to_all_dim(a.narrow(seq_dim, blk.start, blk.stop - blk.start),
                           mesh_group(mesh, axes), seq_dim, a.dim() - 2,
                           "cache_all_to_all")
        return _dedup_heads(a, ids, a.dim() - 2).contiguous()
    if set(axes) & set(kv_axes):
        raise ValueError(f"the heads split over {axes} and the cache's "
                         f"sequence over {kv_axes}")
    a = _all_kv_heads(block, cfg, a, mesh)
    seq = _block(mesh, kv_axes, s_c)
    return a.narrow(seq_dim, seq.start, seq.stop - seq.start).contiguous()


def _heads_axes(sp, dims: Dict[str, int]) -> Tuple[str, ...]:
    """The axes that split the heads of a heads-parallel block: dimension
    ``dims[name]`` of each leaf's spec must split over the same axes (or
    every one stay whole), since no head's work crosses ranks."""
    split = {n: spec_axes(sp[n], dim) for n, dim in dims.items()}
    axes = set(split.values())
    if len(axes) > 1:
        raise ValueError(f"the heads of a block split unevenly: {split}")
    return axes.pop()


def _heads_or_head_dim(sp, heads: Dict[str, int], head_dim: Dict[str, int]
                       ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(the axes that split a block's heads, those that split its
    head_dim: ``_heads_axes`` of each leaf's dims in ``heads`` and in
    ``head_dim``); at most one of the two splits."""
    axes, hd = _heads_axes(sp, heads), _heads_axes(sp, head_dim)
    if axes and hd:
        raise ValueError(f"a block splits its heads over {axes} and its "
                         f"head_dim over {hd}")
    return axes, hd


def _kv_heads_read(cfg: ModelConfig, hq_local: int, block: int):
    """The KV heads that query heads ``block * hq_local`` on read (GQA: head
    h reads KV head h // (Hq / Hkv)), for a rank whose query heads are
    split and whose KV heads are whole: a slice where the rank's query
    heads fall into equal groups of its KV heads, else one KV head per
    query head (a list index)."""
    g = cfg.num_heads // cfg.num_kv_heads
    q0 = block * hq_local
    ids = [h // g for h in range(q0, q0 + hq_local)]
    first, n = ids[0], ids[-1] - ids[0] + 1
    per = hq_local // n
    if per * n == hq_local and ids == [first + i // per
                                       for i in range(hq_local)]:
        return slice(first, first + n)
    return ids


def _seq_logical(batch: int) -> str:
    """The logical axis of a decode cache's sequence: a batch of one splits
    it over every axis (the reference's long-context cells)."""
    return "kv_seq_full" if batch == 1 else "kv_seq"


def decode_layout(mesh, batch: int, cache_len: int
                  ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(kv_axes, rows_axes) of a decode cache [batch, cache_len, ...]
    under the mesh and the ambient rules: the axes that split its sequence
    and its rows in ``init_state``'s layout, the reference's state
    layout; ((), ()) with no mesh. ``fwd_dec`` flash-decodes over
    ``kv_axes`` (locally where they are empty)."""
    if mesh is None:
        return (), ()
    logical = ("batch", _seq_logical(batch), None, None)
    spec = spec_for(logical, (batch, cache_len, 1, 1), mesh, get_rules())
    return spec_axes(spec, 1), spec_axes(spec, 0)


def rows_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The axes that split a serving batch of ``batch`` rows (the logical
    "batch": the data axes that divide it); () with no mesh."""
    if mesh is None:
        return ()
    return spec_axes(spec_for(("batch",), (batch,), mesh, get_rules()), 0)


def _mesh_decode_layout(mesh, x, state, shared):
    """(kv_axes, the first position of the rank's slice) of ``fwd_dec``'s
    cache under the mesh, at the whole cache's length
    ``shared["cache_len"]`` and the global batch ``shared["batch"]``
    (default: x's rows); the state must hold the rank's block of that
    cache (``decode_cache_slices``). ((), 0) with no mesh."""
    if mesh is None:
        return (), 0
    if "cache_len" not in shared:
        raise ValueError("under a mesh, fwd_dec needs shared['cache_len'], "
                         "the whole cache's length")
    b, s_c = int(shared.get("batch", x.shape[0])), int(shared["cache_len"])
    rows, seq = decode_cache_slices(mesh, b, s_c)
    want = (rows.stop - rows.start, seq.stop - seq.start)
    if (x.shape[0],) + tuple(state["k"].shape[1:2]) != want:
        raise ValueError(
            f"this rank's slice of a [{b}, {s_c}] cache is {want} (rows, "
            f"sequence); x and the state hold "
            f"{(x.shape[0],) + tuple(state['k'].shape[1:2])}")
    kv_axes, _ = decode_layout(mesh, b, s_c)
    return kv_axes, seq.start


def _block(mesh, axes, n: int) -> slice:
    """This rank's contiguous block of a dimension of ``n`` split over
    ``axes``."""
    if not axes:
        return slice(0, n)
    parts = math.prod(axis_sizes(mesh)[ax] for ax in axes)
    if n % parts:
        raise ValueError(f"a dimension of {n} does not split over {axes} "
                         f"({parts} blocks)")
    i = mesh_index(mesh, axes)
    return slice(i * n // parts, (i + 1) * n // parts)


def mesh_shared(shared, mesh, batch: int, cache_len: int):
    """A decode step's ``shared`` on ``mesh``: ``kv_pos``/``kv_valid``
    [B_local, cache_len] cut to the rank's span of the cache's sequence
    (``decode_layout``), and the global ``batch`` and ``cache_len`` that
    ``Attention.fwd_dec`` reads; ``shared`` as it is with no mesh."""
    if mesh is None:
        return shared
    kv_axes, _ = decode_layout(mesh, batch, cache_len)
    seq = _block(mesh, kv_axes, cache_len)
    return dict(shared, kv_pos=shared["kv_pos"][:, seq],
                kv_valid=shared["kv_valid"][:, seq], cache_len=cache_len,
                batch=batch)


def decode_cache_slices(mesh, batch: int, cache_len: int
                        ) -> Tuple[slice, slice]:
    """This rank's rows and sequence span of a decode cache [batch,
    cache_len, ...] under the mesh (``decode_layout``): the block
    ``Attention.fwd_dec`` reads from the state and ``kv_pos``/
    ``kv_valid``."""
    kv_axes, row_axes = decode_layout(mesh, batch, cache_len)
    return _block(mesh, row_axes, batch), _block(mesh, kv_axes, cache_len)


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

    def __call__(self, p, x, mesh=None, cfg: Optional[ModelConfig] = None):
        """``mesh`` (with the ``cfg`` whose specs give the weights' full
        shapes): on the rank's blocks (``_gathered``), w_in/w_gate
        column-parallel over the mlp dim's axes, w_out row-parallel with
        its partial sums reduced over them (no collective where the
        fallback keeps the mlp dim whole, or with no mesh)."""
        p, sp = _gathered(self, p, cfg, mesh)
        axes = spec_axes(sp["w_in"], 1)
        x_in = copy_to_region(x, mesh, axes)
        h = _einsum("...d,df->...f", x_in, p["w_in"])
        g = _einsum("...d,df->...f", x_in, p["w_gate"])
        h = F.silu(g) * h
        # f32 weights: the f32 hidden meets w_out as in the JAX model. bf16
        # weights: the hidden is rounded to bf16 first, so the product stays
        # on the tensor cores (the JAX model widens w_out instead).
        y = _einsum("...f,fd->...d", h.to(p["w_out"].dtype), p["w_out"])
        return reduce_from_region(y, mesh, axes).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE FFN: sort-gather dispatch into per-expert capacity slots, the expert
# products as batched matmuls over the weights' own [E, ...] layout, and a
# deterministic combine.
# ---------------------------------------------------------------------------

def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product returned in f32, with ``_einsum``'s rounding."""
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    return torch.bmm(a, b).float()


class MoE:
    def specs(self, cfg: ModelConfig) -> Dict[str, Spec]:
        m = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_expert
        dt = dtype_of(cfg)
        return {
            "router": Spec((d, e), ("embed", None), torch.float32, fan_in=d),
            "w_in": Spec((e, d, f), ("experts", "expert_mlp", "expert_ff"),
                         dt, fan_in=d),
            "w_gate": Spec((e, d, f), ("experts", "expert_mlp", "expert_ff"),
                           dt, fan_in=d),
            "w_out": Spec((e, f, d), ("experts", "expert_ff", "expert_mlp"),
                          dt, fan_in=f),
        }

    @staticmethod
    def _capacity(tokens_per_group: int, m) -> int:
        lam = tokens_per_group * m.top_k / m.num_experts
        c = int(math.ceil(lam * m.capacity_factor))
        # Poisson +3 sigma floor (see the JAX block): keeps decode-scale
        # token counts from dropping assignments
        c3 = int(math.ceil(lam + 3.0 * math.sqrt(max(lam, 1e-9))))
        return min(tokens_per_group, max(c, c3, m.min_capacity))

    @staticmethod
    def _data(mesh, data=None) -> Tuple[Tuple[str, ...], int]:
        """(data axes, data shards): under a mesh the MoE's rows are this
        data rank's block of the global batch's tokens, in their order,
        split over ``data`` (default: every data axis of the mesh)."""
        if mesh is None:
            return (), 1
        if data is None:
            data = batch_axis_names(mesh)
        sizes = axis_sizes(mesh)
        return tuple(data), math.prod(sizes[ax] for ax in data)

    def route(self, p, xf: torch.Tensor, cfg: ModelConfig, mesh=None,
              data=None):
        """Routing of the tokens xf [T, D]: the router's softmax ``probs``
        [T, E] (f32), the top-k experts ``top_e`` [T, k], and the capacity
        slots of the group the tokens route in: ``disp`` [E * cap] (the
        source token of each slot, T for an empty one), ``wcomb`` [E * cap]
        (its combine weight) and ``slot`` [T, k] (each assignment's slot in
        ascending order, E * cap where capacity dropped it). ``p["router"]``
        is the whole router.

        With no mesh all tokens form one group. Under a ``mesh`` xf is this
        data rank's block of the global batch's t tokens (split over every
        data axis: ``_data``; ``Model.batch_shardings`` refuses a batch that
        is not), grouped as the JAX block groups
        them: g = 1 where t * k <= 8 E, else g = gcd(t, data shards), one
        group per data rank. g = shards: the rank's rows are a group of
        their own, capacity ``_capacity`` of its T tokens; nothing crosses
        ranks. g = 1: one group of every rank's tokens, capacity of t; each
        rank's pre-capacity per-expert counts are all-gathered over the data
        axes (``moe_counts``, the only exchange), and an assignment's place
        in its expert is its place among this rank's plus the counts of the
        ranks before it: the JAX block's stable sort by expert over the
        global token order. ``slot`` is then in the group's numbering and
        ``disp`` holds this rank's tokens only (T at a slot that another
        rank's token fills). ``data``: the axes that split the rows where
        not every data axis does (a serving batch of one row: none)."""
        m = cfg.moe
        t = xf.shape[0]
        e, k = m.num_experts, m.top_k
        data, shards = self._data(mesh, data)
        exchange = shards > 1 and t * shards * k <= 8 * e
        cap = self._capacity(t * shards if exchange else t, m)
        dev = xf.device
        probs = torch.softmax(_einsum("td,de->te", xf, p["router"]), dim=-1)
        top_p, top_e = torch.topk(probs, k, dim=-1)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        flat_e = top_e.reshape(t * k)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        # position within the expert = rank - first rank of that expert
        experts = torch.arange(e, device=dev)
        first = torch.searchsorted(sorted_e, experts)
        pos_in_e = torch.arange(t * k, device=dev) - first[sorted_e]
        if exchange:
            counts = (flat_e[:, None] == experts).sum(dim=0)
            every = gather_over(counts, mesh, data, "moe_counts")
            before = every[:mesh_index(mesh, data)].sum(dim=0)
            pos_in_e = pos_in_e + before[sorted_e]
        sorted_slot = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e,
                                  e * cap)
        # the spare column e * cap takes every dropped assignment; cut below
        disp = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
        disp[sorted_slot] = order // k
        wcomb = torch.zeros(e * cap + 1, dtype=top_p.dtype, device=dev)
        wcomb[sorted_slot] = top_p.reshape(t * k)[order]
        slot = torch.empty_like(sorted_slot)
        slot[order] = sorted_slot
        # a token's experts are distinct, so its slots rise with the expert
        slot = slot.view(t, k).sort(dim=-1).values
        return probs, top_e, disp[:-1], wcomb[:-1], slot, cap

    def forward(self, p, x, cfg: ModelConfig, mesh=None, data=None):
        """x [..., D] -> (y [..., D], probs [T, E], top_e [T, k]): the
        layer's output and its routing, without the aux loss (the decode
        paths discard it, as the JAX model's jit does).

        The combine gathers each token's weighted expert outputs and adds
        them in ascending expert order, the order in which the JAX CPU
        scatter-add applies them; no atomics, so a CUDA call is
        deterministic. Nothing here waits for the device.

        ``mesh``: ``route``'s groups, and expert parallelism on the rank's
        blocks (``_gathered``: each expert's d dim gathered over the data
        axes). The router, its top-k and the combine weights stay outside
        the region of the axes that split the experts (the model axis), so
        the router's gradient is whole on every rank; the tokens and the
        combine weights enter it through a *copy to region*. The tokens are
        whole on every model rank, so each picks the slots of its own
        experts locally, runs them, and adds its experts' part of each
        token's combine (in ascending order); the parts are summed over the
        model axis (no all-to-all). ``data``: as ``route``."""
        shape = x.shape
        d = shape[-1]
        xf = x.reshape(-1, d)
        w, sp = _gathered(self, p, cfg, mesh)
        probs, top_e, disp, wcomb, slot, cap = self.route(w, xf, cfg, mesh,
                                                          data)
        axes = spec_axes(sp["w_in"], 0)
        e_l = w["w_in"].shape[0]
        lo = mesh_index(mesh, axes) * e_l * cap if axes else 0
        mine = slice(lo, lo + e_l * cap)
        xr = copy_to_region(xf, mesh, axes)
        xpad = torch.cat([xr, xr.new_zeros(1, d)])
        xd = xpad[disp[mine]].view(e_l, cap, d)
        h = _bmm(xd, w["w_in"])
        g = _bmm(xd, w["w_gate"])
        h = F.silu(g) * h
        # bf16 weights: the hidden is rounded to bf16 before w_out, as in
        # SwiGLU, so the product stays on the tensor cores
        yd = _bmm(h.to(w["w_out"].dtype), w["w_out"]).to(x.dtype)
        wc = copy_to_region(wcomb, mesh, axes)[mine]
        yd = yd.view(e_l * cap, d) * wc[:, None].to(yd.dtype)
        yd = torch.cat([yd, yd.new_zeros(1, d)])   # row e_l * cap: elsewhere
        if axes:
            local = slot - lo
            slot = torch.where((local >= 0) & (local < e_l * cap), local,
                               e_l * cap)
        parts = yd[slot]                               # [T, k, D]
        out = parts[:, 0]
        for j in range(1, cfg.moe.top_k):
            out = out + parts[:, j]
        out = reduce_from_region(out, mesh, axes)
        return out.reshape(shape), probs, top_e

    def __call__(self, p, x, cfg: ModelConfig, return_stats: bool = False,
                 mesh=None, data=None):
        """x [..., D] -> (y [..., D], aux) (+ the per-expert assignment
        counts [E], pre-capacity, with ``return_stats``), as the JAX
        block. Under a ``mesh`` the aux loss and the counts are the global
        batch's: the [E] sums of the router's probabilities and of the
        top-1 choices are summed over the data axes before the means' product
        (the first with an identity backward, so each rank's gradient is its
        own tokens' part of the global one). ``data``: as ``route``."""
        out, probs, top_e = self.forward(p, x, cfg, mesh, data)
        e = cfg.moe.num_experts
        experts = torch.arange(e, device=x.device)
        data, shards = self._data(mesh, data)
        t = probs.shape[0] * shards
        # load-balance aux loss (Switch): E * sum(frac_tokens * frac_probs)
        me = reduce_from_region(probs.sum(dim=0), mesh, data,
                                "moe_aux_all_reduce") / t
        ce = sum_over((top_e[:, :1] == experts).float().sum(dim=0),
                      mesh, data, "moe_aux_all_reduce") / t
        aux = e * torch.sum(me * ce)
        if return_stats:
            counts = (top_e.reshape(-1, 1) == experts).float().sum(dim=0)
            return out, aux, sum_over(counts, mesh, data,
                                      "moe_aux_all_reduce")
        return out, aux


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
        # the pairs t < s are masked before the exp: their exp(cum_t -
        # cum_s) overflows to inf once a chunk decays by more than ~88.7,
        # and the JAX block's where() then turns the backward's 0 * inf into
        # NaN (ROADMAP queue 3); the forward's values are the same
        decay = torch.where(mask, decay.movedim(-1, 1), -torch.inf)
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
# Mamba mixer (SSD / mamba-2 style: a scalar decay per head), the JAX
# package's TPU adaptation of the mamba baseline.
# ---------------------------------------------------------------------------

class Mamba:
    HEAD_DIM = 64

    def dims(self, cfg: ModelConfig):
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        return d_in, d_in // self.HEAD_DIM, s.d_state

    def specs(self, cfg: ModelConfig) -> Dict[str, Spec]:
        d = cfg.d_model
        d_in, h, n = self.dims(cfg)
        dt = dtype_of(cfg)
        f32 = torch.float32
        return {
            "in_proj": Spec((d, 2 * d_in), ("embed", "ssm_inner"), dt,
                            fan_in=d),
            "conv_w": Spec((cfg.ssm.d_conv, d_in), ("conv", "ssm_inner"), dt,
                           "small_normal"),
            "bc_proj": Spec((d, 2 * n), ("embed", None), dt, fan_in=d),
            "dt_proj": Spec((d, h), ("embed", "heads"), dt, fan_in=d),
            "dt_bias": Spec((h,), ("heads",), f32, "zeros"),
            "a_log": Spec((h,), ("heads",), f32, "zeros"),
            "d_skip": Spec((h,), ("heads",), f32, "ones"),
            "out_proj": Spec((d_in, d), ("ssm_inner", "embed"), dt,
                             fan_in=d_in),
        }

    def init_state(self, cfg: ModelConfig, batch: int, _max_context: int):
        d_in, h, n = self.dims(cfg)
        return {
            "ssm": Spec((batch, h, n, self.HEAD_DIM),
                        ("batch", None, None, None), torch.float32, "zeros"),
            "conv": Spec((batch, cfg.ssm.d_conv - 1, d_in),
                         ("batch", None, "ssm_inner"), dtype_of(cfg),
                         "zeros"),
        }

    def _proj_gates(self, p, x):
        d_in = p["out_proj"].shape[0]
        xz = _einsum("...d,de->...e", x, p["in_proj"]).to(x.dtype)
        return xz[..., :d_in], xz[..., d_in:]

    def _bc(self, p, x):
        return _einsum("...d,dn->...n", x, p["bc_proj"]).to(x.dtype)

    def _ssm_inputs(self, p, x, bc, xc, cfg):
        """B/C (from ``bc``), the step dt and the log decay of x [..., D],
        and the values v = xh * dt of the conv output xc [..., d_in]
        (f32)."""
        n = cfg.ssm.d_state
        dt = F.softplus(_einsum("...d,dh->...h", x, p["dt_proj"])
                        + p["dt_bias"])
        log_a = dt * -torch.exp(p["a_log"])
        xh = xc.reshape(xc.shape[:-1] + (-1, self.HEAD_DIM))
        return bc[..., :n], bc[..., n:], log_a, xh, xh * dt[..., None]

    def _out(self, p, x, y, xh, z, mesh=None, axes=()):
        y = y + xh.float() * p["d_skip"][:, None]
        y = y.reshape(z.shape).to(x.dtype) * F.silu(z)
        return reduce_from_region(_einsum("...e,ed->...d", y, p["out_proj"]),
                                  mesh, axes).to(x.dtype)

    # each leaf's dimension that the heads split through their channels
    # ("ssm_inner"), and directly ("heads")
    CHANNEL_DIMS = {"conv_w": 1, "out_proj": 0}
    HEAD_DIMS = {"dt_proj": 1, "dt_bias": 0, "a_log": 0, "d_skip": 0}

    def _axes(self, sp) -> Tuple[str, ...]:
        """The axes that split the heads, through their channels; the
        per-head leaves split over them too or, where the rules keep
        "heads" whole (``head-tp``), stay whole."""
        axes = _heads_axes(sp, self.CHANNEL_DIMS)
        heads = _heads_axes(sp, self.HEAD_DIMS)
        if heads and heads != axes:
            raise ValueError(f"Mamba's heads split over {heads}, its "
                             f"channels over {axes}")
        return axes

    def _mesh_weights(self, p, cfg, mesh):
        """(weights, axes) of ``fwd_seq`` on ``mesh``: every leaf
        FSDP-gathered (``_gathered``), the heads (and their d_in channels)
        split over ``axes``. ``in_proj`` [d, 2 d_in] is stored as the
        reference's ``param_shardings`` splits it, in contiguous blocks
        of its 2 d_in columns, which do not hold a rank's heads (the x half
        and the z half split at d_in): it is gathered whole over its
        tensor-parallel axes (``tp_gather``) and the rank takes its heads'
        columns of both halves. Per-head leaves kept whole while the
        channels split (``_axes``) enter the region through a *copy to
        region* and the rank takes its heads of them. With no mesh: ``p``,
        ()."""
        w, sp = _gathered(self, p, cfg, mesh)
        axes = self._axes(sp)
        if mesh is None:
            return w, axes
        if axes and not _heads_axes(sp, self.HEAD_DIMS):
            h = w["out_proj"].shape[0] // self.HEAD_DIM
            h0 = mesh_index(mesh, axes) * h
            w = dict(w, **{n: copy_to_region(w[n], mesh, axes).narrow(
                dim, h0, h) for n, dim in self.HEAD_DIMS.items()})
        full = tp_gather(w["in_proj"], sp["in_proj"], mesh, 1)
        if axes:
            d_in = full.shape[1] // 2
            d_l = w["out_proj"].shape[0]
            lo = mesh_index(mesh, axes) * d_l
            full = torch.cat([full[:, lo:lo + d_l],
                              full[:, d_in + lo:d_in + lo + d_l]], dim=1)
        return dict(w, in_proj=full), axes

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        """The causal depthwise conv, then the SSD recurrence over the
        prompt: on CUDA the hand-written ``ssd_scan`` kernel, on the CPU its
        plain version (the JAX model calls the same plain ``ssd_chunked``
        at blocks.py:490). Returns (out, {"ssm", "conv"}): the final state
        and the conv's last d_conv - 1 inputs.

        ``ctx["mesh"]``: heads-parallel on the rank's blocks
        (``_mesh_weights``): in_proj's columns, conv_w, dt_proj and the
        per-head vectors of the rank's heads; out_proj row-parallel, its
        partial sums reduced over the heads' axes; the scan on the rank's
        heads. ``bc_proj`` feeds every head and stays whole: B and C are
        computed before the region and enter it through a *copy to
        region*, so its gradient is whole on every rank."""
        b, t, _ = x.shape
        d_conv = cfg.ssm.d_conv
        mesh = (ctx or {}).get("mesh")
        w, axes = self._mesh_weights(p, cfg, mesh)
        n = cfg.ssm.d_state
        bc = copy_to_region(self._bc(w, x), mesh, axes)
        x_in = copy_to_region(x, mesh, axes)
        xi, z = self._proj_gates(w, x_in)
        conv_tail = xi[:, -(d_conv - 1):, :]
        xpad = F.pad(xi, (0, 0, d_conv - 1, 0))
        xc = sum(xpad[:, i:i + t, :] * w["conv_w"][i][None, None, :]
                 for i in range(d_conv))
        xc = F.silu(xc)
        b_mat, c_mat, log_a, xh, v = self._ssm_inputs(w, x_in, bc, xc, cfg)
        h = xh.shape[-2]
        # the kernel takes dense [B, T, H, n] q/k; JAX broadcasts them
        q = c_mat[:, :, None, :].expand(b, t, h, n).contiguous()
        k = b_mat[:, :, None, :].expand(b, t, h, n).contiguous()
        y, final = ssd_scan(q, k, v.contiguous(), log_a.contiguous(),
                            chunk=cfg.ssm.chunk_size)
        return (self._out(w, x, y, xh, z, mesh, axes),
                {"ssm": final, "conv": conv_tail})

    def fwd_dec(self, p, x, state, shared, cfg: ModelConfig):
        """One token. Under a mesh (``mesh_context``), on the rank's rows
        and blocks, heads-parallel as ``fwd_seq`` (``_mesh_weights``): the
        state's ``conv`` holds the rank's d_in channels and ``ssm`` every
        head (``init_state``'s layout); the rank updates its heads', which
        are gathered back over the heads' axes."""
        bsz = x.shape[0]
        n = cfg.ssm.d_state
        mesh = get_mesh()
        w, axes = self._mesh_weights(p, cfg, mesh)
        h = w["dt_proj"].shape[1]
        h0 = mesh_index(mesh, axes) * h
        xi, z = self._proj_gates(w, x)                 # [B, d_in(rank)]
        window = torch.cat([state["conv"], xi[:, None, :]], dim=1)
        xc = F.silu(_einsum("bcd,cd->bd", window, w["conv_w"]).to(x.dtype))
        b_mat, c_mat, log_a, xh, v = self._ssm_inputs(w, x, self._bc(w, x),
                                                      xc, cfg)
        q = c_mat[:, None, :].expand(bsz, h, n)
        k = b_mat[:, None, :].expand(bsz, h, n)
        y, new_ssm = ssd_decode_step(q, k, v, log_a,
                                     state["ssm"][:, h0:h0 + h])
        return (self._out(w, x, y, xh, z, mesh, axes),
                {"ssm": _all_heads(new_ssm, mesh, axes),
                 "conv": window[:, 1:]})

    def seq_cache_to_state(self, cfg: ModelConfig, cache, max_context: int,
                           mesh=None, batch: int = 0):
        """``fwd_seq``'s final state is the decode state; under a mesh
        (the rank's heads) ``ssm`` is gathered over the heads' axes to
        every head, ``conv`` keeps the rank's channels."""
        axes = self._axes(_specs(self, cfg, mesh)) if mesh is not None \
            else ()
        ssm = cache["ssm"]
        if axes:
            ssm = all_gather_dim(ssm, mesh_group(mesh, axes), ssm.dim() - 3,
                                 "cache_heads_all_gather").contiguous()
        return {"ssm": ssm, "conv": cache["conv"]}


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

    HEAD_DIMS = {"wq": 1, "wk": 1, "wv": 1, "w_if": 2, "b_if": 1, "wo": 0}
    # each leaf's head_dim (the ``head-tp`` profile splits it over "model")
    HD_DIMS = {"wq": 2, "wk": 2, "wv": 2, "wo": 1}

    def _axes(self, sp) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        return _heads_or_head_dim(sp, self.HEAD_DIMS, self.HD_DIMS)

    @staticmethod
    def _own_c(c: torch.Tensor, mesh, hd) -> torch.Tensor:
        """The rank's columns of the whole state c [..., hd, hd + 1] under a
        head_dim split over ``hd``: its block of the value columns and the
        normalizer column."""
        if not hd:
            return c
        n = math.prod(axis_sizes(mesh)[ax] for ax in hd)
        v = (c.shape[-1] - 1) // n
        v0 = mesh_index(mesh, hd) * v
        return torch.cat([c[..., v0:v0 + v], c[..., -1:]], dim=-1)

    @staticmethod
    def _whole_c(c: torch.Tensor, mesh, hd) -> torch.Tensor:
        """The whole state [..., hd, hd + 1] from each rank's columns [...,
        hd, hd_local + 1] (``_own_c``): the value blocks in rank order, then
        the normalizer column, which every rank computes alike (rank 0's
        is kept)."""
        if not hd:
            return c
        v = c.shape[-1]
        g = all_gather_dim(c, mesh_group(mesh, hd), c.dim() - 1,
                           "state_head_dim_all_gather")
        g = g.reshape(g.shape[:-1] + (-1, v))
        return torch.cat([g[..., :v - 1].flatten(-2), g[..., 0, v - 1:]],
                         dim=-1).contiguous()

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        """On CUDA the recurrence is the hand-written ``ssd_scan`` kernel;
        on the CPU its plain version (the JAX model calls the same plain
        ``ssd_chunked`` at blocks.py:573).

        ``ctx["mesh"]``: heads-parallel on the rank's blocks
        (``_gathered``): q/k/v and the gates column-parallel over the
        heads' axes, the scan on the rank's heads, ``wo`` row-parallel
        with its partial sums reduced over them (no norm crosses heads).
        Where head_dim splits instead (``head-tp``): q and k, which the
        scan contracts over head_dim, are gathered whole (their backward
        reduce-scatters); the gates (``w_if``, ``b_if`` whole) are computed
        before the region and enter it through a *copy to region*; the scan
        runs on every head with the rank's value columns plus its own
        normalizer column (dv = hd_local + 1), so its final state is the
        rank's columns (``_own_c``); ``wo`` is row-parallel over head_dim."""
        mesh = (ctx or {}).get("mesh")
        w, sp = _gathered(self, p, cfg, mesh)
        axes, hd = self._axes(sp)
        region = axes or hd
        x_in = copy_to_region(x, mesh, region)
        q, k, v = self._qkv(w, x_in, cfg)
        i_gate, log_f = self._gates(w, x_in if axes else x)   # [b,t,h]
        if hd:
            i_gate, log_f = (copy_to_region(g, mesh, hd)
                             for g in (i_gate, log_f))
            q, k = (gather_region(t, mesh, hd, 3, "head_dim") for t in (q, k))
        v_aug = self._v_aug(v, i_gate)
        y, final = ssd_scan(q.contiguous(), k.contiguous(),
                            v_aug.contiguous(), log_f.contiguous(),
                            chunk=cfg.ssm.chunk_size)
        hh = self._read(y).to(x.dtype)
        out = reduce_from_region(_einsum("bthk,hkd->btd", hh, w["wo"]),
                                 mesh, region)
        return out.to(x.dtype), {"c": final}

    def fwd_dec(self, p, x, state, shared, cfg: ModelConfig):
        """One token. Under a mesh, on the rank's rows and blocks,
        heads-parallel as ``fwd_seq``: the state's ``c`` holds every head
        (``init_state``'s layout); the rank updates its heads', which are
        gathered back over the heads' axes. Under a head_dim split the
        state is whole too: the rank updates its columns (``_own_c``, q and
        k gathered whole), which are gathered back (``_whole_c``)."""
        mesh = get_mesh()
        w, sp = _gathered(self, p, cfg, mesh)
        axes, hd = self._axes(sp)
        q, k, v = self._qkv(w, x, cfg)
        h0 = mesh_index(mesh, axes) * q.shape[1]
        i_gate, log_f = self._gates(w, x)              # [b,h]
        if hd:
            q, k = (gather_region(t, mesh, hd, 2, "head_dim") for t in (q, k))
        c = self._own_c(state["c"][:, h0:h0 + q.shape[1]], mesh, hd)
        y, new_c = ssd_decode_step(q, k, self._v_aug(v, i_gate), log_f, c)
        hh = self._read(y).to(x.dtype)
        out = reduce_from_region(_einsum("bhk,hkd->bd", hh, w["wo"]), mesh,
                                 axes or hd, "decode_tp_all_reduce")
        return out.to(x.dtype), {"c": _all_heads(
            self._whole_c(new_c, mesh, hd), mesh, axes)}

    def seq_cache_to_state(self, cfg: ModelConfig, cache, max_context: int,
                           mesh=None, batch: int = 0):
        """``fwd_seq``'s final state is the decode state; under a mesh
        (the rank's heads) ``c`` is gathered over the heads' axes, or
        (the rank's columns) over head_dim's (``_whole_c``)."""
        axes, hd = self._axes(_specs(self, cfg, mesh)) if mesh is not None \
            else ((), ())
        c = self._whole_c(cache["c"], mesh, hd)
        if axes:
            c = all_gather_dim(c, mesh_group(mesh, axes), c.dim() - 3,
                               "cache_heads_all_gather").contiguous()
        return {"c": c}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, per-head block-diagonal recurrence). Strictly
# sequential: a plain loop over time in f32 (no Pallas kernel on the TPU
# either; the JAX model scans it, checkpointed per chunk of steps).
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
    def _cell(p, wx, state, rec_sum=None):
        """wx [B,4,H,hd] pre-activations; state {c,n,h}. ``rec_sum``: the
        sum of the recurrent product's partial sums over a head_dim split
        (``r`` splits its input head_dim: each rank's h block gives a
        partial sum of every output, of which it keeps its block)."""
        rec = _einsum("bhk,hgkl->bghl", state["h"], p["r"])
        if rec_sum is not None:
            rec = rec_sum(rec)
        za = wx + rec + p["b"][None]
        z = torch.tanh(za[:, 0])
        i = torch.sigmoid(za[:, 1])
        f = torch.sigmoid(za[:, 2])
        o = torch.sigmoid(za[:, 3])
        c = f * state["c"] + i * z
        n = f * state["n"] + i
        h = o * c / torch.clamp(n.abs(), min=1.0)
        return {"c": c, "n": n, "h": h}

    TIME_CHUNK = 64

    HEAD_DIMS = {"w": 2, "r": 0, "b": 1, "wo": 0}
    # each leaf's head_dim (``r``'s input one; ``head-tp`` splits them)
    HD_DIMS = {"w": 3, "r": 2, "b": 2, "wo": 1}

    def _axes(self, sp, mesh):
        """(the axes that split the heads, those that split head_dim, the
        cell's ``rec_sum`` under the latter: the reduce-scatter of the
        recurrent product's partial sums over them, each step)."""
        axes, hd = _heads_or_head_dim(sp, self.HEAD_DIMS, self.HD_DIMS)
        if not hd:
            return axes, hd, None
        return axes, hd, lambda rec: scatter_region(rec, mesh, hd, 3,
                                                    "slstm_rec")

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        """The time loop; under autograd each chunk of ``TIME_CHUNK`` steps
        (the largest divisor of T not above it) is checkpointed, as the JAX
        block's ``jax.checkpoint`` chunk body is: the backward keeps only
        the (c, n, h) state between chunks and recomputes a chunk's steps.

        ``ctx["mesh"]``: heads-parallel on the rank's blocks (``_gathered``;
        the recurrence is block-diagonal over the heads): w, r and b of the
        rank's heads, ``wo`` row-parallel with its partial sums reduced
        over the heads' axes. Where head_dim splits instead (``head-tp``):
        the rank runs the cell on its head_dim block of every head (w's and
        b's columns, r's input rows), the recurrent product's partial sums
        reduce-scattered over those axes each step (``_axes``); its final
        state is the rank's block, ``wo`` row-parallel over head_dim.

        ``ctx["slstm_graphs"]`` (an ``SLSTMGraphs``, ``Model.prefill``'s):
        where ``kernels.graphs.replayable`` holds (CUDA, no mesh, autograd
        off, no capture running) each chunk replays one captured graph of
        its ``ck`` steps (``models.slstm_graph``) instead of the loop."""
        b, t, _ = x.shape
        mesh = (ctx or {}).get("mesh")
        p, sp = _gathered(self, p, cfg, mesh)
        axes, hd, rec_sum = self._axes(sp, mesh)
        region = axes or hd
        wx = _einsum("btd,dghk->btghk", copy_to_region(x, mesh, region),
                     p["w"])                           # [b,t,4,h,hd]
        zeros = torch.zeros((b,) + p["w"].shape[2:],
                            dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros)

        def steps(wxc, c, n, h):
            st = {"c": c, "n": n, "h": h}
            hs = []
            for i in range(wxc.shape[1]):
                st = self._cell(p, wxc[:, i], st, rec_sum)
                hs.append(st["h"])
            return st["c"], st["n"], st["h"], torch.stack(hs, dim=1)

        ck = self.TIME_CHUNK
        while t % ck:
            ck -= 1
        graphs = (ctx or {}).get("slstm_graphs")
        if graphs is not None and replayable(wx, mesh):
            state, hs = graphs.run(self._cell, p, wx, ck)
        else:
            run = remat(steps, "full")
            hs = []
            for c0 in range(0, t, ck):
                *state, h_c = run(wx[:, c0:c0 + ck], *state)
                hs.append(h_c)
            hs = torch.cat(hs, dim=1)
        hs = hs.to(x.dtype)                            # [b,t,h,hd]
        out = reduce_from_region(_einsum("bthk,hkd->btd", hs, p["wo"]),
                                 mesh, region)
        return out.to(x.dtype), dict(zip(("c", "n", "h"), state))

    def fwd_dec(self, p, x, state, shared, cfg: ModelConfig):
        """One token. Under a mesh, on the rank's rows and blocks,
        heads-parallel as ``fwd_seq``: the state holds the rank's heads
        (``init_state``'s layout splits them as the weights'); ``wo``
        row-parallel. Under a head_dim split the state is whole (the rules
        keep "heads" whole): the rank steps its block of it, which is
        gathered back over head_dim's axes."""
        mesh = get_mesh()
        p, sp = _gathered(self, p, cfg, mesh)
        axes, hd, rec_sum = self._axes(sp, mesh)
        if hd:
            n = p["w"].shape[3]
            blk = slice(mesh_index(mesh, hd) * n, (mesh_index(mesh, hd) + 1)
                        * n)
            state = {k: v[..., blk] for k, v in state.items()}
        wx = _einsum("bd,dghk->bghk", x, p["w"])
        s2 = self._cell(p, wx, state, rec_sum)
        out = reduce_from_region(_einsum("bhk,hkd->bd", s2["h"].to(x.dtype),
                                         p["wo"]), mesh, axes or hd,
                                 "decode_tp_all_reduce")
        return out.to(x.dtype), self._whole(s2, mesh, hd)

    @staticmethod
    def _whole(state, mesh, hd):
        """The state {c, n, h} [..., B, H, hd] whole from each rank's
        head_dim block over ``hd`` (``state`` itself where there is
        none)."""
        if not hd:
            return state
        return {k: all_gather_dim(v, mesh_group(mesh, hd), v.dim() - 1,
                                  "state_head_dim_all_gather").contiguous()
                for k, v in state.items()}

    def seq_cache_to_state(self, cfg: ModelConfig, cache, max_context: int,
                           mesh=None, batch: int = 0):
        """``fwd_seq``'s final state is the decode state, the rank's heads
        under a mesh as the state's layout holds them; under a head_dim
        split the rank's blocks are gathered whole (``_whole``)."""
        if mesh is None:
            return cache
        return self._whole(cache, mesh,
                           self._axes(_specs(self, cfg, mesh), mesh)[1])
