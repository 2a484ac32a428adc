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
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.distributed.collectives import (
    copy_to_region, fsdp_gather, gather_over, reduce_from_region, sum_over,
    tp_gather,
)
from repro_torch.distributed.sharding import (
    axis_sizes, batch_axis_names, get_mesh, get_rules, mesh_group,
    mesh_index, num_data_shards, spec_axes, spec_for,
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
        whole gradient. With no mesh every collective is the identity."""
        mesh = ctx.get("mesh")
        w, sp = _gathered(self, p, cfg, mesh)
        axes = spec_axes(sp["wq"], 1)
        kv_axes = spec_axes(sp["wk"], 1)
        if (kv_axes and kv_axes != axes) or spec_axes(sp["wo"], 0) != axes:
            raise ValueError(f"the heads of wq, wk/wv and wo split over "
                             f"{axes}, {kv_axes}, {spec_axes(sp['wo'], 0)}")
        if axes and not kv_axes:
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
        hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        s = self.cache_len(cfg, max_context)
        dt = dtype_of(cfg)
        return {
            "k": Spec((batch, s, hkv, hd), ("batch", "kv_seq", None, None),
                      dt, "zeros"),
            "v": Spec((batch, s, hkv, hd), ("batch", "kv_seq", None, None),
                      dt, "zeros"),
        }

    def seq_cache_to_state(self, cfg: ModelConfig, cache, max_context: int):
        """Prefill K/V [..., S, Hkv, hd] (any leading dims: the LM passes
        them stacked [R, B, ...]) into a decode cache [..., cache_len, Hkv,
        hd]. A ring (sliding-window) cache whose prompt fills it keeps the
        last ``window`` tokens, token t at slot t % window."""
        k, v = cache["k"], cache["v"]
        if self.cross:                  # the encoder's K/V, as they are
            return {"k": k, "v": v}
        s = k.shape[-3]
        s_c = self.cache_len(cfg, max_context)
        if cfg.sliding_window and s >= s_c:
            last = s - s_c
            ar = torch.arange(s_c, device=k.device)
            take = (last + ar)[torch.argsort((last + ar) % s_c)]
            return {"k": k.index_select(-3, take),
                    "v": v.index_select(-3, take)}

        def pad(a):
            out = a.new_zeros(a.shape[:-3] + (s_c,) + a.shape[-2:])
            out[..., :s, :, :] = a
            return out
        return {"k": pad(k), "v": pad(v)}

    def fwd_dec(self, p, x, state, shared, cfg: ModelConfig):
        """Decode one token. x [B, D]; state {k, v} [B, Sc, Hkv, hd];
        shared: pos [B], slot [B], kv_pos [B, Sc], kv_valid [B, Sc]. The new
        token's K/V row is written IN PLACE at ``slot`` (the JAX block
        returns an updated copy), so the state it returns is empty: nothing
        is left for the caller to write back.

        Under a mesh whose model axis is > 1 (``mesh_context``), shared
        also holds ``cache_len``, the whole cache's length, and the state
        and kv_pos/kv_valid hold this rank's slice of that cache
        (``decode_cache_slices``): the flash-decode over the ranks where
        the mesh splits the sequence, local decode where it does not.

        Cross-attention: Q only, against the cross cache ``state`` {k, v}
        [B, Ssrc, Hkv, hd] under ``shared["cross_pos"]``/``["cross_valid"]``
        [B, Ssrc], unmasked otherwise; it writes nothing."""
        pos = shared["pos"]
        if self.cross:
            q = _einsum("bd,dhk->bhk", x, p["wq"]).to(x.dtype)
            out = decode_attention(q, state["k"], state["v"], pos,
                                   shared["cross_pos"], shared["cross_valid"],
                                   causal=False)
            return _einsum("bhk,hkd->bd", out, p["wo"]).to(x.dtype), {}
        q, k_new, v_new = self._qkv(p, x, cfg)
        q = rope(q, pos, cfg.rope_theta)
        k_new = rope(k_new, pos, cfg.rope_theta)
        mesh = get_mesh()
        kv_axes = batch_axes = ()
        if mesh is not None and axis_sizes(mesh).get("model", 1) > 1:
            kv_axes, batch_axes = _mesh_decode_layout(mesh, state, shared)
        if kv_axes:
            out = self._dec_sharded(mesh, kv_axes, batch_axes, q, k_new,
                                    v_new, state, shared, cfg)
        else:
            rows = torch.arange(x.shape[0], device=x.device)
            slot = shared["slot"].long()
            state["k"][rows, slot] = k_new
            state["v"][rows, slot] = v_new
            out = decode_attention(q, state["k"], state["v"], pos,
                                   shared["kv_pos"], shared["kv_valid"],
                                   window=cfg.sliding_window)
        y = _einsum("bhk,hkd->bd", out, p["wo"]).to(x.dtype)
        return y, {}

    @staticmethod
    def _dec_sharded(mesh, kv_axes, batch_axes, q, k_new, v_new, state,
                     shared, cfg):
        """``fwd_dec``'s attention under a ``DeviceMesh`` that splits the
        cache sequence over ``kv_axes`` (``decode_layout``): the
        flash-decode. q, the new K/V rows, ``pos`` and ``slot`` hold the
        whole batch on every rank; the state's k/v and
        ``kv_pos``/``kv_valid`` hold this rank's rows (its block along
        ``batch_axes``) and its contiguous slice of the sequence. Only the
        rank whose slice holds ``slot`` changes that row. Returns the whole
        batch's [B, Hq, hd]."""
        b = q.shape[0]
        rows = _block(mesh, batch_axes, b)
        s_l = state["k"].shape[1]
        slot = shared["slot"][rows].long() - mesh_index(mesh, kv_axes) * s_l
        mine = ((slot >= 0) & (slot < s_l))[:, None, None]
        idx = (torch.arange(slot.shape[0], device=q.device),
               slot.clamp(0, s_l - 1))
        # rows whose slot lies elsewhere write back what they hold: no
        # host sync on a boolean index
        for name, new in (("k", k_new), ("v", v_new)):
            cache = state[name]
            cache[idx] = torch.where(mine, new[rows], cache[idx])
        out = distributed_decode_attention(
            mesh, kv_axes, q[rows], state["k"], state["v"],
            shared["pos"][rows], shared["kv_pos"], shared["kv_valid"],
            window=cfg.sliding_window)
        if batch_axes:
            parts = [torch.empty_like(out) for _ in range(math.prod(
                axis_sizes(mesh)[ax] for ax in batch_axes))]
            torch.distributed.all_gather(parts, out.contiguous(),
                                         group=mesh_group(mesh, batch_axes))
            out = torch.cat(parts)
        return out


def _gathered(block, p, cfg: ModelConfig, mesh):
    """(weights, specs) of a block's leaves ``p`` on ``mesh``: each spec as
    the rules and the divisibility fallback resolve it, each weight
    FSDP-gathered over its data axes where it is used (its tensor-parallel
    splits stay). With no mesh: ``p``, nothing split."""
    if mesh is None:
        return p, dict.fromkeys(p, ())
    rules = get_rules()
    sp = {n: spec_for(s.logical, s.shape, mesh, rules)
          for n, s in block.specs(cfg).items()}
    return {n: fsdp_gather(p[n], sp[n], mesh) for n in sp}, sp


def _heads_axes(sp, dims: Dict[str, int]) -> Tuple[str, ...]:
    """The axes that split the heads of a heads-parallel block: dimension
    ``dims[name]`` of each leaf's spec must split over the same axes (or
    every one stay whole), since no head's work crosses ranks."""
    split = {n: spec_axes(sp[n], dim) for n, dim in dims.items()}
    axes = set(split.values())
    if len(axes) > 1:
        raise ValueError(f"the heads of a block split unevenly: {split}")
    return axes.pop()


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


def _kv_shard_axes(mesh, kv_shape) -> Tuple[str, ...]:
    """Which mesh axes shard the KV-cache sequence dim (flash-decode)."""
    sizes = axis_sizes(mesh) if mesh is not None else {}
    if sizes.get("model", 1) == 1:
        return ()
    logical = ("batch", "kv_seq_full" if kv_shape[0] == 1 else "kv_seq",
               None, None)
    spec = spec_for(logical, kv_shape, mesh, get_rules())
    seq_part = spec[1] if len(spec) > 1 else None
    if seq_part is None:
        return ()
    return seq_part if isinstance(seq_part, tuple) else (seq_part,)


def _batch_shard_axes(mesh, batch: int, kv_axes) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    axes = []
    n = 1
    for ax in ("pod", "data"):
        if ax in sizes and ax not in kv_axes:
            size = sizes[ax]
            if size > 1 and batch % (n * size) == 0:
                axes.append(ax)
                n *= size
    return tuple(axes)


def decode_layout(mesh, batch: int, cache_len: int
                  ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(kv_axes, batch_axes) of a decode cache [batch, cache_len, ...]
    under the mesh: the reference's ``_kv_shard_axes`` and, where those
    split the sequence, its ``_batch_shard_axes``. ((), ()) where no axis
    splits the sequence: the cache stays whole on every rank and decode
    runs locally, as in the reference."""
    kv_axes = _kv_shard_axes(mesh, (batch, cache_len, 1, 1))
    if not kv_axes:
        return (), ()
    return kv_axes, _batch_shard_axes(mesh, batch, kv_axes)


def _mesh_decode_layout(mesh, state, shared):
    """``fwd_dec``'s ``decode_layout`` under a mesh whose model axis is
    > 1, at the whole cache's length ``shared["cache_len"]``; the state
    must hold this rank's slice of that cache (``decode_cache_slices``)."""
    if "cache_len" not in shared:
        raise ValueError("under a mesh whose model axis is > 1, fwd_dec "
                         "needs shared['cache_len'], the whole cache's "
                         "length")
    b, s_c = shared["pos"].shape[0], int(shared["cache_len"])
    rows, seq = decode_cache_slices(mesh, b, s_c)
    want = (rows.stop - rows.start, seq.stop - seq.start)
    if tuple(state["k"].shape[:2]) != want:
        raise ValueError(
            f"this rank's slice of a [{b}, {s_c}] cache is {want} (rows, "
            f"sequence); the state holds {tuple(state['k'].shape[:2])}")
    return decode_layout(mesh, b, s_c)


def _block(mesh, axes, n: int) -> slice:
    """This rank's contiguous block of a dimension of ``n`` split over
    ``axes``."""
    parts = math.prod(axis_sizes(mesh)[ax] for ax in axes)
    if n % parts:
        raise ValueError(f"a dimension of {n} does not split over {axes} "
                         f"({parts} blocks)")
    i = mesh_index(mesh, axes)
    return slice(i * n // parts, (i + 1) * n // parts)


def decode_cache_slices(mesh, batch: int, cache_len: int
                        ) -> Tuple[slice, slice]:
    """This rank's rows and sequence span of a decode cache [batch,
    cache_len, ...] under the mesh: the slice ``Attention.fwd_dec`` reads
    from the state and ``kv_pos``/``kv_valid``."""
    kv_axes, batch_axes = decode_layout(mesh, batch, cache_len)
    return _block(mesh, batch_axes, batch), _block(mesh, kv_axes, cache_len)


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
    def _data(mesh) -> Tuple[Tuple[str, ...], int]:
        """(data axes, data shards): under a mesh the MoE's rows are this
        data rank's block of the global batch's tokens, in their order."""
        if mesh is None:
            return (), 1
        return batch_axis_names(mesh), num_data_shards(mesh)

    def route(self, p, xf: torch.Tensor, cfg: ModelConfig, mesh=None):
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
        rank's token fills)."""
        m = cfg.moe
        t = xf.shape[0]
        e, k = m.num_experts, m.top_k
        data, shards = self._data(mesh)
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

    def forward(self, p, x, cfg: ModelConfig, mesh=None):
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
        model axis (no all-to-all)."""
        shape = x.shape
        d = shape[-1]
        xf = x.reshape(-1, d)
        e = cfg.moe.num_experts
        w, sp = _gathered(self, p, cfg, mesh)
        probs, top_e, disp, wcomb, slot, cap = self.route(w, xf, cfg, mesh)
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
                 mesh=None):
        """x [..., D] -> (y [..., D], aux) (+ the per-expert assignment
        counts [E], pre-capacity, with ``return_stats``), as the JAX
        block. Under a ``mesh`` the aux loss and the counts are the global
        batch's: the [E] sums of the router's probabilities and of the
        top-1 choices are summed over the data axes before the means' product
        (the first with an identity backward, so each rank's gradient is its
        own tokens' part of the global one)."""
        out, probs, top_e = self.forward(p, x, cfg, mesh)
        e = cfg.moe.num_experts
        experts = torch.arange(e, device=x.device)
        data, shards = self._data(mesh)
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

    # each leaf's dimension that the heads split, directly ("heads") or
    # through their channels ("ssm_inner")
    HEAD_DIMS = {"conv_w": 1, "dt_proj": 1, "dt_bias": 0, "a_log": 0,
                 "d_skip": 0, "out_proj": 0}

    def _mesh_weights(self, p, cfg, mesh):
        """(weights, axes) of ``fwd_seq`` on ``mesh``: every leaf
        FSDP-gathered (``_gathered``), the heads (and their d_in channels)
        split over ``axes``. ``in_proj`` [d, 2 d_in] is stored as the
        reference's ``param_shardings`` splits it, in contiguous blocks
        of its 2 d_in columns, which do not hold a rank's heads (the x half
        and the z half split at d_in): it is gathered whole over its
        tensor-parallel axes (``tp_gather``) and the rank takes its heads'
        columns of both halves. With no mesh: ``p``, ()."""
        w, sp = _gathered(self, p, cfg, mesh)
        axes = _heads_axes(sp, self.HEAD_DIMS)
        if mesh is None:
            return w, axes
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
        bsz = x.shape[0]
        _, h, n = self.dims(cfg)
        xi, z = self._proj_gates(p, x)                 # [B, d_in]
        window = torch.cat([state["conv"], xi[:, None, :]], dim=1)
        xc = F.silu(_einsum("bcd,cd->bd", window, p["conv_w"]).to(x.dtype))
        b_mat, c_mat, log_a, xh, v = self._ssm_inputs(p, x, self._bc(p, x),
                                                      xc, cfg)
        q = c_mat[:, None, :].expand(bsz, h, n)
        k = b_mat[:, None, :].expand(bsz, h, n)
        y, new_ssm = ssd_decode_step(q, k, v, log_a, state["ssm"])
        return self._out(p, x, y, xh, z), {"ssm": new_ssm,
                                           "conv": window[:, 1:]}


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

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        """On CUDA the recurrence is the hand-written ``ssd_scan`` kernel;
        on the CPU its plain version (the JAX model calls the same plain
        ``ssd_chunked`` at blocks.py:573).

        ``ctx["mesh"]``: heads-parallel on the rank's blocks
        (``_gathered``): q/k/v and the gates column-parallel over the
        heads' axes, the scan on the rank's heads, ``wo`` row-parallel
        with its partial sums reduced over them (no norm crosses heads)."""
        mesh = (ctx or {}).get("mesh")
        w, sp = _gathered(self, p, cfg, mesh)
        axes = _heads_axes(sp, self.HEAD_DIMS)
        x_in = copy_to_region(x, mesh, axes)
        q, k, v = self._qkv(w, x_in, cfg)
        i_gate, log_f = self._gates(w, x_in)           # [b,t,h]
        v_aug = self._v_aug(v, i_gate)
        y, final = ssd_scan(q.contiguous(), k.contiguous(),
                            v_aug.contiguous(), log_f.contiguous(),
                            chunk=cfg.ssm.chunk_size)
        hh = self._read(y).to(x.dtype)
        out = reduce_from_region(_einsum("bthk,hkd->btd", hh, w["wo"]),
                                 mesh, axes)
        return out.to(x.dtype), {"c": final}

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

    TIME_CHUNK = 64

    HEAD_DIMS = {"w": 2, "r": 0, "b": 1, "wo": 0}

    def fwd_seq(self, p, x, ctx, cfg: ModelConfig):
        """The time loop; under autograd each chunk of ``TIME_CHUNK`` steps
        (the largest divisor of T not above it) is checkpointed, as the JAX
        block's ``jax.checkpoint`` chunk body is: the backward keeps only
        the (c, n, h) state between chunks and recomputes a chunk's steps.

        ``ctx["mesh"]``: heads-parallel on the rank's blocks (``_gathered``;
        the recurrence is block-diagonal over the heads): w, r and b of the
        rank's heads, ``wo`` row-parallel with its partial sums reduced
        over the heads' axes."""
        b, t, _ = x.shape
        mesh = (ctx or {}).get("mesh")
        p, sp = _gathered(self, p, cfg, mesh)
        axes = _heads_axes(sp, self.HEAD_DIMS)
        wx = _einsum("btd,dghk->btghk", copy_to_region(x, mesh, axes),
                     p["w"])                           # [b,t,4,h,hd]
        zeros = torch.zeros((b,) + p["w"].shape[2:],
                            dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros)

        def steps(wxc, c, n, h):
            st = {"c": c, "n": n, "h": h}
            hs = []
            for i in range(wxc.shape[1]):
                st = self._cell(p, wxc[:, i], st)
                hs.append(st["h"])
            return st["c"], st["n"], st["h"], torch.stack(hs, dim=1)

        ck = self.TIME_CHUNK
        while t % ck:
            ck -= 1
        run = remat(steps, "full")
        hs = []
        for c0 in range(0, t, ck):
            *state, h_c = run(wx[:, c0:c0 + ck], *state)
            hs.append(h_c)
        hs = torch.cat(hs, dim=1).to(x.dtype)          # [b,t,h,hd]
        out = reduce_from_region(_einsum("bthk,hkd->btd", hs, p["wo"]),
                                 mesh, axes)
        return out.to(x.dtype), dict(zip(("c", "n", "h"), state))

    def fwd_dec(self, p, x, state, shared, cfg: ModelConfig):
        wx = _einsum("bd,dghk->bghk", x, p["w"])
        s2 = self._cell(p, wx, state)
        out = _einsum("bhk,hkd->bd", s2["h"].to(x.dtype), p["wo"]).to(x.dtype)
        return out, s2
