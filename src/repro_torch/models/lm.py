"""Decoder-only LM over attention stacks with a dense FFN, against the paged
KV pool (PyTorch counterpart of ``repro.models.lm``).

Parameters keep the JAX layout: stacked over the R repeats of the block
pattern ([R, ...] leaves), so one repeat is MIRAGE's remap unit and a
``fetch(r)`` function supplies repeat r's parameters (resident on device,
or streamed from pinned host memory by ``core.transfer_engine``).

The paged state's pools are updated IN PLACE (the JAX functions return new
arrays): a full-width pool is gigabytes, and the engine never needs the old
one. Functions still return the state dict, as in the JAX package.

Patterns other than attention + dense FFN (MoE, mamba, xLSTM), the dense and
ring-buffer decode caches, and prefix embeddings (VLM) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_prefill_attention,
)
from repro_torch.models.blocks import Attention, SwiGLU, _einsum, rms_norm, rope
from repro_torch.models.common import Spec, dtype_of, stack_specs, tree_init

_ROADMAP_MODELS = ("ported in a later slice: ROADMAP queue 1, 'MoE tenants' "
                   "and 'Recurrent, hybrid and encoder-decoder models'")


@dataclasses.dataclass(frozen=True)
class LayerDef:
    mixer: str   # attn | mamba | mlstm | slstm
    ffn: str     # dense | moe | none


_ATTN = Attention()
_SWIGLU = SwiGLU()


def layer_defs(cfg: ModelConfig) -> List[LayerDef]:
    defs = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind.startswith("attn"):
            mixer = "attn"
        elif cfg.ssm is not None and cfg.ssm.kind == "mamba":
            mixer = "mamba"
        elif cfg.ssm is not None and cfg.ssm.slstm_period and \
                (i % cfg.ssm.slstm_period) == cfg.ssm.slstm_period - 1:
            mixer = "slstm"
        else:
            mixer = "mlstm"
        if kind.endswith("_moe"):
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "dense"
        else:
            ffn = "none"
        defs.append(LayerDef(mixer, ffn))
    return defs


def block_pattern(cfg: ModelConfig) -> Tuple[List[LayerDef], int]:
    """(pattern, repeats): smallest period p with defs[i] == defs[i % p]."""
    defs = layer_defs(cfg)
    n = len(defs)
    for p in range(1, n + 1):
        if n % p == 0 and all(defs[i] == defs[i % p] for i in range(n)):
            return defs[:p], n // p
    return defs, 1


def _layer_specs(ld: LayerDef, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "norm1": Spec((d,), ("norm",), torch.float32, "ones"),
        "mixer": _ATTN.specs(cfg),
        "norm2": Spec((d,), ("norm",), torch.float32, "ones"),
        "ffn": _SWIGLU.specs(cfg),
    }


def _index_fetch(params):
    """Default fetch: repeat r's parameters, a view into the device stack."""
    def fetch(r):
        return tuple({k: _index(v, r) for k, v in p.items()}
                     for p in params["blocks"])
    return fetch


def _index(tree, r):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


class LM:
    """Decoder-only LM; methods are functions of (params, state, inputs)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pattern, self.repeats = block_pattern(cfg)
        if self.pattern != [LayerDef("attn", "dense")]:
            raise NotImplementedError(
                f"{cfg.name}: block pattern {self.pattern} is "
                + _ROADMAP_MODELS)
        if cfg.is_encoder_decoder or cfg.num_image_patches:
            raise NotImplementedError(f"{cfg.name}: " + _ROADMAP_MODELS)

    # ------------------------------------------------------------------ specs
    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        dt = dtype_of(cfg)
        s: Dict[str, Any] = {
            "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          dt, fan_in=cfg.d_model),
            "final_norm": Spec((cfg.d_model,), ("norm",), torch.float32, "ones"),
            "blocks": tuple(
                stack_specs(_layer_specs(ld, cfg), self.repeats)
                for ld in self.pattern),
        }
        if not cfg.tie_embeddings:
            s["out"] = Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            dt, fan_in=cfg.d_model)
        return s

    def init(self, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
        return tree_init(self.specs(), generator, device)

    # --------------------------------------------------------------- embed/out
    def embed(self, params, tokens):
        """tokens [B, S] -> x [B, S, D]."""
        x = params["embed"][tokens.long()].to(dtype_of(self.cfg))
        return x * (self.cfg.d_model ** 0.5)

    def _out_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["out"]

    def logits_last(self, params, x_last):
        """x_last [B, D] -> [B, V] (f32)."""
        h = rms_norm(x_last, params["final_norm"], self.cfg.norm_eps)
        return _einsum("bd,dv->bv", h, self._out_w(params))

    # ----------------------------------------------------------------- layers
    def _ffn(self, p, x):
        return x + _SWIGLU(p["ffn"], rms_norm(x, p["norm2"], self.cfg.norm_eps))

    # ------------------------------------------------------------ seq forward
    def fwd_seq(self, params, x, ctx, collect_cache: bool = False):
        """x [B,S,D] -> (x, aux_loss, caches | None); caches is a one-entry
        tuple of {"k", "v"} stacked [R, B, S, Hkv, hd], as in the JAX LM."""
        cfg = self.cfg
        fetch = _index_fetch(params)
        ks, vs = [], []
        for r in range(self.repeats):
            (p,) = fetch(r)
            h, cache = _ATTN.fwd_seq(
                p["mixer"], rms_norm(x, p["norm1"], cfg.norm_eps), ctx, cfg)
            x = self._ffn(p, x + h)
            if collect_cache:
                ks.append(cache["k"])
                vs.append(cache["v"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = ({"k": torch.stack(ks), "v": torch.stack(vs)},) \
            if collect_cache else None
        return x, aux, caches

    # ------------------------------------------------------- paged decode
    def decode_step_paged(self, params, state, tokens, fetch=None):
        """Decode one token per batch row against the elastic paged pool.

        ``state``: pool_k/pool_v [R, P, page, Hkv, hd] (P grows when MIRAGE
        donates parameter segments), page_table [B, N] int32, ctx [B] int32
        (tokens already in each sequence's cache). A row whose write
        position lies past its page table (an empty engine slot whose
        cursor kept counting) writes nothing, as the JAX scatter drops an
        out-of-range write.
        """
        cfg = self.cfg
        fetch = fetch or _index_fetch(params)
        x = self.embed(params, tokens[:, None])[:, 0]
        pos = state["ctx"]                              # write position
        pt = state["page_table"]
        page, n = state["pool_k"].shape[2], pt.shape[1]
        j = (pos // page).long()
        inside = j < n
        pg = torch.gather(pt, 1, j.clamp(max=n - 1)[:, None])[:, 0].long()
        off = (pos % page).long()
        for r in range(self.repeats):
            (p,) = fetch(r)
            pool_k, pool_v = state["pool_k"][r], state["pool_v"][r]
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            q, k_new, v_new = _ATTN._qkv(p["mixer"], h, cfg)
            q = rope(q, pos, cfg.rope_theta)
            k_new = rope(k_new, pos, cfg.rope_theta)
            keep = inside[:, None, None]
            pool_k[pg, off] = torch.where(keep, k_new, pool_k[pg, off])
            pool_v[pg, off] = torch.where(keep, v_new, pool_v[pg, off])
            out = paged_decode_attention(q, pool_k, pool_v, pt, pos + 1,
                                         window=cfg.sliding_window)
            y = _einsum("bhk,hkd->bd", out, p["mixer"]["wo"]).to(x.dtype)
            x = self._ffn(p, x + y)
        logits = self.logits_last(params, x)
        return logits, dict(state, ctx=pos + 1)

    def prefill_chunk_paged(self, params, state, slot, tokens, start,
                            fetch=None):
        """One chunked-prefill step for batch row ``slot``: run the stack
        over ``tokens`` [S] at absolute positions ``start + arange(S)``,
        scattering each layer's K/V into the slot's pages before attending
        through the paged prefill kernel. ctx[slot] is dead state while the
        slot is mid-prefill (see the JAX docstring), so positions and masks
        derive from ``start``; ctx is reset to ``start + S`` on exit.
        Returns (last_logits [V], state)."""
        cfg = self.cfg
        fetch = fetch or _index_fetch(params)
        x = self.embed(params, tokens[None, :])               # [1, S, D]
        s = x.shape[1]
        dev = x.device
        pos = start + torch.arange(s, dtype=torch.int32, device=dev)
        page = state["pool_k"].shape[2]
        pt_row = state["page_table"][slot]                    # [N]
        pg = pt_row[(pos // page).long()].long()              # [S]
        off = (pos % page).long()
        q_start = torch.full((1,), start, dtype=torch.int32, device=dev)
        ctx_end = torch.full((1,), start + s, dtype=torch.int32, device=dev)
        for r in range(self.repeats):
            (p,) = fetch(r)
            pool_k, pool_v = state["pool_k"][r], state["pool_v"][r]
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            q, k_new, v_new = _ATTN._qkv(p["mixer"], h, cfg)     # [1,S,H,hd]
            q = rope(q, pos[None], cfg.rope_theta)
            k_new = rope(k_new, pos[None], cfg.rope_theta)
            pool_k[pg, off] = k_new[0]
            pool_v[pg, off] = v_new[0]
            out = paged_prefill_attention(
                q, pool_k, pool_v, pt_row[None].contiguous(), q_start,
                ctx_end, window=cfg.sliding_window)
            y = _einsum("bshk,hkd->bsd", out, p["mixer"]["wo"]).to(x.dtype)
            x = self._ffn(p, x + y)
        logits = self.logits_last(params, x[:, -1])
        ctx = state["ctx"].clone()
        ctx[slot] = start + s
        return logits[0], dict(state, ctx=ctx)

    def paged_state_from_prefill(self, caches, lengths, page_tables,
                                 num_pages: int, page_size: int,
                                 pool_k=None, pool_v=None):
        """Scatter dense prefill K/V caches into pool pages (into fresh
        zero pools, or in place into the given pools). caches: stacked
        [R, B, S, Hkv, hd]; page_tables [B, N]. As in the JAX LM, meant for
        batch=1 admissions: padded page-table entries beyond a sequence's
        own pages must not appear."""
        cfg = self.cfg
        hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        k = caches[0]["k"]
        r, b, s, _, _ = k.shape
        if pool_k is None:
            shape = (r, num_pages, page_size, hkv, hd)
            pool_k = torch.zeros(shape, dtype=k.dtype, device=k.device)
            pool_v = torch.zeros(shape, dtype=k.dtype, device=k.device)
        npg = -(-s // page_size)
        pages = page_tables[:, :npg].long()                   # [B, npg]

        def scatter(pool, kv):
            kvp = torch.zeros((r, b, npg * page_size, hkv, hd),
                              dtype=kv.dtype, device=kv.device)
            kvp[:, :, :s] = kv
            pool[:, pages] = kvp.reshape(r, b, npg, page_size, hkv, hd)
        scatter(pool_k, caches[0]["k"])
        scatter(pool_v, caches[0]["v"])
        return {"pool_k": pool_k, "pool_v": pool_v,
                "page_table": page_tables.to(torch.int32),
                "ctx": lengths.to(torch.int32)}
