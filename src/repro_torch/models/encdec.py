"""Encoder-decoder backbone (whisper-medium; PyTorch counterpart of
``repro.models.encdec``). The conv/mel frontend is a stub, as in the JAX
package: inputs are precomputed frame embeddings [B, S_enc, D].

Positions use RoPE in place of whisper's sinusoidal/learned embeddings, as
in the reference. The encoder runs bidirectional self-attention (the flash
kernel, non-causal, on CUDA); each decoder layer runs causal
self-attention, cross-attention over the encoder's output (the flash
kernel with Sq = decoder rows, Sk = encoder rows at prefill) and a SwiGLU
FFN. The cross K/V are computed once at prefill and only read during
decode, so a remapped decoder repeat streams its parameters while its
cross cache stays in the decode state.

The dense decode state is updated IN PLACE (the self-attention caches take
the new token's row where they lie), as in ``LM.decode_step``. ``loss`` is
the training objective: the decoder's mean masked cross-entropy, as in the
reference, through the LM's chunked cross-entropy (``lm.VocabEnds``), so
[B, S, V] logits never exist.

Over a mesh (``mesh=``) the model trains on the rank's blocks of the
parameters and of the batch, as the LM does: the encoder and the decoder
layers FSDP x TP (attention heads-parallel, cross-attention included, the
FFN column/row-parallel), the embedding lookup and the cross-entropy
vocab-parallel (``lm.VocabEnds``). The frames arrive as the rank's block of
their sequence (the input spec's "seq_cp"); the encoder gathers them whole.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_gather_dim
from repro_torch.distributed.sharding import mesh_group
from repro_torch.models.blocks import Attention, SwiGLU, rms_norm
from repro_torch.models.common import (
    Spec, dtype_of, remat, stack_specs, tree_init, tree_map,
)
from repro_torch.models.lm import VocabEnds, _index, _index_fetch

_SELF = Attention()
_CROSS = Attention(cross=True)
_FFN = SwiGLU()


class EncDec(VocabEnds):
    """Encoder-decoder; methods are functions of (params, state, inputs)."""

    # the engine's paged path needs a decoder-only attention stack
    attention_only = False

    def __init__(self, cfg: ModelConfig):
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.repeats = cfg.num_layers            # decoder depth
        self.pattern = ["encdec"]                # single-position pattern

    # ------------------------------------------------------------------ specs
    def _enc_layer(self) -> Dict[str, Any]:
        d = self.cfg.d_model
        return {
            "norm1": Spec((d,), ("norm",), torch.float32, "ones"),
            "attn": _SELF.specs(self.cfg),
            "norm2": Spec((d,), ("norm",), torch.float32, "ones"),
            "ffn": _FFN.specs(self.cfg),
        }

    def _dec_layer(self) -> Dict[str, Any]:
        d = self.cfg.d_model
        return {
            "norm1": Spec((d,), ("norm",), torch.float32, "ones"),
            "self": _SELF.specs(self.cfg),
            "norm_x": Spec((d,), ("norm",), torch.float32, "ones"),
            "cross": _CROSS.specs(self.cfg),
            "norm2": Spec((d,), ("norm",), torch.float32, "ones"),
            "ffn": _FFN.specs(self.cfg),
        }

    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        dt = dtype_of(cfg)
        return {
            "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          dt, fan_in=cfg.d_model),
            "out": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                        dt, fan_in=cfg.d_model),
            "enc_norm": Spec((cfg.d_model,), ("norm",), torch.float32, "ones"),
            "final_norm": Spec((cfg.d_model,), ("norm",), torch.float32,
                               "ones"),
            "encoder": stack_specs(self._enc_layer(), cfg.num_encoder_layers),
            "blocks": (stack_specs(self._dec_layer(), cfg.num_layers),),
        }

    def init(self, generator: torch.Generator,
             device="cuda") -> Dict[str, Any]:
        return tree_init(self.specs(), generator, device)

    # ---------------------------------------------------------------- encoder
    def encode(self, params, frames, mesh=None, frames_axes=()):
        """frames [B, S_enc, D] (stub frontend output) -> enc_out. Under a
        ``mesh`` the rank's blocks of the weights and its rows of the batch;
        ``frames_axes``: the mesh axes that split the frames' sequence (the
        rank holds its block), gathered whole before layer 0 (the
        positions are those of the whole sequence)."""
        cfg = self.cfg
        x = frames.to(dtype_of(cfg))
        if frames_axes:
            x = all_gather_dim(x, mesh_group(mesh, frames_axes), 1,
                               "frames_all_gather")
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        ctx = {"positions": positions, "bidirectional": True, "mesh": mesh}
        for i in range(cfg.num_encoder_layers):
            p = _index(params["encoder"], i)
            h, _ = _SELF.fwd_seq(p["attn"], rms_norm(x, p["norm1"],
                                                     cfg.norm_eps), ctx, cfg)
            x = x + h
            x = x + _FFN(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps),
                         mesh, cfg)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    # ---------------------------------------------------------------- decoder
    def embed(self, params, tokens, prefix_embeds=None, mesh=None):
        """tokens [B, S] -> x [B, S, D], the LM's lookup (vocab-parallel on
        a ``mesh``); ``prefix_embeds`` is ignored, as in the reference."""
        return super().embed(params, tokens, mesh=mesh)

    def dec_seq(self, params, x, enc_out, remat_policy=None,
                collect_cache: bool = False, mesh=None):
        """Decoder over x [B, S, D] against enc_out -> (x, caches | None):
        caches {"self", "cross"}, each {k, v} stacked over the repeats
        [R, B, S or S_enc, Hkv, hd], as the JAX scan returns them.
        ``remat_policy`` applies to each decoder layer (``common.remat``),
        as the JAX decoder checkpoints its scan body; under a ``mesh`` the
        layer's gathers and collectives run inside the checkpointed body,
        so a recompute gathers again."""
        cfg = self.cfg
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        ctx = {"positions": positions, "enc_out": enc_out, "mesh": mesh}

        def body(x, p):
            h, self_cache = _SELF.fwd_seq(
                p["self"], rms_norm(x, p["norm1"], cfg.norm_eps), ctx, cfg)
            x = x + h
            h, cross_cache = _CROSS.fwd_seq(
                p["cross"], rms_norm(x, p["norm_x"], cfg.norm_eps), ctx, cfg)
            x = x + h
            x = x + _FFN(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps),
                         mesh, cfg)
            return x, {"self": self_cache, "cross": cross_cache}

        step = remat(body, remat_policy)
        per_layer = []
        for r in range(self.repeats):
            x, cache = step(x, _index(params["blocks"][0], r))
            if collect_cache:
                per_layer.append(cache)
        caches = tree_map(lambda *xs: torch.stack(xs), *per_layer) \
            if collect_cache else None
        return x, caches

    def loss(self, params, frames, tokens, targets, mask,
             remat_policy="dots_saveable", mesh=None, frames_axes=()):
        """Mean masked cross-entropy of the decoder's next-token logits
        after encoding ``frames``; a scalar. The reference's loss always
        checkpoints the decoder with dots_saveable; here the caller's
        policy applies (the value is the same). ``mesh`` and
        ``frames_axes``: as ``encode``; the cross-entropy is the global
        batch's mean (``VocabEnds.token_loss``)."""
        enc_out = self.encode(params, frames, mesh, frames_axes)
        x = self.embed(params, tokens, mesh=mesh)
        x, _ = self.dec_seq(params, x, enc_out, remat_policy=remat_policy,
                            mesh=mesh)
        return self.token_loss(params, x, targets, mask, mesh=mesh)

    # ------------------------------------------------------------ decode path
    def decode_state_specs(self, batch: int,
                           max_context: int) -> Dict[str, Any]:
        """``pos`` [B]; per decoder repeat, the self cache [B, max_context,
        Hkv, hd] and the cross cache [B, max_source_len, Hkv, hd]; and
        ``src_len`` [B], each slot's real encoder rows."""
        cfg = self.cfg
        hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        dt = dtype_of(cfg)
        src = cfg.max_source_len

        def kv(s, seq_axis):
            return Spec((batch, s, hkv, hd), ("batch", seq_axis, None, None),
                        dt, "zeros")
        per_layer = {"mixer": {
            "self": {"k": kv(max_context, "kv_seq"),
                     "v": kv(max_context, "kv_seq")},
            "cross": {"k": kv(src, None), "v": kv(src, None)},
        }}
        return {
            "pos": Spec((batch,), ("batch",), torch.int32, "zeros"),
            "blocks": (stack_specs(per_layer, self.repeats),),
            # Not in the reference's decode state (repro/models/encdec.py:
            # 129-151), so its engine's slot insertion, which copies only
            # the keys of the engine state (repro/models/registry.py:83-98),
            # drops the src_len that prefill returns, and decode then
            # attends over every zero-padded cross row. Here it is a leaf,
            # so insert_slot carries it into the slot.
            "src_len": Spec((batch,), ("batch",), torch.int32, "zeros"),
        }

    def init_decode_state(self, batch: int, max_context: int, device="cuda"):
        return tree_map(lambda s: s.materialize(None, device),
                        self.decode_state_specs(batch, max_context))

    def prefill(self, params, frames, tokens, max_context: int):
        """Encode the source, teacher-force the prompt tokens [B, S], and
        build the decode state. Returns (last_logits [B, V], state)."""
        cfg = self.cfg
        b, s = tokens.shape
        src = cfg.max_source_len
        enc_out = self.encode(params, frames)
        x = self.embed(params, tokens)
        x, caches = self.dec_seq(params, x, enc_out, collect_cache=True)
        logits = self.logits_last(params, x[:, -1])

        def fit(a, n):
            """a [R, B, S, H, hd] padded with zero rows or cut to n rows."""
            if a.shape[2] >= n:
                return a[:, :, :n].contiguous()
            out = a.new_zeros(a.shape[:2] + (n,) + a.shape[3:])
            out[:, :, :a.shape[2]] = a
            return out
        # self K/V padded to the decode cache; cross K/V (the encoder's
        # length) padded or cut to max_source_len
        self_c = {k: fit(v, max_context) for k, v in caches["self"].items()}
        cross_c = {k: fit(v, src) for k, v in caches["cross"].items()}
        dev = tokens.device
        state = {
            "pos": torch.full((b,), s, dtype=torch.int32, device=dev),
            "blocks": ({"mixer": {"self": self_c, "cross": cross_c}},),
            "src_len": torch.full((b,), min(frames.shape[1], src),
                                  dtype=torch.int32, device=dev),
        }
        return logits, state

    def decode_step(self, params, state, tokens, max_context: int,
                    fetch=None, src_len=None, cross_transform=None):
        """One token for every sequence. ``fetch(r)`` returns decoder repeat
        r's (params,) tuple, called for r = 0, 1, ..., R-1 (default: an
        index into ``params['blocks']``; MIRAGE passes one that streams
        remapped repeats from host). ``src_len`` [B] overrides the state's;
        ``cross_transform(cross)`` is applied to each repeat's cross cache
        before it is read (the reference's hook for streaming the cross
        cache like parameters). Returns (logits [B, V], state)."""
        cfg = self.cfg
        b = tokens.shape[0]
        x = self.embed(params, tokens[:, None])[:, 0]
        pos = state["pos"]
        dev = pos.device
        src = cfg.max_source_len
        if src_len is None:
            src_len = state.get("src_len")
        if src_len is None:
            src_len = torch.full((b,), src, dtype=torch.int32, device=dev)
        kv_pos = torch.arange(max_context, dtype=torch.int32,
                              device=dev)[None].expand(b, max_context)
        cross_pos = torch.arange(src, dtype=torch.int32,
                                 device=dev)[None].expand(b, src)
        shared = {
            "pos": pos,
            "slot": torch.clamp(pos, max=max_context - 1),
            "kv_pos": kv_pos,
            "kv_valid": kv_pos <= pos[:, None],
            "cross_pos": cross_pos,
            "cross_valid": cross_pos < src_len[:, None],
        }
        fetch = fetch or _index_fetch(params)
        (st,) = state["blocks"]
        for r in range(self.repeats):
            (p,) = fetch(r)
            st_r = _index(st["mixer"], r)
            cross = st_r["cross"] if cross_transform is None \
                else cross_transform(st_r["cross"])
            h, _ = _SELF.fwd_dec(p["self"], rms_norm(x, p["norm1"],
                                                     cfg.norm_eps),
                                 st_r["self"], shared, cfg)
            x = x + h
            h, _ = _CROSS.fwd_dec(p["cross"], rms_norm(x, p["norm_x"],
                                                       cfg.norm_eps),
                                  cross, shared, cfg)
            x = x + h
            x = x + _FFN(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps))
        logits = self.logits_last(params, x)
        return logits, dict(state, pos=pos + 1)
