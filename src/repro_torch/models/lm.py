"""Decoder-only LM over a repeating pattern of blocks (PyTorch counterpart
of ``repro.models.lm``): dense (llama, granite, phi3, danube), MoE
(moonshot, kimi), hybrid (jamba: Mamba + attention, MoE) and recurrent
(xLSTM) stacks. Attention stacks decode against the paged KV pool or, like
every other stack, against a dense per-slot decode state: each attention
layer's K/V cache (a ring of ``sliding_window`` slots for a windowed
config), each recurrent mixer's state.

Parameters keep the JAX layout: stacked over the R repeats of the block
pattern ([R, ...] leaves; ``params["blocks"]`` is a tuple with one tree per
pattern position), so one repeat is MIRAGE's remap unit and a ``fetch(r)``
function supplies repeat r's parameters (resident on device, or streamed
from pinned host memory by ``core.transfer_engine``).

The paged state's pools and the dense decode state are updated IN PLACE
(the JAX functions return new arrays): a full-width pool or state is
gigabytes, and the engine never needs the old one. Functions still return
the state dict, as in the JAX package.

A VLM (llava) is this LM with a prefix: precomputed patch embeddings
(``prefix_embeds`` [B, P, D], the stub of its vision frontend) go ahead of
the scaled token embeddings. Enc-dec (whisper) is ``models.encdec``.

Training runs ``fwd_seq`` under a remat policy and ``token_loss``, a
chunked cross-entropy (``Model.train_loss`` puts them together). Over a
mesh (``ctx["mesh"]``, ``mesh=``) every stack trains on the rank's blocks
of the parameters and of the batch: the embedding lookup and the
cross-entropy are vocab-parallel (``VocabEnds``, which ``models.encdec``
shares), the blocks FSDP x TP (attention and the recurrent mixers
heads-parallel, the dense FFN column/row-parallel, the MoE expert-parallel
with the JAX block's token groups: ``blocks``), every collective written
out in ``distributed.collectives``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    all_gather_dim, copy_to_region, fsdp_gather, max_over,
    reduce_from_region, sum_over,
)
from repro_torch.distributed.sharding import (
    batch_axis_names, get_mesh, get_rules, mesh_group, mesh_index,
    spec_axes, spec_for,
)
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_prefill_attention,
)
from repro_torch.models.blocks import (
    MLSTM, SLSTM, Attention, Mamba, MoE, SwiGLU, _block, _einsum,
    mesh_shared, rms_norm, rope, rows_axes,
)
from repro_torch.models.common import (
    Spec, dtype_of, remat, stack_specs, tree_init, tree_map,
)

@dataclasses.dataclass(frozen=True)
class LayerDef:
    mixer: str   # attn | mamba | mlstm | slstm
    ffn: str     # dense | moe | none


MIXERS = {"attn": Attention(), "mamba": Mamba(), "mlstm": MLSTM(),
          "slstm": SLSTM()}
_ATTN = MIXERS["attn"]
_SWIGLU = SwiGLU()
_MOE = MoE()


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
    specs: Dict[str, Any] = {
        "norm1": Spec((d,), ("norm",), torch.float32, "ones"),
        "mixer": MIXERS[ld.mixer].specs(cfg),
    }
    if ld.ffn != "none":
        specs["norm2"] = Spec((d,), ("norm",), torch.float32, "ones")
        specs["ffn"] = (_MOE if ld.ffn == "moe" else _SWIGLU).specs(cfg)
    return specs


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


def _ce_chunk(mesh, axes, v0, h, w, targets, mask):
    """(sum of the masked NLL, sum of the mask) of one chunk: h [B, C, D]
    against the vocab columns w [D, V_l] that start at ``v0``, logits in
    f32. Where ``axes`` split the vocabulary over ``mesh`` the max and the
    sum of exponentials are all-reduced over them, and the target's logit
    comes from the rank that holds it (with no axes, v0 = 0: the whole
    vocabulary here)."""
    logits = _einsum("bcd,dv->bcv", h, w)
    m = max_over(logits.detach().amax(dim=-1), mesh, axes, "ce_all_reduce")
    se = reduce_from_region(torch.exp(logits - m[..., None]).sum(dim=-1),
                            mesh, axes, "ce_all_reduce")
    t = targets.long() - v0
    inside = (t >= 0) & (t < logits.shape[-1])
    gold = torch.gather(logits, -1, t.clamp(0, logits.shape[-1] - 1)[
        ..., None])[..., 0] * inside
    gold = reduce_from_region(gold, mesh, axes, "ce_all_reduce")
    return ((m + torch.log(se) - gold) * mask).sum(), mask.sum()


class VocabEnds:
    """The two ends of a decoder that meet the vocabulary, shared by ``LM``
    and ``encdec.EncDec``: the embedding lookup, the last position's
    logits and the chunked cross-entropy. Over a ``mesh`` the lookup and
    the cross-entropy are vocab-parallel (each weight FSDP-gathered where
    it is used); with no mesh every collective is the identity. A subclass
    has ``cfg`` and ``specs()`` with "embed" [V, D], "final_norm" and,
    unless ``cfg.tie_embeddings``, "out" [D, V]."""

    def _spec(self, name: str, mesh):
        """The spec of leaf ``name`` on ``mesh`` (nothing split with no
        mesh)."""
        if mesh is None:
            return ()
        s = self.specs()[name]
        return spec_for(s.logical, s.shape, mesh, get_rules())

    def embed(self, params, tokens, prefix_embeds=None, mesh=None):
        """tokens [B, St] (+ an optional prefix [B, P, D], cast to the
        model's dtype) -> x [B, P + St, D]. On a ``mesh`` that splits the
        vocabulary the rank's vocab rows look up the tokens they hold,
        zeros elsewhere, and the rows are summed over the vocab's axes."""
        spec = self._spec("embed", mesh)
        w = fsdp_gather(params["embed"], spec, mesh)
        axes = spec_axes(spec, 0)
        if axes:
            v_l = w.shape[0]
            t = tokens.long() - mesh_index(mesh, axes) * v_l
            inside = (t >= 0) & (t < v_l)
            x = reduce_from_region(
                w[t.clamp(0, v_l - 1)] * inside[..., None], mesh, axes)
        else:
            x = w[tokens.long()]
        x = x.to(dtype_of(self.cfg)) * (self.cfg.d_model ** 0.5)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        return x

    def _out_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["out"]

    def logits_last(self, params, x_last, mesh=None):
        """x_last [B, D] -> [B, V] (f32). On a ``mesh`` x_last holds the
        rank's rows and the head is vocab-parallel: the rank's [B, V / n]
        block of the logits, gathered over the vocab's axes."""
        h = rms_norm(x_last, params["final_norm"], self.cfg.norm_eps)
        name = "embed" if self.cfg.tie_embeddings else "out"
        spec = self._spec(name, mesh)
        w = fsdp_gather(params[name], spec, mesh)
        if self.cfg.tie_embeddings:
            w = w.T
        logits = _einsum("bd,dv->bv", h, w)
        axes = spec_axes(spec, 0 if self.cfg.tie_embeddings else 1)
        if not axes:
            return logits
        return all_gather_dim(logits, mesh_group(mesh, axes), 1,
                              "logits_all_gather").contiguous()

    def token_loss(self, params, x, targets, mask, chunk: int = 512,
                   mesh=None):
        """Mean masked next-token cross-entropy of x [B, S, D] against
        targets [B, S] (mask [B, S] f32), a scalar, as the JAX loss returns.
        Chunked over the sequence, each chunk checkpointed when autograd is
        on, so [B, S, V] logits never exist: only one chunk's [B, chunk, V]
        at a time, forward and backward.

        On a ``mesh`` x holds the rank's rows and the cross-entropy is
        vocab-parallel (``_ce_chunk``); the NLL and mask sums are summed
        over the data axes before the division, so the loss (and its
        gradient, once the gradients are summed over those axes) is the
        global batch's mean. A batch the fallback kept whole on some data
        axis repeats there in both sums alike."""
        cfg = self.cfg
        s = x.shape[1]
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        name = "embed" if cfg.tie_embeddings else "out"
        spec = self._spec(name, mesh)
        w = fsdp_gather(params[name], spec, mesh)
        if cfg.tie_embeddings:
            w = w.T
        axes = spec_axes(spec, 0 if cfg.tie_embeddings else 1)
        h = copy_to_region(h, mesh, axes)
        ce = remat(functools.partial(
            _ce_chunk, mesh, axes, mesh_index(mesh, axes) * w.shape[1]),
            "full")
        chunk = min(chunk, s)
        while s % chunk:
            chunk -= 1
        tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, chunk):
            sl = slice(c0, c0 + chunk)
            nll, m = ce(h[:, sl], w, targets[:, sl], mask[:, sl])
            tot, cnt = tot + nll, cnt + m
        data = () if mesh is None else batch_axis_names(mesh)
        tot = reduce_from_region(tot, mesh, data, "loss_all_reduce")
        cnt = sum_over(cnt, mesh, data, "loss_all_reduce")
        return tot / cnt.clamp_min(1.0)


class LM(VocabEnds):
    """Decoder-only LM; methods are functions of (params, state, inputs)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name}: an encoder-decoder config is "
                             "models.encdec.EncDec, not LM")
        self.pattern, self.repeats = block_pattern(cfg)
        # only attention stacks can decode against the paged KV pool
        self.attention_only = all(ld.mixer == "attn" for ld in self.pattern)

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

    # ----------------------------------------------------------------- layers
    def _ffn(self, ld: LayerDef, p, x, aux=None, mesh=None, data=None):
        """x + the layer's FFN of x. An MoE layer appends its load-balance
        loss to the list ``aux`` where one is given (the sequence forward);
        the decode paths give none and skip computing it. ``mesh``: the
        FFN on the rank's blocks (the MoE's groups and aux loss the global
        batch's; ``data``: the axes that split the rows, as
        ``MoE.route``)."""
        if ld.ffn == "none":
            return x
        h = rms_norm(x, p["norm2"], self.cfg.norm_eps)
        if ld.ffn == "dense":
            return x + _SWIGLU(p["ffn"], h, mesh, self.cfg)
        if aux is None:
            return x + _MOE.forward(p["ffn"], h, self.cfg, mesh, data)[0]
        y, a = _MOE(p["ffn"], h, self.cfg, mesh=mesh, data=data)
        aux.append(a)
        return x + y

    # ------------------------------------------------------------ seq forward
    def fwd_seq(self, params, x, ctx, remat_policy=None,
                collect_cache: bool = False):
        """x [B,S,D] -> (x, aux_loss, caches | None); caches is a tuple with
        one cache tree per pattern position, its leaves stacked over the
        repeats ([R, ...]), as in the JAX LM: {"k", "v"} [R, B, S, Hkv, hd]
        for attention, the final recurrent state for the recurrent mixers.
        aux_loss sums the MoE layers' load-balance losses.

        ``remat_policy`` (None, "none", "full" or "dots_saveable"; see
        ``common.remat``) applies to each repeat of the block pattern, as
        the JAX LM checkpoints its scan body; with a policy, a pattern of
        more than one layer also checkpoints each layer inside the repeat
        (the JAX LM's inner remat), so the backward of a repeat holds one
        layer's activations at a time.

        ``ctx["mesh"]``: the stack over a mesh, ``params`` and x the rank's
        blocks; each weight is gathered where it is used, inside the
        rematerialised body, so a recompute gathers again. ``ctx["data"]``:
        the axes that split x's rows where not every data axis does (the
        MoE's groups, ``MoE.route``)."""
        cfg = self.cfg
        mesh = ctx.get("mesh")
        data = ctx.get("data")
        fetch = _index_fetch(params)
        inner = remat_policy not in (None, "none") and len(self.pattern) > 1

        def layer(ld, p, x, aux):
            h, cache = MIXERS[ld.mixer].fwd_seq(
                p["mixer"], rms_norm(x, p["norm1"], cfg.norm_eps), ctx, cfg)
            a = []
            x = self._ffn(ld, p, x + h, a, mesh, data)
            return x, (aux + a[0] if a else aux), cache

        def body(x, aux, layer_params):
            caches = []
            for ld, p in zip(self.pattern, layer_params):
                fn = functools.partial(layer, ld)
                x, aux, cache = (remat(fn, "full") if inner else fn)(
                    p, x, aux)
                caches.append(cache)
            return x, aux, caches

        step = remat(body, remat_policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        per_pos: List[list] = [[] for _ in self.pattern]
        for r in range(self.repeats):
            x, aux, caches = step(x, aux, fetch(r))
            if collect_cache:
                for i, cache in enumerate(caches):
                    per_pos[i].append(cache)
        caches = tuple(
            tree_map(lambda *xs: torch.stack(xs), *c) for c in per_pos) \
            if collect_cache else None
        return x, aux, caches

    # ------------------------------------------------------- decode state mgmt
    def decode_state_specs(self, batch: int, max_context: int) -> Dict[str, Any]:
        """Spec tree of the dense decode state: ``pos`` [B]; per pattern
        position, the mixer's state stacked over the repeats ([R, B, ...]);
        and, for a sliding-window config, ``kv_pos`` [B, window]: the
        position each ring slot holds (-1: empty)."""
        st: Dict[str, Any] = {
            "pos": Spec((batch,), ("batch",), torch.int32, "zeros"),
            "blocks": tuple(
                stack_specs(
                    {"mixer": MIXERS[ld.mixer].init_state(
                        self.cfg, batch, max_context)},
                    self.repeats)
                for ld in self.pattern),
        }
        if self.cfg.sliding_window:
            st["kv_pos"] = Spec((batch, self._cache_len(max_context)),
                                ("batch", "kv_seq"), torch.int32, "neg_ones")
        return st

    def init_decode_state(self, batch: int, max_context: int, device="cuda"):
        return tree_map(lambda s: s.materialize(None, device),
                        self.decode_state_specs(batch, max_context))

    def _cache_len(self, max_context: int) -> int:
        return _ATTN.cache_len(self.cfg, max_context)

    def state_from_prefill(self, caches, positions_end, max_context: int,
                           mesh=None, global_batch: int = 0):
        """Build the decode state from fwd_seq caches (stacked [R, ...]): an
        attention cache is padded (or laid out as a ring) to the decode
        cache's length; a recurrent mixer's cache IS its decode state.

        ``mesh`` (with the ``global_batch``): the caches and
        ``positions_end`` hold the rank's rows and the heads its blocks
        computed; the state is the rank's block in ``decode_state_specs``'
        layout (each mixer's ``seq_cache_to_state``), ``kv_pos`` its
        block of the ring's positions."""
        cfg = self.cfg
        blocks = tuple(
            {"mixer": MIXERS[ld.mixer].seq_cache_to_state(
                cfg, cache, max_context, mesh, global_batch)}
            for ld, cache in zip(self.pattern, caches))
        pe = positions_end.to(torch.int32)
        st = {"pos": pe, "blocks": blocks}
        if cfg.sliding_window:
            w = self._cache_len(max_context)
            idx = torch.arange(w, dtype=torch.int32, device=pe.device)[None]
            kv_pos = torch.where(idx < pe[:, None], idx, -1)
            # ring layout when the prefill is longer than the window: slot
            # t % w holds token t
            base = torch.clamp(pe - w, min=0)[:, None]
            tok = base + (idx - base % w) % w
            ring = torch.where(tok < pe[:, None], tok, -1)
            kv_pos = torch.where((pe > w)[:, None], ring, kv_pos)
            seq = _block(mesh, self._kv_pos_axes(mesh, global_batch, w), w)
            st["kv_pos"] = kv_pos[:, seq].contiguous()
        return st

    def _kv_pos_axes(self, mesh, batch: int, w: int):
        """The axes that split a ring's ``kv_pos`` [batch, w] over its
        slots (its layout, ("batch", "kv_seq")); () with no mesh."""
        if mesh is None:
            return ()
        s = self.decode_state_specs(batch, w)["kv_pos"]
        return spec_axes(spec_for(s.logical, s.shape, mesh, get_rules()), 1)

    def _decode_shared(self, state, max_context: int, mesh=None,
                       global_batch: int = 0):
        """Decode positions and validity shared by all layers (the dense
        attention caches read them; recurrent mixers ignore them). A ring's
        ``kv_pos`` takes the new token's position at its slot, in place.

        ``mesh`` (with the ``global_batch``): the rank's rows, cut by
        ``blocks.mesh_shared`` (a ring's ``kv_pos`` state, the rank's
        block in its own layout, is gathered whole over the axes that
        split it first, and the rank's block written back)."""
        pos = state["pos"]
        b = pos.shape[0]
        s_c = self._cache_len(max_context)
        rows = torch.arange(b, device=pos.device)
        if self.cfg.sliding_window:
            slot = pos % s_c
            kv_pos = state["kv_pos"]
            axes = self._kv_pos_axes(mesh, global_batch, s_c)
            if axes:
                whole = all_gather_dim(kv_pos, mesh_group(mesh, axes), 1,
                                       "kv_pos_all_gather").contiguous()
                whole[rows, slot.long()] = pos
                kv_pos.copy_(whole[:, _block(mesh, axes, s_c)])
                kv_pos = whole
            else:
                kv_pos[rows, slot.long()] = pos
            kv_valid = kv_pos >= 0
        else:
            slot = torch.clamp(pos, max=s_c - 1)
            kv_pos = torch.arange(s_c, dtype=torch.int32,
                                  device=pos.device)[None].expand(b, s_c)
            kv_valid = kv_pos <= pos[:, None]
        return mesh_shared({"pos": pos, "slot": slot, "kv_pos": kv_pos,
                            "kv_valid": kv_valid}, mesh, global_batch, s_c)

    # ------------------------------------------------------------- decode step
    @torch.no_grad()
    def decode_step(self, params, state, tokens, max_context: int,
                    fetch=None, global_batch: int = 0):
        """One token for every sequence against the dense decode state.
        Returns (logits [B, V], state); each layer's state is overwritten in
        place with what its mixer returns (attention returns nothing: its
        cache takes the new row where it lies, so no layer copies a whole
        cache). ``fetch(r)`` returns repeat r's
        layer-params tuple (default: an index into ``params['blocks']``;
        MIRAGE passes one that streams remapped repeats from host). Call
        order is r = 0, 1, ..., R-1.

        Under a mesh (``get_mesh()``; ``global_batch`` is then required)
        params, fetched layers, state and tokens are the rank's blocks
        (``Model.decode_state_shardings``), the blocks run heads-parallel,
        FFNs tensor- or expert-parallel, attention's flash-decode over the
        axes that split the cache; no autograd. The logits are the rank's
        rows, every vocabulary entry."""
        cfg = self.cfg
        mesh = get_mesh()
        data = _require_batch(mesh, global_batch)
        x = self.embed(params, tokens[:, None], mesh=mesh)[:, 0]
        shared = self._decode_shared(state, max_context, mesh,
                                     global_batch)
        fetch = fetch or _index_fetch(params)
        for r in range(self.repeats):
            for ld, p, st in zip(self.pattern, fetch(r), state["blocks"]):
                h, new = MIXERS[ld.mixer].fwd_dec(
                    p["mixer"], rms_norm(x, p["norm1"], cfg.norm_eps),
                    _index(st["mixer"], r), shared, cfg)
                x = self._ffn(ld, p, x + h, mesh=mesh, data=data)
                for key, val in new.items():
                    st["mixer"][key][r].copy_(val)
        logits = self.logits_last(params, x, mesh)
        return logits, dict(state, pos=state["pos"] + 1)

    # ------------------------------------------------------- paged decode
    def _require_attention(self, what: str) -> None:
        if not self.attention_only:
            raise ValueError(f"{self.cfg.name}: {what} needs an attention "
                             "stack (Mamba and recurrent stacks are dense)")

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
        self._require_attention("decode_step_paged")
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
            x = self._ffn(self.pattern[0], p, x + y)
        logits = self.logits_last(params, x)
        return logits, dict(state, ctx=pos + 1)

    def prefill_chunk_paged(self, params, state, slot, tokens, start,
                            fetch=None, prefix_embeds=None):
        """One chunked-prefill step for batch row ``slot``: run the stack
        over ``tokens`` [S] (after ``prefix_embeds`` [1, P, D] where given:
        S counts both) at absolute positions ``start + arange(S)``,
        scattering each layer's K/V into the slot's pages before attending
        through the paged prefill kernel. ctx[slot] is dead state while the
        slot is mid-prefill (see the JAX docstring), so positions and masks
        derive from ``start``; ctx is reset to ``start + S`` on exit.
        Returns (last_logits [V], state)."""
        self._require_attention("prefill_chunk_paged")
        x = self.embed(params, tokens[None, :], prefix_embeds)   # [1, S, D]
        s = x.shape[1]
        dev = x.device
        pos = start + torch.arange(s, dtype=torch.int32, device=dev)
        q_start = torch.full((1,), start, dtype=torch.int32, device=dev)
        ctx_end = torch.full((1,), start + s, dtype=torch.int32, device=dev)
        logits = self.prefill_chunk_stack(
            params, state["pool_k"], state["pool_v"], state["page_table"][slot],
            x, pos, q_start, ctx_end, fetch)
        ctx = state["ctx"].clone()
        ctx[slot] = start + s
        return logits[0], dict(state, ctx=ctx)

    def prefill_chunk_stack(self, params, pool_k, pool_v, pt_row, x, pos,
                            q_start, ctx_end, fetch=None):
        """The layer stack of one prefill chunk x [1, S, D] at positions
        ``pos`` [S] (int32) of the sequence whose page-table row is
        ``pt_row`` [N]: each layer's K/V scattered into ``pool_k`` /
        ``pool_v`` [R, P, page, Hkv, hd] in place, then attended by the
        paged prefill kernel from ``q_start`` to ``ctx_end`` ([1] int32
        each). Returns the last row's logits [1, V]. Every position comes
        from a device tensor, so a captured chunk (``serving.prefill_graph``)
        replays at any start."""
        cfg = self.cfg
        fetch = fetch or _index_fetch(params)
        page = pool_k.shape[2]
        pg = pt_row[(pos // page).long()].long()              # [S]
        off = (pos % page).long()
        for r in range(self.repeats):
            (p,) = fetch(r)
            pk, pv = pool_k[r], pool_v[r]
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            q, k_new, v_new = _ATTN._qkv(p["mixer"], h, cfg)     # [1,S,H,hd]
            q = rope(q, pos[None], cfg.rope_theta)
            k_new = rope(k_new, pos[None], cfg.rope_theta)
            pk[pg, off] = k_new[0]
            pv[pg, off] = v_new[0]
            out = paged_prefill_attention(
                q, pk, pv, pt_row[None].contiguous(), q_start, ctx_end,
                window=cfg.sliding_window)
            y = _einsum("bshk,hkd->bsd", out, p["mixer"]["wo"]).to(x.dtype)
            x = self._ffn(self.pattern[0], p, x + y)
        return self.logits_last(params, x[:, -1])

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

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, params, tokens, max_context: int, prefix_embeds=None,
                lengths=None, global_batch: int = 0, slstm_graphs=None):
        """tokens [B, St] (after ``prefix_embeds`` [B, P, D] where given) ->
        (last_logits [B, V], dense decode state). ``lengths`` [B]: each
        row's real length of the S = P + St rows (default S); the logits
        are those of row ``lengths - 1`` and decode continues there.

        Under a mesh (``get_mesh()``; ``global_batch`` is then required)
        params and inputs are the rank's blocks (the rows of tokens, prefix
        and lengths), the stack runs as ``fwd_seq`` does on a mesh, without
        autograd, the logits are the rank's rows (every vocabulary entry)
        and the state the rank's block (``state_from_prefill``).

        ``slstm_graphs``: an ``SLSTMGraphs`` whose captured chunks the
        sLSTM layers replay on one CUDA device (``SLSTM.fwd_seq``); None
        runs their eager loop."""
        mesh = get_mesh()
        data = _require_batch(mesh, global_batch)
        b = tokens.shape[0]
        x = self.embed(params, tokens, prefix_embeds, mesh=mesh)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        x, _aux, caches = self.fwd_seq(
            params, x, {"positions": positions, "mesh": mesh, "data": data,
                        "slstm_graphs": slstm_graphs},
            collect_cache=True)
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
        last = torch.clamp(lengths.long() - 1, 0, s - 1)
        logits = self.logits_last(params, x[torch.arange(b, device=x.device),
                                            last], mesh)
        return logits, self.state_from_prefill(caches, lengths, max_context,
                                               mesh, global_batch)


def _require_batch(mesh, batch: int):
    """The axes that split the rows of a serving batch of ``batch`` rows
    on ``mesh`` (``blocks.rows_axes``); None with no mesh. A mesh needs
    the global batch: the rank holds its rows only."""
    if mesh is None:
        return None
    if batch <= 0:
        raise ValueError("serving over a mesh needs global_batch= (the "
                         "rank holds its rows only)")
    return rows_axes(mesh, batch)
