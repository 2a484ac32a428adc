"""Attention ops in plain PyTorch: chunked online softmax (flash-style).

These are (a) the CPU execution path and (b) the plain versions the CUDA
kernels in ``repro_torch.kernels`` are held against. They compute what
``repro.models.attention_ops`` computes, in the same layouts:

  q:  [B, Sq, Hq, D]       (Hq = n_kv_heads * group)
  k:  [B, Sk, Hkv, D]
  v:  [B, Sk, Hkv, D]
  q_pos: [B, Sq] int32     absolute position of each query
  kv_pos: [B, Sk] int32    absolute position of each kv slot
  kv_valid: [B, Sk] bool   slot holds real data

Scores and the softmax run in f32 whatever the input type (the JAX ops
ask for f32 products with ``preferred_element_type``); q is scaled in its
own dtype first, as the JAX ops do.

``FlashAttention`` is the gradient of full attention (the JAX op's custom
VJP): its forward is a function returning the output and each row's
log-sum-exp (the plain chunked softmax here, the CUDA kernel in
``kernels.flash_attention``), and its backward recomputes the scores chunk
by chunk in f32 from that log-sum-exp, so no [Sq, Sk] probabilities are
kept for it.

``distributed_decode_attention`` is the flash-decode with the KV sequence
split over ranks of a ``DeviceMesh``: each rank runs the plain chunked
softmax over its slice (the JAX reference's partial is ``jnp``, not a
Pallas kernel) and ``lse_combine`` merges the partials with two
all-reduces over the ranks' process group.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.collectives import all_max, all_sum
from repro_torch.distributed.sharding import mesh_group

NEG_INF = -1e30


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, Sq, Hq, D] -> [B, Sq, Hkv, G, D]."""
    b, sq, hq, d = q.shape
    assert hq % n_kv == 0, (hq, n_kv)
    return q.reshape(b, sq, n_kv, hq // n_kv, d)


def _flash_core(q, k, v, q_pos, kv_pos, kv_valid, *, causal: bool,
                window: int, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked online softmax over q [B, Sq, Hkv, G, D] (pre-scaled).
    Returns UNNORMALIZED (o [B,Sq,Hkv,G,D], m, l [B,Sq,Hkv,G]) in f32."""
    b, sq, hkv, g, d = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    while sk % chunk:          # largest divisor of sk not above the request
        chunk -= 1
    qf = q.float()
    o = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        k_j = k[:, c0:c0 + chunk].float()
        v_j = v[:, c0:c0 + chunk].float()
        p_j = kv_pos[:, c0:c0 + chunk]
        mask = kv_valid[:, c0:c0 + chunk][:, None, :]     # [B, 1, chunk]
        if causal:
            mask = mask & (p_j[:, None, :] <= q_pos[:, :, None])
        if window > 0:
            mask = mask & (q_pos[:, :, None] - p_j[:, None, :] < window)
        s = torch.einsum("bqhgd,bchd->bqhgc", qf, k_j)
        s = torch.where(mask[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bqhgc,bchd->bqhgd", p, v_j)
        m = m_new
    return o, m, l


def _normalize(o, m, l, dtype):
    return (o / l.clamp_min(1e-30)[..., None]).to(dtype)


def _arange_pos(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_fwd(q, k, v, q_pos, kv_pos, kv_valid, causal: bool, window: int,
              chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: (out [B, Sq, Hq, D] in q's dtype, lse [B, Sq, Hq]
    f32 = m + log(max(l, 1e-30)) of the scaled scores)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = _group_q(q, hkv) * (d ** -0.5)
    o, m, l = _flash_core(qg, k, v, q_pos, kv_pos, kv_valid,
                          causal=causal, window=window, chunk=chunk)
    out = _normalize(o, m, l, q.dtype).reshape(b, sq, hq, d)
    return out, (m + torch.log(l.clamp_min(1e-30))).reshape(b, sq, hq)


def flash_bwd(q, k, v, q_pos, kv_pos, kv_valid, out, lse, do, causal: bool,
              window: int, chunk: int):
    """(dq, dk, dv) of full attention, each in its input's dtype: the JAX
    op's ``_flash_bwd``. Per key chunk, in f32: p = exp(s - lse) under the
    forward's masks, dv += p^T do, ds = p (do v^T - delta) with delta =
    rowsum(out * do), dq += ds k, dk += ds^T q; dq is scaled at the end.
    q is scaled in its own dtype first, as in the forward."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qg = (_group_q(q, hkv) * scale).float()                # [B,Sq,Hkv,G,D]
    dog = _group_q(do, hkv).float()
    delta = (_group_q(out, hkv).float() * dog).sum(-1)     # [B,Sq,Hkv,G]
    lse = lse.reshape(b, sq, hkv, g)[..., None]
    ck = min(chunk, sk)
    while sk % ck:
        ck -= 1
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for c0 in range(0, sk, ck):
        k_j = k[:, c0:c0 + ck].float()
        v_j = v[:, c0:c0 + ck].float()
        p_j = kv_pos[:, c0:c0 + ck]
        mask = kv_valid[:, c0:c0 + ck][:, None, :]        # [B, 1, chunk]
        if causal:
            mask = mask & (p_j[:, None, :] <= q_pos[:, :, None])
        if window > 0:
            mask = mask & (q_pos[:, :, None] - p_j[:, None, :] < window)
        s = torch.einsum("bqhgd,bchd->bqhgc", qg, k_j)
        p = s.masked_fill_(~mask[:, :, None, None, :], NEG_INF) \
            .sub_(lse).exp_()
        dvs.append(torch.einsum("bqhgc,bqhgd->bchd", p, dog))
        ds = torch.einsum("bqhgd,bchd->bqhgc", dog, v_j) \
            .sub_(delta[..., None]).mul_(p)
        del p
        dq += torch.einsum("bqhgc,bchd->bqhgd", ds, k_j)
        dks.append(torch.einsum("bqhgc,bqhgd->bchd", ds, qg))
    dq = (dq * scale).reshape(b, sq, hq, d).to(q.dtype)
    return (dq, torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Full attention with the JAX op's custom VJP. ``fwd(q, k, v, q_pos,
    kv_pos, kv_valid, causal, window, chunk)`` returns (out, lse):
    ``flash_fwd`` on the CPU, the CUDA kernel on the card. The backward is
    ``flash_bwd`` on either."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, kv_valid, causal, window,
                chunk, fwd):
        out, lse = fwd(q, k, v, q_pos, kv_pos, kv_valid, causal, window,
                       chunk)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, kv_valid, out, lse)
        ctx.opts = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = flash_bwd(*ctx.saved_tensors, do, *ctx.opts)
        return (dq, dk, dv) + (None,) * 7


def _positions(q, k, q_pos, kv_pos, kv_valid):
    """The given positions and validity, or arange and every key valid."""
    b, sq = q.shape[:2]
    sk = k.shape[1]
    if q_pos is None:
        q_pos = _arange_pos(b, sq, q.device)
    if kv_pos is None:
        kv_pos = _arange_pos(b, sk, q.device)
    if kv_valid is None:
        kv_valid = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    return q_pos, kv_pos, kv_valid


def flash_attention_fn(fwd, q, k, v, q_pos=None, kv_pos=None, kv_valid=None,
                       *, causal: bool = True, window: int = 0,
                       chunk: int = 512) -> torch.Tensor:
    """``FlashAttention`` with ``fwd`` as its forward."""
    return FlashAttention.apply(
        q, k, v, *_positions(q, k, q_pos, kv_pos, kv_valid), causal, window,
        chunk, fwd)


def flash_attention(q, k, v, q_pos: Optional[torch.Tensor] = None,
                    kv_pos: Optional[torch.Tensor] = None,
                    kv_valid: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: int = 0,
                    chunk: int = 512) -> torch.Tensor:
    """Full (train/prefill) attention. q [B,Sq,Hq,D] -> [B,Sq,Hq,D].
    Differentiable through ``FlashAttention`` when an input needs a
    gradient; otherwise the forward alone."""
    if needs_grad(q, k, v):
        return flash_attention_fn(flash_fwd, q, k, v, q_pos, kv_pos,
                                  kv_valid, causal=causal, window=window,
                                  chunk=chunk)
    return flash_fwd(q, k, v, *_positions(q, k, q_pos, kv_pos, kv_valid),
                     causal, window, chunk)[0]


def decode_attention(q, k_cache, v_cache, q_pos, kv_pos, kv_valid, *,
                     causal: bool = True, window: int = 0,
                     chunk: int = 1024) -> torch.Tensor:
    """Single-token decode attention: q [B, Hq, D] -> [B, Hq, D]."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    qg = _group_q(q[:, None], hkv) * (d ** -0.5)
    o, m, l = _flash_core(qg, k_cache, v_cache, q_pos[:, None], kv_pos,
                          kv_valid, causal=causal, window=window, chunk=chunk)
    return _normalize(o, m, l, q.dtype).reshape(b, 1, hq, d)[:, 0]


def decode_attention_partial(q, k_cache, v_cache, q_pos, kv_pos, kv_valid, *,
                             window: int = 0, chunk: int = 1024):
    """Decode attention returning unnormalized (o, m, l) for LSE-combining:
    o [B, 1, Hkv, G, D], m and l [B, 1, Hkv, G], all f32."""
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    qg = _group_q(q[:, None], hkv) * (d ** -0.5)
    return _flash_core(qg, k_cache, v_cache, q_pos[:, None], kv_pos, kv_valid,
                       causal=True, window=window, chunk=chunk)


def lse_combine(o, m, l, group):
    """Combine per-rank (o, m, l) partials over the process group
    ``group``: the cross-rank step of distributed flash-decode. One
    all-reduce (MAX) of m, then one (SUM) of l and o, each rescaled by
    exp(m - max m) (the two sums travel as one tensor)."""
    m_g = all_max(m, group, "decode_combine")
    scale = torch.exp(m - m_g)
    ol = torch.cat([o * scale[..., None], (l * scale)[..., None]], dim=-1)
    ol = all_sum(ol, group, "decode_combine")
    return ol[..., :-1], m_g, ol[..., -1]


def distributed_decode_attention(mesh, kv_axes, q, k_cache, v_cache, q_pos,
                                 kv_pos, kv_valid, *, window: int = 0,
                                 chunk: int = 1024):
    """Flash-decode with the KV sequence split over ``kv_axes`` of the
    ``DeviceMesh`` ``mesh``: each rank attends over its own contiguous
    slice of the cache (``k_cache``/``v_cache`` [b, Sk_local, Hkv, D],
    ``kv_pos``/``kv_valid`` [b, Sk_local]) and the partials are
    LSE-combined over the ranks of ``kv_axes``. q [b, Hq, D] and q_pos [b]
    are this rank's rows: all of the batch, or its block where the caller
    splits the batch over other axes (the reference's ``batch_axes``),
    which enter no collective here. Returns [b, Hq, D] in q's dtype, the
    same on every rank of the group. This is what makes global_batch=1 x
    500k-context decode shardable."""
    o, m, l = decode_attention_partial(q, k_cache, v_cache, q_pos, kv_pos,
                                       kv_valid, window=window, chunk=chunk)
    o, m, l = lse_combine(o, m, l, mesh_group(mesh, kv_axes))
    b, hq, d = q.shape
    return _normalize(o, m, l, q.dtype).reshape(b, hq, d)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pool [P, page, H, D], page_table [B, N] -> [B, N*page, H, D]."""
    b, n = page_table.shape
    _, page, h, d = pool.shape
    return pool[page_table.long()].reshape(b, n * page, h, d)


def paged_decode_attention(q, k_pool, v_pool, page_table, context_lens, *,
                           window: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Paged decode attention: the plain version of the CUDA kernel."""
    b = q.shape[0]
    page = k_pool.shape[1]
    n = page_table.shape[1]
    k = paged_gather(k_pool, page_table)
    v = paged_gather(v_pool, page_table)
    kv_pos = _arange_pos(b, n * page, q.device)
    kv_valid = kv_pos < context_lens[:, None]
    q_pos = (context_lens - 1).clamp_min(0)
    return decode_attention(q, k, v, q_pos, kv_pos, kv_valid,
                            window=window, chunk=min(chunk, n * page))


def paged_prefill_attention(q, k_pool, v_pool, page_table, q_start,
                            context_lens, *, window: int = 0,
                            chunk: int = 1024) -> torch.Tensor:
    """Chunked-prefill attention over a paged pool: the plain version of
    the CUDA kernel. The chunk's own K/V are already in the pool, so each
    query at ``q_start + i`` attends causally over everything its
    sequence's pages hold below ``context_lens``."""
    b, sq = q.shape[0], q.shape[1]
    page = k_pool.shape[1]
    n = page_table.shape[1]
    k = paged_gather(k_pool, page_table)
    v = paged_gather(v_pool, page_table)
    q_pos = q_start[:, None] + torch.arange(
        sq, dtype=torch.int32, device=q.device)[None]
    kv_pos = _arange_pos(b, n * page, q.device)
    kv_valid = kv_pos < context_lens[:, None]
    return flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                           kv_valid=kv_valid, causal=True, window=window,
                           chunk=min(chunk, n * page))
