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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def flash_attention(q, k, v, q_pos: Optional[torch.Tensor] = None,
                    kv_pos: Optional[torch.Tensor] = None,
                    kv_valid: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: int = 0,
                    chunk: int = 512) -> torch.Tensor:
    """Full (prefill) attention. q [B,Sq,Hq,D] -> [B,Sq,Hq,D]. Forward
    only: the custom VJP of the JAX op waits for the training slice."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q_pos is None:
        q_pos = _arange_pos(b, sq, q.device)
    if kv_pos is None:
        kv_pos = _arange_pos(b, sk, q.device)
    if kv_valid is None:
        kv_valid = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    qg = _group_q(q, hkv) * (d ** -0.5)
    o, m, l = _flash_core(qg, k, v, q_pos, kv_pos, kv_valid,
                          causal=causal, window=window, chunk=chunk)
    return _normalize(o, m, l, q.dtype).reshape(b, sq, hq, d)


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
