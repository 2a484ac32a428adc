"""Dispatcher for paged attention (decode + chunked prefill): CUDA tensors
launch the hand-written kernel (or the wrapper raises), CPU tensors take the
plain PyTorch version. Nothing falls back from one to the other."""
from __future__ import annotations

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_ref, paged_prefill_attention_ref,
)
from repro_torch.kernels.placement import on_cuda


def paged_decode_attention(q, k_pool, v_pool, page_table, context_lens, *,
                           window: int = 0):
    if on_cuda(q, k_pool, v_pool, page_table, context_lens):
        return kernel.paged_decode_attention(
            q, k_pool, v_pool, page_table, context_lens, window=window)
    return paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                      context_lens, window=window)


def paged_prefill_attention(q, k_pool, v_pool, page_table, q_start,
                            context_lens, *, window: int = 0):
    """Prefill-chunk queries attend over the paged pool (previously
    scattered context + the in-chunk causal block, position-offset)."""
    if on_cuda(q, k_pool, v_pool, page_table, q_start, context_lens):
        return kernel.paged_prefill_attention(
            q, k_pool, v_pool, page_table, q_start, context_lens,
            window=window)
    return paged_prefill_attention_ref(q, k_pool, v_pool, page_table,
                                       q_start, context_lens, window=window)
