"""Dispatcher for flash attention: CUDA tensors launch the hand-written
kernel (or the wrapper raises), CPU tensors take the plain PyTorch version.
Nothing falls back from one to the other. Where an input needs a gradient,
both go through ``attention_ops.FlashAttention``, whose forward is then the
kernel with its log-sum-exp output (or the plain forward) and whose
backward is the plain chunked recompute on either device."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.placement import on_cuda
from repro_torch.models.attention_ops import flash_attention_fn, needs_grad


def _kernel_fwd(q, k, v, q_pos, kv_pos, kv_valid, causal, window, chunk):
    """``FlashAttention``'s forward on the card: the kernel's (out, lse).
    The kernel takes the positions to be arange and every key valid, which
    is what ``flash_attention`` below passes."""
    return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                  lse=True)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    if on_cuda(q, k, v):
        if needs_grad(q, k, v):
            return flash_attention_fn(_kernel_fwd, q, k, v, causal=causal,
                                      window=window)
        return kernel.flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
