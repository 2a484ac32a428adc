"""Dispatcher for flash attention: CUDA tensors launch the hand-written
kernel (or the wrapper raises), CPU tensors take the plain PyTorch version.
Nothing falls back from one to the other."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.placement import on_cuda


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    if on_cuda(q, k, v):
        return kernel.flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
