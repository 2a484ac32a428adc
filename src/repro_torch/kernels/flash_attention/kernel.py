"""Wrapper of the CUDA flash attention kernel (``csrc/flash_attention.cu``):
check the inputs, allocate the output, launch on PyTorch's current stream,
count the launch, and raise on an error code. CUDA tensors only; ``ops.py``
sends CPU tensors to the plain version instead. The bf16 kernel reads Q, K
and V through TMA tensor maps, encoded on the host for each call: every
buffer must be 16-byte aligned."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.kernel import (
    _DTYPE_CODES, _check_cuda, _check_head_dim,
)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    lse: bool = False):
    """q [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D] -> out [B, Sq, Hq, D]; with
    ``lse``, (out, lse [B, Sq, Hq] f32): each row's log-sum-exp of its
    scaled scores, which the backward pass needs (serving asks for none,
    and the kernel then writes none)."""
    name = "flash_attention"
    _check_cuda(name, q=q, k=k, v=v)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must all be float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D] expected")
    b, sq, hq, d = q.shape
    bk, sk, hkv, dk = k.shape
    if bk != b or dk != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    _check_head_dim(name, d, q.dtype, q, k, v)
    out = torch.empty_like(q)
    lse_out = torch.empty((b, sq, hq), dtype=torch.float32,
                          device=q.device) if lse else None
    err = build.load().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse_out is None else lse_out.data_ptr(),
        b, sq, sk, hq, hkv, d, int(bool(causal)), int(window),
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    flash_attention.launches += 1
    return out if lse_out is None else (out, lse_out)


flash_attention.launches = 0


def encode_ns(q, k, v, reps: int = 1000) -> float:
    """Host nanoseconds one bf16 call spends encoding its three tensor maps
    (the mean over ``reps`` encodings; nothing is launched)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    ns = build.load().rt_flash_encode_ns(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), b, sq, sk, hq, hkv, d, reps)
    if ns < 0:
        raise RuntimeError("flash_attention: the driver refused a tensor map")
    return ns
