"""Wrappers of the CUDA paged attention kernels (``csrc/paged_decode.cu``,
``csrc/paged_prefill.cu``): check the inputs, allocate the output, launch on
PyTorch's current stream, count the launch, and raise on an error code.

They take CUDA tensors only; ``ops.py`` sends CPU tensors to the plain
versions instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _check_cuda(name, **tensors):
    dev = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    return dev


def _check_head_dim(name, d, dtype, *kv):
    """The kernels move K/V in 16-byte chunks: D must be a multiple of one
    chunk's elements and the K/V buffers 16-byte aligned."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if d > MAX_HEAD_DIM or d % vec:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of {vec} "
                         f"and at most {MAX_HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in kv):
        raise ValueError(f"{name}: K/V buffers must be 16-byte aligned")


def _check_kv(name, q, k_pool, v_pool, hq, d):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} is not float32 or bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: q, k_pool and v_pool must share a dtype")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pools must be [P, page, Hkv, D] alike")
    _, _, hkv, dk = k_pool.shape
    if dk != d or hq % hkv:
        raise ValueError(f"{name}: head dims q {hq}x{d}, pool {hkv}x{dk}")
    _check_head_dim(name, d, q.dtype, k_pool, v_pool)


def _check_int(name, arg, t, shape):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} must be int32 {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def paged_decode_attention(q, k_pool, v_pool, page_table, context_lens, *,
                           window: int = 0) -> torch.Tensor:
    """q [B, Hq, D]; pools [P, page, Hkv, D]; page_table [B, N] int32;
    context_lens [B] int32 -> [B, Hq, D] in q's dtype. Page-table entries
    below a row's context must lie in [0, P): the kernel does not check
    them (that would cost a device synchronisation per call)."""
    name = "paged_decode_attention"
    _check_cuda(name, q=q, k_pool=k_pool, v_pool=v_pool,
                page_table=page_table, context_lens=context_lens)
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [B, Hq, D]")
    b, hq, d = q.shape
    _check_kv(name, q, k_pool, v_pool, hq, d)
    _, page, hkv, _ = k_pool.shape
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"{name}: page_table must be [B, N]")
    n = page_table.shape[1]
    _check_int(name, "page_table", page_table, (b, n))
    _check_int(name, "context_lens", context_lens, (b,))
    out = torch.empty_like(q)
    err = build.load().rt_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, page, n, int(window), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_prefill_attention(q, k_pool, v_pool, page_table, q_start,
                            context_lens, *, window: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, D]; pools [P, page, Hkv, D]; page_table [B, N] int32;
    q_start, context_lens [B] int32 -> [B, Sq, Hq, D] in q's dtype."""
    name = "paged_prefill_attention"
    _check_cuda(name, q=q, k_pool=k_pool, v_pool=v_pool,
                page_table=page_table, q_start=q_start,
                context_lens=context_lens)
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, Sq, Hq, D]")
    b, sq, hq, d = q.shape
    _check_kv(name, q, k_pool, v_pool, hq, d)
    _, page, hkv, _ = k_pool.shape
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"{name}: page_table must be [B, N]")
    n = page_table.shape[1]
    _check_int(name, "page_table", page_table, (b, n))
    _check_int(name, "q_start", q_start, (b,))
    _check_int(name, "context_lens", context_lens, (b,))
    out = torch.empty_like(q)
    err = build.load().rt_paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), q_start.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), b, sq, hq, hkv, d, page, n, int(window),
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
