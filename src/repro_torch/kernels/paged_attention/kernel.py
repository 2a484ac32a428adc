"""Wrappers of the CUDA paged attention kernels (``csrc/paged_decode.cu``,
``csrc/paged_prefill.cu``): check the inputs, allocate the output, launch on
PyTorch's current stream, count the launch, and raise on an error code.

They take CUDA tensors only; ``ops.py`` sends CPU tensors to the plain
versions instead.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

# the split-KV plan of csrc/paged_decode.cu
DECODE_KEY_TILE = 32              # keys a tile of the kernel's ring
SM_COUNT = 132                    # H100 SXM
DECODE_SPLIT_BYTES = 128 * 1024   # bf16 K and V one split reads at most
DECODE_MAX_SPLITS = 1024          # the combine launch's bound


def decode_split_plan(b: int, hkv: int, n: int, page: int,
                      d: int) -> tuple:
    """(splits, keys per split) of the paged decode kernel for a page table
    of ``n`` pages of ``page`` slots: runs of whole key tiles and whole
    pages that cover the ``n * page`` slots once, enough of them that the
    grid holds two blocks per SM (``b * hkv`` blocks a split) where the
    table is wide enough, and none longer than ``DECODE_SPLIT_BYTES`` of
    bf16 K and V at head dim ``d`` unless that takes more than
    ``DECODE_MAX_SPLITS`` splits. It reads no context length and no pool
    size, so a call plans the same grid whatever the pool holds."""
    keys = n * page
    unit = math.lcm(DECODE_KEY_TILE, page)
    if keys == 0:
        return 1, unit
    cap = max(unit, DECODE_SPLIT_BYTES // (4 * d) // unit * unit)
    splits = max(-(-2 * SM_COUNT // max(1, b * hkv)), -(-keys // cap))
    splits = min(splits, -(-keys // unit), DECODE_MAX_SPLITS)
    per = -(-keys // splits)
    per = -(-per // unit) * unit
    return -(-keys // per), per


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


def _check_head_dim(name, d, dtype, *bufs):
    """The kernels move K/V in 16-byte chunks (flash: Q/K/V in TMA tiles):
    D must be a multiple of one chunk's elements and the buffers 16-byte
    aligned."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if d > MAX_HEAD_DIM or d % vec:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of {vec} "
                         f"and at most {MAX_HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in bufs):
        raise ValueError(f"{name}: Q/K/V buffers must be 16-byte aligned")


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
    _check_head_dim(name, d, q.dtype, q, k_pool, v_pool)


def _check_int(name, arg, t, shape):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} must be int32 {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def paged_decode_attention(q, k_pool, v_pool, page_table, context_lens, *,
                           window: int = 0) -> torch.Tensor:
    """q [B, Hq, D]; pools [P, page, Hkv, D]; page_table [B, N] int32;
    context_lens [B] int32 -> [B, Hq, D] in q's dtype. Page-table entries
    below a row's context must lie in [0, P): the kernel does not check
    them (that would cost a device synchronisation per call). Two launches
    (the splits, then their combine; one where the plan has one split)
    count as one."""
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
    splits, split_keys = decode_split_plan(b, hkv, n, page, d)
    out = torch.empty_like(q)
    # f32 partials (o[D], m, l) of each (sequence, query head, split)
    part = (torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    err = build.load().rt_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(),
        b, hq, hkv, d, page, n, int(window), splits, split_keys,
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_prefill_attention(q, k_pool, v_pool, page_table, q_start,
                            context_lens, *, window: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, D]; pools [P, page, Hkv, D]; page_table [B, N] int32;
    q_start, context_lens [B] int32 -> [B, Sq, Hq, D] in q's dtype. The
    bf16 kernel reads the pools through TMA tensor maps, encoded on the
    host for each call, where page % 16 == 0."""
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
        out.data_ptr(), b, sq, hq, hkv, d, page, n, k_pool.shape[0],
        int(window),
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
