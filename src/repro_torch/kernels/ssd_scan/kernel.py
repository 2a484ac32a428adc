"""Wrapper of the CUDA SSD-scan kernel (``csrc/ssd_scan.cu``): check the
inputs, allocate the outputs and the scratch (the chunks' scores and
decayed queries, the states entering each chunk), launch on PyTorch's current
stream, count the launch, and raise on an error code. CUDA tensors only;
``ops.py`` sends CPU tensors to the plain version instead."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.kernel import _DTYPE_CODES, _check_cuda

CHUNK = 64        # tokens per chunk of the kernel (L in csrc/ssd_scan.cu)
TILE = 64         # value columns per block (TILE in csrc/ssd_scan.cu)
MAX_DK = 2048     # the largest key width the wrapper takes


def scratch_shapes(b: int, t: int, h: int, dk: int, dv: int) -> dict:
    """The f32 scratch one call needs: each chunk's scores and decayed
    queries (both transposed), and the state entering each chunk after the
    first, its value columns padded to whole 64-column tiles (one slot when
    T fits one chunk, never read)."""
    nc = -(-t // CHUNK)
    return {"scores": (b, h, nc, CHUNK, CHUNK), "qt": (b, h, nc, dk, CHUNK),
            "states": (b, h, max(nc - 1, 1), dk, -(-dv // TILE) * TILE)}


def ssd_scan(q, k, v, log_a):
    """q, k [B, T, H, dk] (f32 or bf16, one type); v [B, T, H, dv] and
    log_a [B, T, H] f32 -> (y [B, T, H, dv] f32, final_state [B, H, dk, dv]
    f32)."""
    name = "ssd_scan"
    _check_cuda(name, q=q, k=k, v=v, log_a=log_a)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != torch.float32 or log_a.dtype != torch.float32:
        raise TypeError(f"{name}: q/k must be float32 or bfloat16 alike, v "
                        f"and log_a float32; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {log_a.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4:
        raise ValueError(f"{name}: q/k [B,T,H,dk] and v [B,T,H,dv] expected")
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if tuple(v.shape[:3]) != (b, t, h) or tuple(log_a.shape) != (b, t, h):
        raise ValueError(f"{name}: q {tuple(q.shape)}, v {tuple(v.shape)}, "
                         f"log_a {tuple(log_a.shape)} disagree")
    if t < 1 or dk < 1 or dv < 1 or dk > MAX_DK:
        raise ValueError(f"{name}: need T, dk, dv >= 1 and dk <= {MAX_DK}")
    f32 = dict(dtype=torch.float32, device=q.device)
    y = torch.empty((b, t, h, dv), **f32)
    final = torch.empty((b, h, dk, dv), **f32)
    scratch = {key: torch.empty(shape, **f32)
               for key, shape in scratch_shapes(b, t, h, dk, dv).items()}
    err = build.load().rt_ssd_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
        y.data_ptr(), final.data_ptr(), scratch["scores"].data_ptr(),
        scratch["qt"].data_ptr(), scratch["states"].data_ptr(),
        b, t, h, dk, dv, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
