"""Dispatcher for the chunked SSD scan: CUDA tensors launch the
hand-written kernel (or the wrapper raises), CPU tensors take the plain
PyTorch version. Nothing falls back from one to the other."""
from __future__ import annotations

from repro_torch.kernels.placement import on_cuda
from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def ssd_scan(q, k, v, log_a, *, chunk: int = 128):
    """Returns (y [B, T, H, dv] f32, final_state [B, H, dk, dv] f32).
    ``chunk`` is the plain version's chunk request (shrunk to a divisor of
    T, as in the JAX package); the kernel uses its own fixed tile and
    masks the ragged last chunk."""
    if on_cuda(q, k, v, log_a):
        return kernel.ssd_scan(q, k, v, log_a)
    return ssd_scan_ref(q, k, v, log_a, chunk=chunk)
