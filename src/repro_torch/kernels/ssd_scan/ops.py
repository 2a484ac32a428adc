"""Dispatcher for the chunked SSD scan: CUDA tensors launch the
hand-written kernel (or the wrapper raises), CPU tensors take the plain
PyTorch version. Nothing falls back from one to the other.

Where an input needs a gradient, both go through ``SsdScan``: its forward is
the kernel (or the plain version) and keeps only the inputs; its backward
recomputes the recurrence through the plain ``ssd_chunked`` under autograd
and differentiates that, one layer at a time. That is the counterpart of
the reference's ``jax.checkpoint`` around the chunk body
(``repro/models/blocks.py:385``): no chunk's scores outlive the forward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.placement import on_cuda
from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.attention_ops import needs_grad


def _plain_fwd(q, k, v, log_a, chunk, init_state):
    return ssd_scan_ref(q, k, v, log_a, chunk=chunk, init_state=init_state)


def _kernel_fwd(q, k, v, log_a, chunk, init_state):
    """The kernel from a zero state; a given initial state S0 adds its
    decayed reads, y_t += (q_t exp(cum_t)) . S0, and exp(cum_T) S0 to the
    final state (the recurrence is linear in the state)."""
    y, final = kernel.ssd_scan(q, k, v, log_a)
    if init_state is None:
        return y, final
    cum = torch.cumsum(log_a.float(), dim=1)                 # [B, T, H]
    s0 = init_state.float()
    y = y + torch.einsum("bthk,bhkv->bthv",
                         q.float() * torch.exp(cum)[..., None], s0)
    return y, final + torch.exp(cum[:, -1])[..., None, None] * s0


class SsdScan(torch.autograd.Function):
    """(y, final_state) of the scan with the plain recompute as backward.
    ``fwd(q, k, v, log_a, chunk, init_state)`` is the kernel on the card and
    ``ssd_chunked`` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, init_state, chunk, fwd):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_a, init_state)
        ctx.chunk = chunk
        return fwd(q, k, v, log_a, chunk, init_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        from repro_torch.models.blocks import ssd_chunked
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() if n else t
                   for t, n in zip(saved, need)]
            y, final = ssd_chunked(*ins[:4], ctx.chunk, init_state=ins[4])
        outs = [(o, g) for o, g in ((y, dy), (final, dfinal))
                if g is not None]
        wrt = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(
            [o for o, _ in outs], wrt, [g for _, g in outs],
            allow_unused=True) if outs and wrt else ())
        return tuple(next(grads) if n else None for n in need) + (None, None)


def ssd_scan(q, k, v, log_a, *, chunk: int = 128, init_state=None):
    """Returns (y [B, T, H, dv] f32, final_state [B, H, dk, dv] f32).
    ``chunk`` is the plain version's chunk request (shrunk to a divisor of
    T, as in the JAX package); the kernel uses its own fixed tile and
    masks the ragged last chunk. ``init_state`` [B, H, dk, dv]: the state
    before the first token (default zero)."""
    extra = () if init_state is None else (init_state,)
    fwd = _kernel_fwd if on_cuda(q, k, v, log_a, *extra) else _plain_fwd
    if needs_grad(q, k, v, log_a, *extra):
        return SsdScan.apply(q, k, v, log_a, init_state, chunk, fwd)
    return fwd(q, k, v, log_a, chunk, init_state)
