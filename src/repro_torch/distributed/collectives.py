"""The collectives of mesh training, written out (what XLA's SPMD
partitioner inserts into the JAX package's program under a mesh).

Each is a ``torch.autograd.Function`` over a process group of a
``DeviceMesh`` (``sharding.mesh_group``):

  * ``fsdp_gather``: a weight's FSDP/ZeRO-3 blocks all-gathered where it is
    used (forward), its gradient reduce-scattered back to the blocks
    (backward);
  * ``copy_to_region``: Megatron's *copy to the tensor-parallel region*,
    identity forward, all-reduce of the gradient backward (an activation
    that enters column-parallel products, or a model-replicated weight that
    each rank uses only in part);
  * ``reduce_from_region``: Megatron's *reduce from the tensor-parallel
    region*, all-reduce forward, identity backward (the partial sums of a
    row-parallel product, the vocab-parallel lookup and cross-entropy
    terms, and the loss's sums over the data axes);
  * ``tp_gather``: a weight's tensor-parallel blocks all-gathered whole
    (forward), its gradient reduce-scattered back (backward): for a leaf
    whose stored blocks are not the columns a rank computes with (Mamba's
    ``in_proj``, whose x and z halves each split over the heads);
  * ``max_over``, ``sum_over`` and ``gather_over``, outside autograd (the
    cross-entropy's max; the mask count, squared norms, gradient and
    optimizer sums; the MoE's per-expert counts of each data rank).

Every call counts the bytes of the tensor it reduces or produces on this
rank, by kind (``counts``): an all-gather the gathered tensor, an
all-reduce its tensor, a reduce-scatter its full input. It also counts, by
the op's name in the reference's HLO (``op_counts``: "all-reduce",
"all-gather", "reduce-scatter"), the bytes of its result on this rank, the
rule of ``repro.distributed.hlo_analysis``: a reduce-scatter counts its
rank's block, 1/n of its input (``distributed.hlo_analysis`` reads these).
The collectives run
on gloo or NCCL alike: gloo takes CUDA tensors for
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and ``all_reduce``
(SUM and MAX), as ``tools/gloo_cuda_probe.py`` shows on the H100, and moves
them through host memory. Those two tensor forms work on dim 0: a block
split along another dim is moved to the front (a copy of the rank's block)
and the result moved back as a view. Sums of bf16 tensors run in f32 and
are rounded once.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (
    Spec, axis_sizes, mesh_group, spec_axes,
)

_BYTES: Counter = Counter()
_CALLS: Counter = Counter()
# by op name: calls and result bytes
_OP_BYTES: Counter = Counter()
_OP_CALLS: Counter = Counter()


def reset_counts() -> None:
    for c in (_BYTES, _CALLS, _OP_BYTES, _OP_CALLS):
        c.clear()


def counts() -> Dict[str, Dict[str, int]]:
    """{kind: {"calls", "bytes"}} since the last ``reset_counts``."""
    return {k: {"calls": _CALLS[k], "bytes": _BYTES[k]} for k in _CALLS}


def op_counts() -> Dict[str, Dict[str, int]]:
    """{op: {"calls", "bytes"}} since the last ``reset_counts``: each
    call's result bytes on this rank, by the reference's HLO op name."""
    return {k: {"calls": _OP_CALLS[k], "bytes": _OP_BYTES[k]}
            for k in _OP_CALLS}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(kind: str, t: torch.Tensor, op: str,
           result: torch.Tensor) -> None:
    _CALLS[kind] += 1
    _BYTES[kind] += _nbytes(t)
    _OP_CALLS[op] += 1
    _OP_BYTES[op] += _nbytes(result)


def _wide(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A fresh contiguous copy to reduce into, ``dim`` moved to the front
    (the caller's tensor may be shared: autograd hands one gradient to
    both terms of a sum); half-precision sums run in f32."""
    wide = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype
    return t.movedim(dim, 0).to(wide, memory_format=torch.contiguous_format,
                                copy=True)


def all_sum(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor, in ``t``'s dtype)."""
    w = _wide(t)
    _count(kind, w, "all-reduce", w)
    dist.all_reduce(w, group=group)
    return w if w.dtype == t.dtype else w.to(t.dtype)


def all_max(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    t = t.clone(memory_format=torch.contiguous_format)
    _count(kind, t, "all-reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather_dim(x: torch.Tensor, group, dim: int,
                   kind: str) -> torch.Tensor:
    """The blocks of ``x`` over ``group``, concatenated along ``dim`` in the
    group's rank order (``all_gather_into_tensor``; a view that is not
    contiguous where ``dim`` is not 0)."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    _count(kind, out, "all-gather", out)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int,
                       kind: str) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's block along ``dim``
    (``reduce_scatter_tensor``), in ``x``'s dtype and contiguous."""
    n = dist.get_world_size(group)
    w = _wide(x, dim)
    out = w.new_empty((w.shape[0] // n,) + w.shape[1:])
    _count(kind, w, "reduce-scatter", out)
    dist.reduce_scatter_tensor(out, w, group=group)
    return out.movedim(0, dim).to(x.dtype,
                                  memory_format=torch.contiguous_format)


# the tensor-parallel axis: the blocks compute on its splits, so FSDP
# gathers every other axis of a weight and leaves this one split
TP_AXES = ("model",)


def _groups(mesh, spec: Spec, ndim: int):
    """[(dim, group)] of the dimensions that ``spec`` splits over axes
    outside ``TP_AXES``; a dimension split over both at once has no
    contiguous gathered block and is refused."""
    out = []
    for dim in range(ndim):
        axes = spec_axes(spec, dim)
        gather = tuple(ax for ax in axes if ax not in TP_AXES)
        if gather and len(gather) != len(axes):
            raise ValueError(f"dimension {dim} of spec {spec} mixes "
                             f"gathered and tensor-parallel axes")
        if gather:
            out.append((dim, mesh_group(mesh, gather)))
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, groups, kind):
        ctx.groups, ctx.kind = groups, kind
        for dim, group in groups:
            w = all_gather_dim(w, group, dim, kind + "_all_gather")
        return w

    @staticmethod
    def backward(ctx, g):
        for dim, group in reversed(ctx.groups):
            g = reduce_scatter_dim(g, group, dim, ctx.kind + "_reduce_scatter")
        return g, None, None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group, "tp_all_reduce"), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        return all_sum(x, group, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fsdp_gather(w: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """A weight's rank block ``w`` with every dimension that ``spec`` splits
    over the data axes gathered whole; the tensor-parallel splits stay
    (``w`` itself where the spec splits nothing, as with no mesh).
    Backward: the reduce-scatter."""
    groups = _groups(mesh, spec, w.dim())
    if not groups:
        return w
    return _Gather.apply(w, groups, "fsdp")


def tp_gather(w: torch.Tensor, spec: Spec, mesh, dim: int) -> torch.Tensor:
    """``w`` with dimension ``dim``, which ``spec`` splits over
    tensor-parallel axes, gathered whole (``w`` itself where it stays
    whole). Backward: the reduce-scatter, which sums the ranks' gradients
    of the whole leaf into each block."""
    axes = spec_axes(spec, dim)
    if not axes:
        return w
    return _Gather.apply(w, [(dim, mesh_group(mesh, axes))], "tp")


def _axes_group(mesh, axes: Sequence[str]):
    """The group over those of ``axes`` that split the mesh (None with no
    mesh or where none does)."""
    if mesh is None:
        return None
    sizes = axis_sizes(mesh)
    axes = tuple(ax for ax in sizes if ax in axes and sizes[ax] > 1)
    return mesh_group(mesh, axes) if axes else None


def copy_to_region(x: torch.Tensor, mesh, axes: Sequence[str]):
    group = _axes_group(mesh, axes)
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, mesh, axes: Sequence[str],
                       kind: str = "tp_all_reduce"):
    group = _axes_group(mesh, axes)
    return x if group is None else _ReduceFromRegion.apply(x, group, kind)


def sum_over(t: torch.Tensor, mesh, axes: Sequence[str],
             kind: str) -> torch.Tensor:
    """``t`` summed over ``axes`` outside autograd (``t`` itself where they
    are all of size 1)."""
    group = _axes_group(mesh, axes)
    return t if group is None else all_sum(t, group, kind)


def max_over(t: torch.Tensor, mesh, axes: Sequence[str],
             kind: str) -> torch.Tensor:
    group = _axes_group(mesh, axes)
    return t if group is None else all_max(t, group, kind)


def gather_over(t: torch.Tensor, mesh, axes: Sequence[str],
                kind: str) -> torch.Tensor:
    """[n, *t.shape]: ``t`` of each rank along ``axes``, in the order of
    ``mesh_index`` over them, outside autograd (``t[None]`` where they are
    all of size 1)."""
    group = _axes_group(mesh, axes)
    if group is None:
        return t[None]
    return all_gather_dim(t[None], group, 0, kind)
