"""Parameter specs: one tree of ``Spec`` drives shapes, byte counts and
initialisation (PyTorch counterpart of ``repro.models.common``).

A spec tree is nested dicts and tuples with ``Spec`` leaves, the same
structure as the JAX package's parameter pytree, so the port's params are
plain nested dicts/tuples of tensors in the JAX layout.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
    "int32": torch.int32,
}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declarative parameter: shape + logical axes + init."""
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # normal | zeros | ones | small_normal
    fan_in: int = 0               # for scaled init; 0 -> shape[0] heuristic

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)

    def local_shape(self, mesh, rules=None) -> Tuple[int, ...]:
        """The shape of a rank's block of this parameter on ``mesh``."""
        return _sharding(self, mesh, rules).local_shape(self.shape)

    @property
    def scale(self) -> float:
        fan = self.fan_in or (self.shape[-2] if len(self.shape) >= 2
                              else self.shape[-1])
        s = 1.0 / math.sqrt(max(fan, 1))
        return s * 0.1 if self.init == "small_normal" else s

    def materialize(self, generator: torch.Generator,
                    device) -> torch.Tensor:
        """Draw the tensor on ``device``. Normal inits are drawn in f32 in
        flat chunks of at most ``_CHUNK`` values, so a full-width stacked
        weight never needs an f32 copy of the whole stack."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "neg_ones":
            return torch.full(self.shape, -1, dtype=self.dtype, device=device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        flat = out.view(-1)
        for lo in range(0, flat.numel(), _CHUNK):
            hi = min(lo + _CHUNK, flat.numel())
            x = torch.randn(hi - lo, generator=generator,
                            dtype=torch.float32, device=device)
            flat[lo:hi].copy_(x.mul_(self.scale))
        return out


_CHUNK = 1 << 26


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Map over the leaves of nested dicts/tuples/lists (``rest`` trees
    share the first tree's structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_init(specs, generator: torch.Generator, device) -> Any:
    """Materialize a Spec tree into a param tree, leaf by leaf in tree
    order from one generator."""
    return tree_map(lambda s: s.materialize(generator, device), specs)


def _sharding(spec: Spec, mesh, rules=None):
    from repro_torch.distributed.sharding import (
        NamedSharding, get_rules, spec_for,
    )
    return NamedSharding(mesh, spec_for(spec.logical, spec.shape, mesh,
                                        rules or get_rules()))


def tree_shardings(specs, mesh, rules=None) -> Any:
    """The ``NamedSharding`` of each leaf of a Spec tree on ``mesh`` under
    ``rules`` (default: the ambient mesh context's), with the divisibility
    fallback of ``spec_for``."""
    return tree_map(lambda s: _sharding(s, mesh, rules), specs)


def tree_bytes(specs) -> int:
    return sum(int(np.prod(s.shape)) * itemsize(s.dtype)
               for s in tree_leaves(specs))


def stack_specs(spec_tree, n: int, stack_logical: str = "stack"):
    """Prepend a stacked-layer dim of size n to every Spec in a tree."""
    return tree_map(lambda s: Spec((n,) + s.shape, (stack_logical,) + s.logical,
                                   s.dtype, s.init, s.fan_in), spec_tree)


# the products "dots_saveable" keeps: the outputs of every matrix product
# (einsum and matmul reach these), as ``jax.checkpoint_policies.
# checkpoint_dots`` keeps every dot_general's
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: Optional[str]) -> Callable:
    """``fn`` under a rematerialisation policy, as ``jax.checkpoint`` wraps
    the JAX model's scan bodies: None or "none" keeps every activation for
    the backward pass; "full" keeps only ``fn``'s inputs and recomputes the
    rest; "dots_saveable" also keeps the matrix products' outputs. A call
    whose tensor arguments need no gradient (inference) runs ``fn`` as it
    is. A custom autograd Function inside ``fn`` runs its forward again in
    the recompute (the flash and SSD kernels launch again there). Nothing
    in a step draws a random number, so the checkpoints keep no RNG state
    (``preserve_rng_state=False``: reading every device's generator state
    on each call is a host call that a CUDA graph capture may refuse)."""
    if policy in (None, "none"):
        return fn
    if policy == "full":
        ctx_fn = None
    elif policy == "dots_saveable":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _save_dots)
    else:
        raise ValueError(f"unknown remat policy {policy!r} (none, full, "
                         "dots_saveable)")

    def wrapped(*args):
        if not torch.is_grad_enabled() or not any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in tree_leaves(args)):
            return fn(*args)
        if ctx_fn is None:
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=ctx_fn)
    return wrapped
