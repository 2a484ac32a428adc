"""Parameter specs: one tree of ``Spec`` drives shapes, byte counts and
initialisation (PyTorch counterpart of ``repro.models.common``).

A spec tree is nested dicts and tuples with ``Spec`` leaves, the same
structure as the JAX package's parameter pytree, so the port's params are
plain nested dicts/tuples of tensors in the JAX layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

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


def tree_bytes(specs) -> int:
    return sum(int(np.prod(s.shape)) * itemsize(s.dtype)
               for s in tree_leaves(specs))


def stack_specs(spec_tree, n: int, stack_logical: str = "stack"):
    """Prepend a stacked-layer dim of size n to every Spec in a tree."""
    return tree_map(lambda s: Spec((n,) + s.shape, (stack_logical,) + s.logical,
                                   s.dtype, s.init, s.fan_in), spec_tree)
