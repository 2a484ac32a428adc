"""Training step: loss -> grads (remat + optional microbatch accumulation)
-> clip -> optimizer, as ``repro.training.train_step``.

Params are a tree of tensors (nested dicts and tuples). The step takes the
gradients of ``Model.train_loss`` with ``torch.autograd.grad`` with respect
to detached views of the leaves (the caller's tensors never require grad)
and rebuilds the gradient tree, as the JAX step gets it from
``jax.value_and_grad``. The optimizer then updates params and state in
place (``training.optimizer``).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.registry import Model
from repro_torch.training.optimizer import Optimizer


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """(f32 gradients scaled to at most ``max_norm`` in global norm, the
    norm before clipping), as the reference returns them. The list of
    leaves is clipped in place, each entry replaced by its f32 copy, so
    only one leaf is held twice at a time."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for i, g in enumerate(grads):
        grads[i] = g.float() * scale
    return grads, norm


def _unflatten(like, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_train_step(model: Model, opt: Optimizer, *,
                    remat_policy: str = "dots_saveable",
                    microbatches: int = 1, grad_clip: float = 1.0):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}). With microbatches > 1 the batch's leading dim
    is split and the gradients of the microbatches are summed in f32, then
    scaled by 1/n (sequential: memory, not speed)."""

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = _unflatten(params, leaves)

        def value_and_grad(b):
            loss = model.train_loss(tree, b, remat_policy=remat_policy)
            # a leaf the loss does not reach gets zeros, as in JAX
            return loss.detach(), list(torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True))

        if microbatches == 1:
            return value_and_grad(batch)
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        n = b // microbatches
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, g = value_and_grad(mb)
            loss = loss + l
            for a, x in zip(acc, g):
                a += x.float()
            del g
        inv = 1.0 / microbatches
        return loss * inv, [a.mul_(inv) for a in acc]

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        params, opt_state = opt.update(_unflatten(params, grads), opt_state,
                                       params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
