"""Training step: loss -> grads (remat + optional microbatch accumulation)
-> clip -> optimizer, as ``repro.training.train_step``.

Params are a tree of tensors (nested dicts and tuples). The step takes the
gradients of ``Model.train_loss`` with ``torch.autograd.grad`` with respect
to detached views of the leaves (the caller's tensors never require grad)
and rebuilds the gradient tree, as the JAX step gets it from
``jax.value_and_grad``. The optimizer then updates params and state in
place (``training.optimizer``).

Built inside a ``mesh_context``, the step trains the rank's blocks
(``Model.init(mesh=)``) on the rank's rows of each batch, as the JAX step
under ``jax.jit`` and the same mesh: autograd through the collectives of
``distributed.collectives`` leaves each block's gradient summed over the
axes its weight is split on; the gradient of a leaf that stays whole on
some data axis is summed over that axis here; the global norm sums each
leaf's squares over the axes that split it, a replicated leaf once.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.distributed.collectives import sum_over
from repro_torch.distributed.sharding import (
    batch_axis_names, get_mesh, get_rules, mesh_context,
)
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.registry import Model
from repro_torch.training.optimizer import Optimizer


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32. With
    ``shardings`` (one ``NamedSharding`` per leaf, ``tree`` the rank's
    blocks) the squares of the leaves split over the same axes are summed
    over those axes in one all-reduce; a replicated leaf counts once."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    by_axes = {}
    for x, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        key = (sh.split_axes(), sh.mesh)
        by_axes[key] = by_axes.get(key, 0) + torch.sum(
            torch.square(x.float()))
    return torch.sqrt(sum(sum_over(sq, mesh, axes, "norm_all_reduce")
                          for (axes, mesh), sq in by_axes.items()))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        shardings=None):
    """(f32 gradients scaled to at most ``max_norm`` in global norm, the
    norm before clipping), as the reference returns them. The list of
    leaves is clipped in place, each entry replaced by its f32 copy, so
    only one leaf is held twice at a time."""
    norm = global_norm(grads, shardings)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for i, g in enumerate(grads):
        grads[i] = g.float() * scale
    return grads, norm


def _unflatten(like, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_train_step(model: Model, opt: Optimizer, *,
                    remat_policy: str = "dots_saveable",
                    microbatches: int = 1, grad_clip: float = 1.0,
                    batch_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}). With microbatches > 1 the batch's leading dim
    is split and the gradients of the microbatches are summed in f32, then
    scaled by 1/n (sequential: memory, not speed). Inside a
    ``mesh_context`` the step runs on that mesh and rules (the
    microbatches divide the rank's rows); ``batch_shardings`` (the batch's
    ``launch.shardings.batch_shardings``) goes to ``Model.train_loss``,
    where an enc-dec config over a mesh needs it."""
    mesh, rules = get_mesh(), get_rules()
    shardings = None
    if mesh is not None:
        shardings = model.param_shardings(mesh, rules)
        sh_leaves = tree_leaves(shardings)

    def sum_replicated(grads):
        """Each gradient summed over the data axes its leaf is not split
        on (the reduce-scatter of its gather summed it over the others)."""
        data = batch_axis_names(mesh)
        for i, sh in enumerate(sh_leaves):
            split = sh.split_axes()
            grads[i] = sum_over(grads[i], mesh,
                                [ax for ax in data if ax not in split],
                                "grad_all_reduce")
        return grads

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = _unflatten(params, leaves)

        def value_and_grad(b):
            loss = model.train_loss(tree, b, remat_policy=remat_policy,
                                    batch_shardings=batch_shardings)
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
        if mesh is None:
            loss, grads = grads_of(params, batch)
        else:
            with mesh_context(mesh, rules):
                loss, grads = grads_of(params, batch)
            grads = sum_replicated(grads)
        grads, gnorm = clip_by_global_norm(grads, grad_clip, shardings)
        extra = () if shardings is None else (shardings,)
        params, opt_state = opt.update(_unflatten(params, grads), opt_state,
                                       params, *extra)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    # what ``training.train_graph`` keys a captured step by, and refuses
    train_step.microbatches = microbatches
    train_step.remat_policy = remat_policy
    train_step.mesh = mesh
    return train_step
