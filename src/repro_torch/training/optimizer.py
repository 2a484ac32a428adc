"""Optimizers: AdamW (<=10B-class) and Adafactor (trillion-parameter class),
hand-rolled with the arithmetic of ``repro.training.optimizer``.

Adafactor keeps factored second moments (row/col statistics) for a leaf
whose last two axes are both at least ``min_dim_size_to_factor``, so its
state is O(d_in + d_out) per matrix. Both keep their state in f32 and give
no weight decay to leaves with ndim < 2 (norms, biases).

The update runs leaf by leaf, IN PLACE: each parameter tensor and each
moment takes its new value where it lies (the JAX functions return new
trees), and only one leaf's f32 temporaries are alive at a time. At full
width (llama3-8b: 2.8 B parameters at 8 layers) a second copy of the f32
moments would be 22 GB. ``update`` still returns the (params, state) trees,
with the same tensors in them.

Over a mesh (``shardings``: the params' ``NamedSharding`` tree) every leaf
is the rank's block. AdamW is elementwise and runs unchanged. Adafactor
factors a leaf by its full shape, and its means over a dimension that the
leaf's spec splits (the row and column statistics, their mean, the
update's RMS) are sums all-reduced over that dimension's axes, divided by
the full count; its statistics take the specs of
``launch.shardings.opt_shardings``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed.collectives import sum_over
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # adafactor
    decay_rate: float = 0.8
    clip_threshold: float = 1.0
    min_dim_size_to_factor: int = 128
    warmup_steps: int = 100


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``learning_rate`` over ``warmup_steps`` (f32)."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.learning_rate * warm


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _decayed(p: torch.Tensor, u: torch.Tensor, lr, wd: float) -> None:
    """p <- p - lr (u + wd p), in f32, written back in p's dtype."""
    if p.dim() >= 2:            # no weight decay on norms/biases
        u = u + wd * p.float()
    p.copy_(p.float() - lr * u)


# --------------------------------------------------------------------- AdamW
def adamw_init(params, shardings=None):
    return {"mu": tree_map(_zeros_f32, params),
            "nu": tree_map(_zeros_f32, params),
            "step": _step0(params)}


def adamw_update(cfg: OptimizerConfig, grads, state, params,
                 shardings=None):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    t = step.float()
    c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)

    def upd(g, mu, nu, p):
        g = g.float()
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        _decayed(p, (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps), lr,
                 cfg.weight_decay)

    tree_map(upd, grads, state["mu"], state["nu"], params)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}


# ----------------------------------------------------------------- Adafactor
def _factored(shape, cfg: OptimizerConfig) -> bool:
    return (len(shape) >= 2
            and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def _mean(t: torch.Tensor, dim: int, sh, pdim: int,
          keepdim: bool = False) -> torch.Tensor:
    """Mean of the rank's block ``t`` over ``dim``, which is dimension
    ``pdim`` of the parameter whose ``NamedSharding`` is ``sh`` (None: no
    mesh)."""
    axes = sh.axes(pdim) if sh is not None else ()
    if not axes:
        return t.mean(dim=dim, keepdim=keepdim)
    s = sum_over(t.sum(dim=dim, keepdim=keepdim), sh.mesh, axes,
                 "optimizer_all_reduce")
    sizes = axis_sizes(sh.mesh)
    return s / (t.shape[dim] * math.prod(sizes[ax] for ax in axes))


def _mean_all(t: torch.Tensor, sh) -> torch.Tensor:
    """Mean of every element of the parameter-shaped block ``t``."""
    axes = sh.split_axes() if sh is not None else ()
    if not axes:
        return torch.mean(t)
    s = sum_over(t.sum(), sh.mesh, axes, "optimizer_all_reduce")
    return s / math.prod(sh.full_shape(t.shape))


def adafactor_init(params, cfg: OptimizerConfig, shardings=None):
    def init(p, sh=None):
        full = p.shape if sh is None else sh.full_shape(p.shape)
        if _factored(full, cfg):
            f32 = dict(dtype=torch.float32, device=p.device)
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": _zeros_f32(p)}
    # a leaf's state is a dict: map over the params, not the state tree
    v = (tree_map(init, params) if shardings is None
         else tree_map(init, params, shardings))
    return {"v": v, "step": _step0(params)}


def adafactor_update(cfg: OptimizerConfig, grads, state, params,
                     shardings=None):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    decay = 1.0 - (step.float() + 1.0) ** (-cfg.decay_rate)

    def upd(g, p, v, sh=None):
        g = g.float()
        g2 = g * g + 1e-30
        n = g.dim()
        if "vr" in v:
            v["vr"].copy_(decay * v["vr"]
                          + (1 - decay) * _mean(g2, -1, sh, n - 1))
            v["vc"].copy_(decay * v["vc"]
                          + (1 - decay) * _mean(g2, -2, sh, n - 2))
            denom = torch.clamp(_mean(v["vr"], -1, sh, n - 2, keepdim=True),
                                min=1e-30)
            rf = (v["vr"] / denom)[..., None]
            u = g * torch.rsqrt(rf * v["vc"][..., None, :] + 1e-30)
        else:
            v["v"].copy_(decay * v["v"] + (1 - decay) * g2)
            u = g * torch.rsqrt(v["v"] + 1e-30)
        rms = torch.sqrt(_mean_all(u * u, sh) + 1e-30)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        _decayed(p, u, lr, cfg.weight_decay)

    # tree_map follows the grads' structure, so each leaf meets its dict of
    # moments in the state
    if shardings is None:
        tree_map(upd, grads, params, state["v"])
    else:
        tree_map(upd, grads, params, state["v"], shardings)
    return params, {"v": state["v"], "step": step}


# ------------------------------------------------------------------ frontend
class Optimizer(NamedTuple):
    """``init(params, shardings=None)`` and ``update(grads, state, params,
    shardings=None)``; ``shardings`` (the params' ``NamedSharding`` tree)
    where the leaves are a mesh's blocks."""
    init: Callable[..., Any]
    update: Callable[..., Any]


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return Optimizer(
            init=adamw_init,
            update=lambda g, s, p, sh=None: adamw_update(cfg, g, s, p, sh))
    if cfg.name == "adafactor":
        return Optimizer(
            init=lambda p, sh=None: adafactor_init(p, cfg, sh),
            update=lambda g, s, p, sh=None: adafactor_update(
                cfg, g, s, p, sh))
    raise ValueError(f"unknown optimizer {cfg.name!r}")
