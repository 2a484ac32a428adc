"""Sharding trees of a whole train state: params, optimizer state and
batch (PyTorch counterpart of ``repro.launch.shardings``). A sharding is a
``distributed.sharding.NamedSharding`` (a mesh and a spec)."""
from __future__ import annotations

from typing import Any

from repro_torch.distributed.sharding import NamedSharding
from repro_torch.models.common import tree_map


def _replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _drop_dim(sh: NamedSharding, ndim: int, drop: int,
              mesh) -> NamedSharding:
    """Sharding of a statistic equal to the param with dim ``drop``
    removed (Adafactor's vr/vc)."""
    spec = list(sh.spec) + [None] * (ndim - len(sh.spec))
    del spec[drop]
    while spec and spec[-1] is None:
        spec.pop()
    return NamedSharding(mesh, tuple(spec))


def opt_shardings(opt_state, param_shardings, mesh) -> Any:
    """The optimizer state's sharding tree, mirroring the params': AdamW's
    moments as their params, Adafactor's row statistic ``vr`` (the param's
    shape without its last dim) and column statistic ``vc`` (without its
    second to last) with that dim dropped from the param's spec; the step
    replicated."""
    if "mu" in opt_state:        # adamw
        return {"mu": param_shardings, "nu": param_shardings,
                "step": _replicated(mesh)}

    def per_param(p_sh, vdict):
        out = {}
        for k, leaf in vdict.items():
            if k == "v":
                out[k] = p_sh
            elif k == "vr":
                out[k] = _drop_dim(p_sh, leaf.dim() + 1, leaf.dim(), mesh)
            elif k == "vc":
                out[k] = _drop_dim(p_sh, leaf.dim() + 1, leaf.dim() - 1,
                                   mesh)
        return out

    return {"v": tree_map(per_param, param_shardings, opt_state["v"]),
            "step": _replicated(mesh)}


def batch_shardings(model, shape, mesh, rules=None):
    """Each input's sharding: its batch dim over the data axes (where they
    divide it; an MoE config refuses a batch they do not split:
    ``Model.batch_shardings``)."""
    return model.batch_shardings(shape, mesh, rules)
