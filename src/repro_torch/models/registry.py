"""Model facade over the port's LM, and the weight bridge from the JAX
package's parameter tree."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import tree_map
from repro_torch.models.lm import LM


class Model:
    """Facade over the LM (the JAX facade also dispatches to EncDec, which
    waits for a later slice and raises in ``LM``)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.impl = LM(cfg)

    def specs(self):
        return self.impl.specs()

    def init(self, generator: torch.Generator, device="cuda"):
        return self.impl.init(generator, device)

    @property
    def repeats(self) -> int:
        return self.impl.repeats


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16: same bits, as int16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """The JAX params tree (nested dicts/tuples whose leaves are arrays,
    e.g. after ``jax.tree.map(np.asarray, params)``) as the port's params:
    leaf by leaf, same structure, same layout, same dtype, on ``device``."""
    return tree_map(lambda a: _to_torch(a, device), tree)
