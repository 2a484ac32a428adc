"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus shape cells.

``CELLS`` enumerates every (arch x shape) dry-run cell, applying the
documented skip rules (DESIGN.md §4):
  - long_500k only for sub-quadratic archs (SWA / SSM / hybrid).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME

from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.granite_3_8b import CONFIG as _granite
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.whisper_medium import CONFIG as _whisper

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _kimi, _moonshot, _danube, _granite, _phi3,
        _llama3, _xlstm, _llava, _jamba, _whisper,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def supports_long_context(cfg: ModelConfig) -> bool:
    """Sub-quadratic decode: SWA, SSM, or hybrid archs."""
    return bool(cfg.sliding_window) or cfg.family in ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not supports_long_context(cfg):
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""


def all_cells() -> List[Tuple[ModelConfig, ShapeConfig]]:
    """Every runnable (arch x shape) dry-run cell, in registry order."""
    cells = []
    for cfg in ARCHS.values():
        for shape in SHAPES:
            ok, _ = shape_applicable(cfg, shape)
            if ok:
                cells.append((cfg, shape))
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    out = []
    for cfg in ARCHS.values():
        for shape in SHAPES:
            ok, why = shape_applicable(cfg, shape)
            if not ok:
                out.append((cfg.name, shape.name, why))
    return out


__all__ = [
    "ARCHS", "SHAPES", "SHAPES_BY_NAME", "get_arch",
    "shape_applicable", "all_cells", "skipped_cells", "supports_long_context",
]
