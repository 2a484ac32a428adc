from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, RuntimeConfig,
    SHAPES, SHAPES_BY_NAME, scaled_config,
)
from repro_torch.configs.registry import (
    ARCHS, get_arch, all_cells, skipped_cells, shape_applicable,
    supports_long_context,
)
