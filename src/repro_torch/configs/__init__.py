"""Config registry: one module per assigned architecture + the paper's own models."""
from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    PAPER_IDS,
    InputShape,
    ModelConfig,
    all_configs,
    get_config,
)

__all__ = [
    "ARCH_IDS", "PAPER_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
    "all_configs", "get_config",
]
