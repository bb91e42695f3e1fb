from .archs import (
    ARCHS,
    CHIP_FAMILIES,
    MINICPM_2B,
    MINICPM_2B_4L,
    MINICPM_2B_8L,
    RWKV6_1_6B_4L,
    get_config,
    reduced,
)
from .base import (
    MambaConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    SHAPES,
    ShapeConfig,
    SubLayer,
    TrainConfig,
)

__all__ = [
    "ARCHS",
    "CHIP_FAMILIES",
    "MINICPM_2B",
    "MINICPM_2B_4L",
    "MINICPM_2B_8L",
    "RWKV6_1_6B_4L",
    "get_config",
    "reduced",
    "MambaConfig",
    "ModelConfig",
    "MoEConfig",
    "OptimizerConfig",
    "SHAPES",
    "ShapeConfig",
    "SubLayer",
    "TrainConfig",
]
