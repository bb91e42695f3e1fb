from .archs import ARCHS, MINICPM_2B, MINICPM_2B_4L, get_config, reduced
from .base import ModelConfig, OptimizerConfig, SubLayer

__all__ = [
    "ARCHS",
    "MINICPM_2B",
    "MINICPM_2B_4L",
    "get_config",
    "reduced",
    "ModelConfig",
    "OptimizerConfig",
    "SubLayer",
]
