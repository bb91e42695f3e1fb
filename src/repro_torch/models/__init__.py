from .model import (
    Model,
    build_model,
    cache_from_jax,
    cache_to_jax,
    init_params,
    params_from_jax,
    params_to_numpy,
)
from .sharding import REPLICATED, ShardingPolicy

__all__ = [
    "Model",
    "build_model",
    "cache_from_jax",
    "cache_to_jax",
    "init_params",
    "params_from_jax",
    "params_to_numpy",
    "REPLICATED",
    "ShardingPolicy",
]
