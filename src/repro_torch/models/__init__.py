from .model import (
    Model,
    build_model,
    init_params,
    params_from_jax,
    params_to_numpy,
)

__all__ = [
    "Model",
    "build_model",
    "init_params",
    "params_from_jax",
    "params_to_numpy",
]
