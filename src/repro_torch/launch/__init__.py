from .mesh import mesh_topology
from .steps import (
    init_train_state, make_dp_train_step, make_prefill_step, make_serve_step,
)

__all__ = ["mesh_topology", "init_train_state", "make_dp_train_step",
           "make_prefill_step", "make_serve_step"]
