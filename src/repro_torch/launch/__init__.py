from .mesh import (
    Mesh, dp_axes, hierarchy_axes, make_mesh, make_production_mesh,
    mesh_topology,
)
from .steps import (
    init_train_state, input_specs, make_dp_train_step, make_policy,
    make_prefill_step, make_serve_step, make_train_step, microbatch_split,
    state_specs,
)

__all__ = ["Mesh", "dp_axes", "hierarchy_axes", "make_mesh",
           "make_production_mesh", "mesh_topology",
           "init_train_state", "input_specs", "make_dp_train_step",
           "make_policy", "make_prefill_step", "make_serve_step",
           "make_train_step", "microbatch_split", "state_specs",
           "build_training"]


def __getattr__(name):
    # imported on first use, so that ``python -m repro_torch.launch.train``
    # does not find its own module already imported by the package
    if name == "build_training":
        from .train import build_training
        return build_training
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
