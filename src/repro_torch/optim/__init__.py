from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .error_feedback import ef_init, ef_residual
from .schedules import make_schedule

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "ef_init",
    "ef_residual",
    "make_schedule",
]
