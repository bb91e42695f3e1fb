from .fault import (
    ReplicaHealth, ResumableLoop, StragglerMonitor, elastic_remesh,
)

__all__ = ["ReplicaHealth", "ResumableLoop", "StragglerMonitor",
           "elastic_remesh"]
