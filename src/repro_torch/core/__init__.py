"""Node-aware collectives, their schedules and cost model, and grad sync."""

from . import (
    bucketing, collectives, comm, extensions, grad_sync, napalg, perf_model,
    simulator,
)
from .comm import CommContext, CommPolicy, Topology

__all__ = [
    "bucketing",
    "collectives",
    "comm",
    "extensions",
    "grad_sync",
    "napalg",
    "perf_model",
    "simulator",
    "CommContext",
    "CommPolicy",
    "Topology",
]
