"""Node-aware collectives, their schedules and cost model, and grad sync."""

from . import bucketing, collectives, comm, grad_sync, napalg, perf_model
from .comm import CommContext, CommPolicy, Topology

__all__ = [
    "bucketing",
    "collectives",
    "comm",
    "grad_sync",
    "napalg",
    "perf_model",
    "CommContext",
    "CommPolicy",
    "Topology",
]
