"""Hand-written Hopper kernels of the port, each beside its plain version."""

from . import ref, transport

__all__ = ["ref", "transport"]
