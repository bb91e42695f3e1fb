"""PyTorch / CUDA port of the node-aware allreduce system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``configs``, ``core``, ``kernels``, ``optim``, ``data``,
``models``, ``launch``) and imports none of it.  Entry points run on the
card (``cuda``) unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
