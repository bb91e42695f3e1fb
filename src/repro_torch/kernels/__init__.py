"""Hand-written Hopper kernels of the port, each beside its plain version.

The three attention / scan wrappers are exported here, as the reference's
``repro.kernels`` exports them (which shadows their submodules of the same
name as attributes of this package; import the submodules by their full
name).
"""

from . import ops, ref, transport
from .ops import flash_attention, mamba_scan, rwkv6_scan

__all__ = ["flash_attention", "mamba_scan", "rwkv6_scan", "ops", "ref",
           "transport"]
