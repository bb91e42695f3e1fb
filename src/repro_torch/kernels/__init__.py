"""Hand-written Hopper kernels of the port, each beside its plain version.

The three attention / scan wrappers are exported here, as the reference's
``repro.kernels`` exports them (which shadows their submodules of the same
name as attributes of this package; import the submodules by their full
name).
"""

from . import _build, adamw, ops, ref, transport
from .ops import flash_attention, mamba_scan, rwkv6_scan

__all__ = ["flash_attention", "mamba_scan", "rwkv6_scan", "adamw", "ops",
           "ref", "transport", "build_train_kernels"]


def build_train_kernels() -> None:
    """Compile the kernels a train step runs on a card, ``csrc/transport.cu``
    (the compressed sync) and ``csrc/adamw.cu`` (AdamW), once per source
    hash, their two ``nvcc`` side by side.  Raises on a compiler error."""
    _build.build(transport._SOURCE, adamw._SOURCE)
