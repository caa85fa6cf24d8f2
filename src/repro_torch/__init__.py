"""PyTorch + CUDA port of the L2R-CIPU reproduction.

``repro`` (JAX) is the reference; this package mirrors its layout and
names and never imports it.  Entry points run on CUDA unless called
with ``device="cpu"`` (:mod:`repro_torch.device`); every kernel of the
reference has a hand-written Hopper counterpart under
``kernels/*/csrc``, which a CUDA tensor always goes through.
"""

from .device import no_tf32, resolve_device

__all__ = ["no_tf32", "resolve_device"]
