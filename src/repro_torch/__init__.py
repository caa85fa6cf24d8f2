"""PyTorch + CUDA port of the L2R-CIPU reproduction.

``repro`` (JAX) is the reference; this package mirrors its layout and
names and never imports it.  Entry points run on CUDA unless called
with ``device="cpu"`` (:mod:`repro_torch.device`); every integer
digit-plane GEMM on a CUDA tensor goes through the hand-written Hopper
kernel in ``kernels/l2r_gemm/csrc``.
"""

from .device import no_tf32, resolve_device

__all__ = ["no_tf32", "resolve_device"]
