"""The flash attention entry point.  The port of
``repro/kernels/flash_attention/ops.py``: dispatch follows the operands'
device (kernel B5 on the card, its plain version on the CPU); there is no
``backend=`` switch and no environment variable."""

from __future__ import annotations

from .kernel import flash_attention_kernel

__all__ = ["flash_attention"]


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """Attention of q (B, Sq, H, dh) over k, v (B, Skv, Kv, dh) with the
    causal and window masks -> (B, Sq, H, dh) in v's dtype."""
    return flash_attention_kernel(q, k, v, causal, window, scale)
