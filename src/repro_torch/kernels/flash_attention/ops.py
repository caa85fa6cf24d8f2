"""The flash attention entry point.  The port of
``repro/kernels/flash_attention/ops.py``: dispatch follows the operands'
device (kernel B5 on the card, its plain version on the CPU); there is no
``backend=`` switch and no environment variable.  :class:`FlashAttention`
is B5 with a gradient."""

from __future__ import annotations

import torch

from .kernel import flash_attention_kernel, plain_grads

__all__ = ["flash_attention", "FlashAttention"]


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """Attention of q (B, Sq, H, dh) over k, v (B, Skv, Kv, dh) with the
    causal and window masks -> (B, Sq, H, dh) in v's dtype."""
    return flash_attention_kernel(q, k, v, causal, window, scale)


class FlashAttention(torch.autograd.Function):
    """Kernel B5 with a gradient: the forward is :func:`flash_attention`
    (one launch on a CUDA tensor), the backward the gradient of
    ``plain(q, k, v)``, which the caller makes compute the same function
    (``kernel.plain_grads``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, plain):
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return flash_attention_kernel(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, grad_out):
        return (*plain_grads(ctx.plain, ctx.saved_tensors,
                             ctx.needs_input_grad[:3], grad_out),
                *(None,) * 4)
