"""Full-matrix oracle for the flash attention kernels.  The port of
``repro/kernels/flash_attention/ref.py``."""

from __future__ import annotations

import math

import torch

from repro_torch.device import no_tf32

__all__ = ["attention_ref"]


def attention_ref(q, k, v, causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Naive full-matrix attention in true f32.  q: (B,Sq,H,dh); k,v:
    (B,Skv,Kv,dh) -> (B,Sq,H,dh) in v's dtype."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    kr = torch.repeat_interleave(k, g, dim=2)
    vr = torch.repeat_interleave(v, g, dim=2)
    with no_tf32():
        s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                         kr.to(torch.float32)) * scale
        q_pos = torch.arange(sq, device=q.device)[:, None]
        kv_pos = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos <= q_pos
        if window is not None:
            mask &= kv_pos > q_pos - window
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", p, vr.to(torch.float32))
    return out.to(v.dtype)
