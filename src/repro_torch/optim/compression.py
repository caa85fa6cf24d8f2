"""Error-feedback int8 gradient compression for data-parallel all-reduce.

The port of ``repro/optim/compression.py``.  Before the gradient
reduction, every gradient leaf (plus its carried error) is quantized to
int8 with one per-tensor scale; the quantization residual is kept in an
error-feedback buffer and added back next step (EF-SGD).  Without a
mesh there is no all-reduce: the round trip is what the step computes.

``_q8``'s scale is ``max(amax, 1e-30) * f32(1/127)`` and the residual
``x - q * scale`` one fused multiply-add: the forms XLA compiles the
reference's ``/ 127.0`` and ``x - xhat`` to inside the jitted train
step (eager JAX divides and rounds twice), so codes, scales and
residuals are the jitted step's bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.resize import fma_f32

__all__ = ["EFState", "ef_init", "compress_decompress", "ef_compress_grads"]

_INV_127 = 1.0 / 127.0  # rounds to the f32 XLA multiplies by


class EFState(NamedTuple):
    residual: Any  # tree of f32 error-feedback buffers


def ef_init(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _q8(x: torch.Tensor):
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=1e-30) * torch.full(
        (), _INV_127, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(x: torch.Tensor):
    """Round trip through the int8 wire format; returns (xhat, err)."""
    xf = x.to(torch.float32)
    q, scale = _q8(xf)
    qf = q.to(torch.float32)
    xhat = qf * scale
    return xhat, fma_f32(-qf, scale.expand_as(qf), xf)


def ef_compress_grads(grads, ef: EFState):
    """Error feedback + int8 round trip on every gradient leaf; returns
    (compressed_grads, new_ef)."""
    outs = []
    for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual)):
        xhat, err = compress_decompress(g.to(torch.float32) + r)
        outs.append((xhat.to(g.dtype), err))
    return (tree_unflatten(grads, [o[0] for o in outs]),
            EFState(residual=tree_unflatten(grads, [o[1] for o in outs])))
