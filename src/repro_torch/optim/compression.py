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

With ZeRO-1 (``zero=``, optim/adamw.py:Zero1) the residual holds this
rank's slice of each leaf.  The whole (summed) gradients are the same on
every rank; each rank rounds its slice, with the leaf's ``amax`` taken
over the whole mesh first (one all-reduce for all leaves), so codes,
scales and residuals equal the whole-tensor round trip bit for bit, and
the compressed gradients are gathered whole.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.resize import fma_f32
from repro_torch.sharding.collectives import all_reduce

__all__ = ["EFState", "ef_init", "compress_decompress", "ef_compress_grads"]

_INV_127 = 1.0 / 127.0  # rounds to the f32 XLA multiplies by


class EFState(NamedTuple):
    residual: Any  # tree of f32 error-feedback buffers


def ef_init(params, zero=None) -> EFState:
    """Zero residuals in f32; with ``zero`` this rank's slice of each."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    if zero is not None:
        return EFState(residual=tree_unflatten(
            params, [zeros(x) for x in zero.local(params)]))
    return EFState(residual=tree_map(zeros, params))


def _q8(x: torch.Tensor, amax: torch.Tensor | None = None):
    if amax is None:
        amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=1e-30) * torch.full(
        (), _INV_127, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(x: torch.Tensor, amax: torch.Tensor | None = None):
    """Round trip through the int8 wire format; returns (xhat, err).
    ``amax`` is the whole tensor's ``max |x|`` when ``x`` is a slice."""
    xf = x.to(torch.float32)
    q, scale = _q8(xf, amax)
    qf = q.to(torch.float32)
    xhat = qf * scale
    return xhat, fma_f32(-qf, scale.expand_as(qf), xf)


def ef_compress_grads(grads, ef: EFState, zero=None):
    """Error feedback + int8 round trip on every gradient leaf; returns
    (compressed_grads, new_ef).  With ``zero`` the residuals are this
    rank's slices and the compressed gradients come back whole."""
    if zero is None:
        gs = tree_leaves(grads)
        xs = [g.to(torch.float32) + r
              for g, r in zip(gs, tree_leaves(ef.residual))]
        amax = [None] * len(xs)
    else:
        gs = zero.local(grads)
        xs = [g.to(torch.float32) + r
              for g, r in zip(gs, tree_leaves(ef.residual))]
        amax = all_reduce(torch.stack([torch.amax(torch.abs(x)) for x in xs]),
                          "max", zero.mesh.group(zero.mesh.axis_names))
    outs = []
    for g, x, a in zip(gs, xs, amax):
        xhat, err = compress_decompress(x, a)
        outs.append((xhat.to(g.dtype), err))
    xhat = [o[0] for o in outs]
    if zero is not None:
        xhat = zero.gather(xhat)
    return (tree_unflatten(grads, xhat),
            EFState(residual=tree_unflatten(grads, [o[1] for o in outs])))
