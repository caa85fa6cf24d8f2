"""The FC head's 7x7 resize, bit for bit as the reference computes it.

The reference (``repro/models/cnn.py:_vgg16_trunk``) resizes a final map
that is not 7x7 with ``jax.image.resize(x, (B, 7, 7, C), "linear")``.
Under ``jit`` on the CPU that is two f32 dots with one (s, 7) weight
matrix per axis (``resize_table.py``), and XLA:CPU sums them in fixed
orders, which this module repeats with elementwise torch ops only (no
``matmul``, ``einsum`` or ``sum``, whose order is unspecified), so the
CPU and the card give the same bits:

1. over H, for every (w, c): ``acc = fma(W[k, i], x[k], acc)`` for
   k = 0 .. h-1 from 0 (one fused multiply-add chain);
2. over W, for every output column j: four lane chains of fused
   multiply-adds, lane l over k = l, l+4, ... below 4*(w // 4), summed
   as (l0 + l1) + (l2 + l3); the remaining one to three products are
   rounded to f32 and summed left to right, then added.  Below four
   columns (w = 2, 3) the last output column is one FMA chain instead.

Those are the orders XLA:CPU (jaxlib 0.9.0, x86-64) was observed to
use; ``tests/test_torch_resize.py`` holds the result equal to
``jax.image.resize`` at every map size 1-14, batches 1, 2 and 8.
Upsampling and downsampling follow the same orders.  A map side outside
the weight table (1-64) raises.
"""

from __future__ import annotations

import base64
import functools
import math
import zlib

import numpy as np
import torch

from repro_torch.models.resize_table import _TABLE, MAX_SIZE

__all__ = ["resize_7x7", "resize_weights", "fma_f32"]

_OUT = 7


@functools.lru_cache(maxsize=None)
def _table() -> tuple[np.ndarray, ...]:
    flat = np.frombuffer(zlib.decompress(base64.b64decode("".join(_TABLE))),
                         "<f4")
    mats, at = [], 0
    for s in range(1, MAX_SIZE + 1):
        mats.append(flat[at:at + s * _OUT].reshape(s, _OUT))
        at += s * _OUT
    return tuple(mats)


def resize_weights(size: int) -> np.ndarray:
    """The reference's (size, 7) f32 weight matrix for one map side."""
    if not 1 <= size <= MAX_SIZE:
        raise ValueError(
            f"the head resize has weights for map sides 1..{MAX_SIZE} "
            f"(images up to {32 * MAX_SIZE} px); got a side of {size}")
    return _table()[size - 1]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` on f32 tensors with one rounding, on any device.

    The product of two f32 values is exact in f64 (48 significant bits).
    The f64 sum is rounded to odd: TwoSum gives its exact error, and a sum
    that has an error and an even significand moves one f64 ulp toward
    the error.  Rounding that round-to-odd f64 (53 >= 24 + 2 bits) to f32
    is the correct rounding of the exact ``a*b + c``, so double rounding
    cannot occur (Boldo and Melquiond's round-to-odd).

    Differentiable as ``a * b + c`` (the gradient ``jax.grad`` gives the
    reference's fused combine), whatever torch's ``nextafter`` supports.
    """
    return _FmaF32.apply(a, b, c)


class _FmaF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shapes = (a.shape, b.shape, c.shape)
        p = a.double() * b.double()
        cd = c.double()
        s = p + cd
        t = s - p
        err = (p - (s - t)) + (cd - t)
        toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
        odd_fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
        return torch.where(odd_fix, torch.nextafter(s, toward), s).float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga, gb, gc = ctx.shapes
        return ((g * b).sum_to_size(ga), (g * a).sum_to_size(gb),
                g.sum_to_size(gc))


def _column(w: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    # row k of the (s, n) weights, laid along `axis` of an NHWC map
    shape = [1, 1, 1, 1]
    shape[axis] = w.shape[1]
    return w[k].view(shape)


def _chain(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    # contract `axis` (1 = H, 2 = W) with w (s, n): one FMA chain from 0
    shape = list(x.shape)
    shape[axis] = w.shape[1]
    acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
    for k in range(x.shape[axis]):
        acc = fma_f32(_column(w, k, axis), x.narrow(axis, k, 1), acc)
    return acc


def _lanes(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    # contract `axis` to 7: four FMA lanes, then the rounded products of
    # the remainder; below four, the last output column is an FMA chain
    s = x.shape[axis]
    xk = [x.narrow(axis, k, 1) for k in range(s)]
    wk = [_column(w, k, axis) for k in range(s)]
    main = 4 * (s // 4)
    out = None
    if main:
        lanes = []
        for lane in range(4):
            acc = torch.zeros_like(xk[0] * wk[0])
            for k in range(lane, main, 4):
                acc = fma_f32(wk[k], xk[k], acc)
            lanes.append(acc)
        out = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    if main < s:
        rest = xk[main] * wk[main]
        for k in range(main + 1, s):
            rest = rest + xk[k] * wk[k]
        out = rest if out is None else out + rest
        if main == 0 and s > 1:
            last = _chain(x, w[:, _OUT - 1:], axis)
            out = torch.cat([out.narrow(axis, 0, _OUT - 1), last], dim=axis)
    return out


def resize_7x7(x: torch.Tensor) -> torch.Tensor:
    """Resize an NHWC f32 map to the FC head's 7x7, bit-identical to the
    reference's ``jax.image.resize(x, (B, 7, 7, C), "linear")``.  A side
    that is already 7 is left as it is (as the reference skips it)."""
    # the longer side first (H on a tie), as XLA orders the two dots
    axes = sorted((a for a in (1, 2) if x.shape[a] != _OUT),
                  key=lambda a: -x.shape[a])
    for i, axis in enumerate(axes):
        w = torch.tensor(resize_weights(x.shape[axis]), device=x.device)
        x = (_chain if i == 0 else _lanes)(x, w, axis)
    return x
