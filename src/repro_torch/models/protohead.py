"""Synthetic decisive-margin prototype head.

The port of ``repro/models/protohead.py``.  An untrained random head has
exchangeable logits (top-1 margins ~0, nothing exits early); a trained
classifier works in the decisive-margin regime.  This head reproduces
that regime: class c's weight column is the unit-normalized prototype
of class c, and the queries are noisy copies of prototypes, so the
true-class logit leads by a margin set by the noise level.

It draws from the same numpy generator calls as the reference, so one
seed gives the same floats and, quantized on the CPU, the same integer
operands and scales in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import (QuantConfig, QuantizedWeights, quantize,
                                    quantize_weights)
from repro_torch.device import resolve_device

__all__ = ["prototype_head"]


def prototype_head(rng: np.random.Generator, k: int, classes: int,
                   rows: int, noise: float = 0.05,
                   cfg: QuantConfig = QuantConfig(),
                   device: str | torch.device | None = None):
    """Quantized operands of a decisive-margin head matmul, on ``device``
    (CUDA unless ``device="cpu"``).

    Returns ``(xq, xs, w_q, labels)``: per-row-quantized query
    activations ``xq (rows, k)`` with scales ``xs``, the quantized
    unit-norm prototype weights ``w_q`` (``(k, classes)`` +
    per-out-channel scale), and the true class of each query row (numpy).
    """
    dev = resolve_device(device)
    proto = rng.standard_normal((classes, k)).astype(np.float32)
    labels = rng.integers(0, classes, rows)
    x = proto[labels] + noise * rng.standard_normal(
        (rows, k)).astype(np.float32)
    xq, xs = quantize(torch.from_numpy(x), cfg, axis=0)
    w_q = quantize_weights(torch.from_numpy(
        proto.T / np.linalg.norm(proto.T, axis=0, keepdims=True)), cfg)
    return (xq.to(dev), xs.to(dev),
            QuantizedWeights(w_q.q.to(dev), w_q.scale.to(dev)), labels)
