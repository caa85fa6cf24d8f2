"""L2R-quantized checkpoints: int8 weights + per-tensor scales on disk,
and prepared serving trees.

The port of ``repro/checkpoint/quantized.py``, in its file format.  The
serving-time storage format of models/common.py:quantize_desc doubles as
a checkpoint codec: matmul weights are stored as int8 with f32 scales
(4x fewer bytes than f32).  Round-trip error is the weight quantization
error, at most half a scale per element; checkpoints that must be
bit-exact keep the full-precision path in manager.py.

A prepared tree (``serve.engine.prepare_params``: QuantizedWeights
records with their plane stacks and the window-padded head cache) is
saved whole, so serving resumes with no weight preparation.  The port's
stacks are pre-shifted and K-major in memory; the file holds the
reference's raw-digit, row-major stacks (manager.py converts exactly in
both directions), so a prepared checkpoint of either package loads into
the other bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import (Param, _quantizable, quantize_params,
                                       tree_map)

from .manager import _leaves, load_pytree, save_pytree

__all__ = ["save_quantized", "load_quantized", "quantized_nbytes",
           "save_prepared", "prepared_template", "load_prepared"]


def _meta(tree):
    """Shape-and-dtype stand-ins of a tensor tree on the ``meta`` device:
    a template costs no memory and no arithmetic."""
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def save_quantized(desc_tree, params, path: str):
    """Quantize eligible weights (int8 + scale) and save one .npz."""
    q = quantize_params(desc_tree, params)
    save_pytree(q, path)
    return q


def load_quantized(desc_tree, params_template, path: str,
                   dequantize: bool = False,
                   device: str | torch.device | None = None):
    """Restore a quantized checkpoint on ``device`` (CUDA unless given).

    ``dequantize=False`` returns the serving tree (``{"q", "scale"}``
    records, consumed directly by models/common.py:dense);
    ``dequantize=True`` folds back to the template's float dtypes.
    """
    qtemplate = quantize_params(desc_tree, _meta(params_template))
    q = load_pytree(qtemplate, path, device)
    if not dequantize:
        return q

    def f(p: Param, w, orig):
        if _quantizable(p):
            return (w["q"].to(torch.float32) * w["scale"]).to(orig.dtype)
        return w

    return tree_map(f, desc_tree, q, params_template)


def quantized_nbytes(tree) -> int:
    """Bytes of every tensor leaf (records and plane stacks included)."""
    total = 0
    for _, leaf in _leaves(tree):
        t = getattr(leaf, "stack", leaf)
        total += t.numel() * t.element_size()
    return total


def save_prepared(prepared, path: str):
    """Save a ``prepare_params`` output tree (plane stacks and the
    streaming head cache included) as one .npz in the reference's
    format."""
    save_pytree(prepared, path)
    return prepared


def prepared_template(cfg, params_template, desc=None):
    """The prepared tree's structure, shapes, dtypes and layouts, built on
    the ``meta`` device from ``params_template`` (only its shapes and
    dtypes count): the restore target of :func:`load_prepared`."""
    from repro_torch.serve.engine import prepare_params

    return prepare_params(cfg, _meta(params_template), desc=desc)


def load_prepared(cfg, params_template, path: str, desc=None,
                  device: str | torch.device | None = None):
    """Restore a prepared serving tree saved by :func:`save_prepared`
    (or by the reference's) on ``device`` (CUDA unless given): int8
    payloads, scales, plane stacks and the padded head cache land
    bit-exact, in the port's layouts, with no weight preparation pass."""
    return load_pytree(prepared_template(cfg, params_template, desc), path,
                       device)
