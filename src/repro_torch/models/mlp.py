"""Feed-forward blocks: SwiGLU / GeGLU / GELU, with L2R-quantized matmuls
when the config enables the paper's technique.  The port of
``repro/models/mlp.py``; GELU is the tanh form, ``jax.nn.gelu``'s
default.

In a ``ctx.model_shard`` scope (sharding/ctx.py) the block is
Megatron's: ``wi`` column-parallel (its ``ffn`` columns this rank's; the
(d, 2, d_ff) layout keeps each gate/up pair on one rank), the activation
on the rank's columns, ``wo`` row-parallel (models/common.py:dense).
Where the model axis does not divide ``d_ff`` (``param_specs`` keeps
``wi`` and ``wo`` whole) the block runs whole on every rank
(models/common.py:residual_dense).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import ctx
from repro_torch.sharding.collectives import copy_in

from .common import Param, dense, residual_dense
from .config import ModelConfig

__all__ = ["mlp_build", "mlp_apply", "mlp_act"]


def mlp_build(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d_ff = d_ff if d_ff is not None else cfg.d_ff
    if cfg.ffn_kind in ("swiglu", "geglu"):
        return {
            "wi": Param((cfg.d_model, 2, d_ff), ("embed", None, "ffn")),
            "wo": Param((d_ff, cfg.d_model), ("ffn", "embed")),
        }
    return {
        "wi": Param((cfg.d_model, d_ff), ("embed", "ffn")),
        "wo": Param((d_ff, cfg.d_model), ("ffn", "embed")),
    }


def mlp_act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The GLU product (gate, up on axis -2) or GELU of an ffn hidden."""
    if cfg.ffn_kind in ("swiglu", "geglu"):
        gate, up = h[..., 0, :], h[..., 1, :]
        act = F.silu(gate) if cfg.ffn_kind == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        return act * up
    return F.gelu(h, approximate="tanh")


def mlp_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
              d_ff: int | None = None) -> torch.Tensor:
    """``d_ff``: the block's whole hidden width (default ``cfg.d_ff``)."""
    d_ff = d_ff if d_ff is not None else cfg.d_ff
    split = ctx.model_split()
    if split is not None and params["wo"].shape[0] != d_ff:
        x = copy_in(x, split.group)
    h = dense(x, params["wi"], cfg.l2r, cfg.l2r_levels)  # (..., [2,] d_ff)
    return residual_dense(mlp_act(cfg, h), params["wo"], cfg.l2r,
                          cfg.l2r_levels, d_ff)
