"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of ``repro/models/rglru.py``.  Two parallel branches from the
input, a GeLU gate branch and a recurrence branch (linear -> causal
temporal conv1d -> RG-LRU), multiplied and projected back:

    r_t = sigmoid(W_a xi_t + b_a)            recurrence gate
    i_t = sigmoid(W_x xi_t + b_x)            input gate
    log a_t = -c * softplus(Lambda) * r_t    (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

``gate_proj``, ``rec_proj`` and ``out_proj`` go through :func:`dense`
(kernel B1 on the card with an L2R config); ``w_a`` and ``w_x`` are
float denses in the reference and stay so.  The gates, the conv and the
scan are plain torch on every device, as they are plain JAX there.

Train and prefill evaluate the linear recurrence with :func:`lru_scan`,
the reference's ``jax.lax.associative_scan`` repeated step for step (the
recursive odd/even reduction, log2 S deep) with the combine's
``a2 * b1 + b2`` as one fused multiply-add, as XLA compiles it: the same
bits as the jitted reference on equal inputs, on the CPU and on the
card.  Decode is the O(1) step.

Tensor parallelism (a ``ctx.model_shard`` scope, sharding/ctx.py): where
the model axis divides the width a rank runs its channels, which is all
the mixer needs but the gates: ``gate_proj`` and ``rec_proj``
column-parallel, the conv, the scan and the ``h`` state on its channels,
``out_proj`` row-parallel.  The gates are float products over every
channel (``dense(xi, w_a)``); a sum split over the ranks would
reassociate, so ``w_a`` and ``w_x`` stay whole on every rank
(:func:`gates_whole`), the ranks' ``xi`` channels are all-gathered into the
one-process shape, the whole product taken and the rank's channels of
its output kept: the one-process bits.  Where the axis does not divide
the width the mixer runs whole.  The gradient of what every rank holds
alike (``w_a``, ``w_x``, the gate vectors) is summed over the ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.sharding import ctx
from repro_torch.sharding.collectives import copy_in, gather_channels

from .common import Param, dense, leading, residual_dense
from .config import ModelConfig
from .resize import fma_f32
from .ssm import _causal_conv as _conv1d
from .ssm import softplus

__all__ = ["rglru_build", "rglru_apply", "rglru_decode", "init_rglru_state",
           "lru_scan", "rglru_channels", "gates_whole"]

_C = 8.0


def gates_whole(m: int) -> None:
    """The layout of ``w_a`` and ``w_x`` (models/common.py:Param
    ``held``): whole on every rank, where ``param_specs`` splits their
    rows (2 x 26.2 MB of f32 a rec layer of recurrentgemma-2b)."""
    return None


def rglru_build(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "gate_proj": Param((d, w), ("embed", "ffn")),
        "rec_proj": Param((d, w), ("embed", "ffn")),
        "conv_w": Param((cfg.conv1d_width, w), (None, "ffn"), scale=0.1),
        "conv_b": Param((w,), ("ffn",), init="zeros"),
        "w_a": Param((w, w), ("ffn", None), scale=0.02,
                     held=gates_whole),
        "b_a": Param((w,), (None,), init="zeros"),
        "w_x": Param((w, w), ("ffn", None), scale=0.02,
                     held=gates_whole),
        "b_x": Param((w,), (None,), init="zeros"),
        "lam": Param((w,), (None,), init="ones"),  # Lambda (softplus'd)
        "out_proj": Param((w, cfg.d_model), ("ffn", "embed")),
    }


def rglru_channels(cfg: ModelConfig) -> tuple[int, int]:
    """This rank's channels ``[c0, c1)``: in a ``ctx.model_shard`` scope
    whose model axis divides the width its ``1 / m`` of them, else all
    (the mixer runs whole)."""
    w = cfg.lru_width or cfg.d_model
    split = ctx.model_split()
    if split is None or w % split.size:
        return 0, w
    wl = w // split.size
    return split.index * wl, (split.index + 1) * wl


def _gates(params, xi, c0: int = 0, c1: int | None = None, split=None):
    """a, b of the scan on channels ``[c0, c1)``; with ``split`` ``xi``
    holds those channels of a row split over the ranks, gathered whole
    for the products (module docstring)."""
    f32 = torch.float32
    x_all = xi if split is None else \
        gather_channels(xi, split.group, split.index)
    w_a, w_x, b_a, b_x, lam = (
        params[k] if split is None else copy_in(params[k], split.group)
        for k in ("w_a", "w_x", "b_a", "b_x", "lam"))
    cut = slice(c0, c1)
    r = torch.sigmoid(dense(x_all, w_a).to(f32)[..., cut]
                      + b_a[cut].to(f32))
    i = torch.sigmoid(dense(x_all, w_x).to(f32)[..., cut]
                      + b_x[cut].to(f32))
    log_a = -_C * softplus(lam[cut].to(f32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xi.to(f32))
    return a, b


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, fma_f32(a2, b1, b2)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], ... (len(even) is
    len(odd) or one more)."""
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1],
                       *even.shape[2:]), dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def lru_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis 1 of
    f32 (B, S, W) tensors -> (prod a, h).  The recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the
    half-length sequence, then fill in the even positions."""
    s = a.shape[1]
    if s < 2:
        return a, b
    pa, pb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    odd_a, odd_b = lru_scan(pa, pb)
    if s % 2 == 0:
        ea, eb = _combine((odd_a[:, :-1], odd_b[:, :-1]),
                          (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, odd_a), _interleave(eb, odd_b)


def init_rglru_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: str | torch.device | None = None) -> dict:
    c0, c1 = rglru_channels(cfg)
    w = c1 - c0
    device = resolve_device(device)
    return {
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                            device=device),
    }


def _split(cfg: ModelConfig, params: dict, u: torch.Tensor):
    """(u, the split when the mixer runs on this rank's channels, else
    None): ``u`` enters the column-parallel products (its gradient summed
    over the ranks) when ``out_proj`` is row-parallel."""
    split = ctx.model_split()
    w = cfg.lru_width or cfg.d_model
    if split is None or leading(params["out_proj"]) == w:
        return u, None
    return copy_in(u, split.group), split


def _branches(cfg: ModelConfig, params: dict, u: torch.Tensor, conv_state):
    """gate, xi after the conv, the conv's new state and the split."""
    u, split = _split(cfg, params, u)
    gate = F.gelu(dense(u, params["gate_proj"], cfg.l2r, cfg.l2r_levels),
                  approximate="tanh")
    xi = dense(u, params["rec_proj"], cfg.l2r, cfg.l2r_levels)
    xi, new_conv = _conv1d(xi, params["conv_w"], params["conv_b"],
                           conv_state)
    return gate, xi, new_conv, split


def _out(cfg: ModelConfig, params: dict, y: torch.Tensor) -> torch.Tensor:
    return residual_dense(y, params["out_proj"], cfg.l2r, cfg.l2r_levels,
                          cfg.lru_width or cfg.d_model)


def rglru_apply(cfg: ModelConfig, params: dict, u: torch.Tensor,
                state: dict | None = None):
    """u: (B, S, d_model) -> (out, new_state), new tensors (this rank's
    channels of the states in a ``ctx.model_shard`` scope)."""
    conv_state = None if state is None else state["conv"]
    gate, xi, new_conv, split = _branches(cfg, params, u, conv_state)
    c0, c1 = rglru_channels(cfg) if split is not None else (0, None)
    a, b = _gates(params, xi, c0, c1, split)  # (B, S, W) f32

    if state is not None:
        # fold the carried state into the first step: h_0' = a_0 h_in + b_0
        b = torch.cat([b[:, :1] + a[:, :1] * state["h"].to(torch.float32)
                       [:, None], b[:, 1:]], dim=1)

    _, h = lru_scan(a, b)
    y = h.to(u.dtype) * gate
    return _out(cfg, params, y), {"h": h[:, -1], "conv": new_conv}


def rglru_decode(cfg: ModelConfig, params: dict, u: torch.Tensor,
                 state: dict):
    """u: (B, 1, d_model); the O(1) recurrent step."""
    gate, xi, new_conv, split = _branches(cfg, params, u, state["conv"])
    c0, c1 = rglru_channels(cfg) if split is not None else (0, None)
    a, b = _gates(params, xi, c0, c1, split)  # (B, 1, W)
    h = a[:, 0] * state["h"].to(torch.float32) + b[:, 0]
    y = h[:, None].to(u.dtype) * gate
    return _out(cfg, params, y), {"h": h, "conv": new_conv}
