"""Mixture-of-Experts FFN: top-k routing with capacity, scatter dispatch,
shared experts (DeepSeekMoE) and top-1 routed + shared (Llama-4 style).

The port of ``repro/models/moe.py``.  Token t's i-th choice of expert e
gets slot p = (number of earlier assignments to e); assignments beyond
the capacity C are dropped.  The routing, dispatch and combine are plain
torch on every device, as they are plain JAX in the reference, and they
are deterministic: the top-k is a stable descending sort (the lower
expert index first on ties, as ``jax.lax.top_k``), the dispatch is a
plain indexed write (kept assignments have unique (expert, slot) pairs),
and the combine adds each token's k contributions in index order from
zeros, with no atomic scatter-add.  The router goes through
:func:`dense` and the shared experts through ``mlp_apply``; the routed
experts run one expert at a time, each matmul through ``l2r_matmul_f``
with an L2R config (one launch of kernel B1 per expert and matmul on the
card, the expert's weight quantized on every call as the reference's
vmapped call does: expert stacks are not in the load-time weight
cache).  The mesh-only ``moe_apply_dp_local`` and ``_dp_groups`` are
not ported (ROADMAP A13b): without a mesh the reference takes
:func:`moe_apply`, and so does every call here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import no_tf32
from repro_torch.kernels.l2r_gemm.ops import l2r_matmul_f

from .common import Param, dense
from .config import ModelConfig
from .mlp import mlp_act, mlp_apply

__all__ = ["moe_build", "moe_apply", "moe_capacity", "moe_route"]


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    ideal = cfg.experts_per_token * n_tokens / max(cfg.n_experts, 1)
    cap = int(math.ceil(ideal * cfg.capacity_factor))
    return max(8, min(cap, n_tokens))


def moe_build(cfg: ModelConfig) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    glu = cfg.ffn_kind in ("swiglu", "geglu")
    params = {
        "router": Param((d, e), ("embed", None), scale=0.02),
        "wi": Param((e, d, 2, f) if glu else (e, d, f),
                    ("experts", "embed", None, "ffn") if glu
                    else ("experts", "embed", "ffn")),
        "wo": Param((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        params["shared_wi"] = Param(
            (d, 2, fs) if glu else (d, fs),
            ("embed", None, "ffn") if glu else ("embed", "ffn"),
        )
        params["shared_wo"] = Param((fs, d), ("ffn", "embed"))
    return params


def _expert_ffn(cfg: ModelConfig, wi, wo, xb: torch.Tensor) -> torch.Tensor:
    """xb: (E, C, d) -> (E, C, d); per-expert GLU/GELU FFN.

    With the L2R switch each expert's two matmuls go through
    ``l2r_matmul_f`` (per-expert activation and weight scales, from the
    quantization inside each call); without it they are true-f32
    (TF32 off) batched products in xb's dtype."""
    if cfg.l2r is not None:
        wi2 = wi.reshape(wi.shape[0], wi.shape[1], -1)
        h = torch.stack([l2r_matmul_f(xb[e], wi2[e], cfg.l2r, cfg.l2r_levels)
                         for e in range(xb.shape[0])])
        h = mlp_act(cfg, h.reshape(*xb.shape[:2], *wi.shape[2:]))
        return torch.stack([l2r_matmul_f(h[e], wo[e], cfg.l2r,
                                         cfg.l2r_levels)
                            for e in range(xb.shape[0])])
    with no_tf32():
        h = torch.bmm(xb, wi.reshape(wi.shape[0], wi.shape[1], -1)
                      .to(xb.dtype))
        h = mlp_act(cfg, h.reshape(*xb.shape[:2], *wi.shape[2:]))
        return torch.bmm(h, wo.to(xb.dtype))


def moe_route(cfg: ModelConfig, logits: torch.Tensor, cap: int):
    """Router logits (T, E) f32 -> (probs (T, E), gate_vals (T, k),
    expert_idx (T, k), slot (T*k,), keep (T*k,)): the top-k in
    descending order, lower index first on ties; slot is the exclusive
    count of earlier assignments (token-major, choice-minor) to the same
    expert, kept while below ``cap``."""
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    flat_e = expert_idx.reshape(-1)
    onehot = F.one_hot(flat_e, e).to(torch.int32)  # (T*k, E)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    return probs, gate_vals, expert_idx, slot, slot < cap


def moe_apply(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss (f32 scalar)).  Routed top-k plus
    the optional shared experts, and the Switch-style load-balance aux
    loss."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = moe_capacity(cfg, t)
    xt = x.reshape(t, d)

    logits = dense(xt, params["router"]).to(torch.float32)  # (T, E)
    probs, gate_vals, expert_idx, slot, keep = moe_route(cfg, logits, cap)
    flat_e = expert_idx.reshape(-1)
    gates = gate_vals.reshape(-1) * keep
    src = torch.arange(t, device=x.device).repeat_interleave(k)

    # dispatch: kept assignments own unique (expert, slot) cells
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf[flat_e[keep], slot[keep].long()] = xt[src[keep]]

    yb = _expert_ffn(cfg, params["wi"], params["wo"], buf)  # (E, C, d)

    # combine: each token's k weighted contributions, added in index order
    safe_slot = torch.where(keep, slot, cap - 1).long()
    contrib = (yb[flat_e, safe_slot].to(torch.float32) * gates[:, None]) \
        .reshape(t, k, d)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + contrib[:, i]
    out = y.to(x.dtype)

    if cfg.n_shared_experts:
        out = out + mlp_apply(cfg, {"wi": params["shared_wi"],
                                    "wo": params["shared_wo"]}, xt)

    # Switch-style load-balance aux loss
    me = probs.mean(0)  # (E,) mean router prob
    ce = torch.bincount(flat_e[keep], minlength=e).to(torch.float32) \
        / max(t * k, 1)
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight
    return out.reshape(b, s, d), aux
