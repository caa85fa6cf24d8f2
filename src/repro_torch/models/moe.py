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
cache).

Under a mesh (sharding/ctx.py) the reference's global semantics hold.
Where this rank's activations are its rows of the global batch
(``ctx.row_axes()``, the data-parallel train step and the ``"batch"``
serving layout), :func:`moe_apply` takes the capacity from the global
token count, offsets each assignment's slot by the assignments to its
expert on lower data ranks (an all-gather of E counts) and takes the
aux loss from global means.  With ``cfg.moe_dp_local``
(:func:`moe_apply_dp_local`) each rank routes one group of the flat
global tokens on its own, exchanging expert buffers with its model
group.

With the backbone split over ``model`` (a ``ctx.model_shard`` scope,
params from sharding/axes.py:shard_params) the routed experts lie on the
model axis: routing and capacity stay replicated within the model
group, each model rank runs its E/m experts on its slice of the (E, C,
d) buffer, and the outputs are all-gathered over the model group and
combined in index order as without a mesh (a sum of partial outputs
would reassociate the combine).  The shared experts are models/mlp.py's
tensor-parallel MLP.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import no_tf32
from repro_torch.kernels.l2r_gemm.ops import l2r_matmul_f
from repro_torch.sharding import ctx
from repro_torch.sharding.collectives import (all_gather, all_to_all,
                                              gather_rows, split_rows,
                                              sum_forward)

from .common import Param, dense
from .config import ModelConfig
from .mlp import mlp_act, mlp_apply

__all__ = ["moe_build", "moe_apply", "moe_capacity", "moe_route",
           "moe_apply_dp_local", "shard_experts"]


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


def moe_route(cfg: ModelConfig, logits: torch.Tensor, cap: int,
              offset_fn=None):
    """Router logits (T, E) f32 -> (probs (T, E), gate_vals (T, k),
    expert_idx (T, k), slot (T*k,), keep (T*k,)): the top-k in
    descending order, lower index first on ties; slot is the exclusive
    count of earlier assignments (token-major, choice-minor) to the same
    expert, kept while below ``cap``.  ``offset_fn`` maps the flat
    expert choices (T*k,) to a per-expert count (E,) int32 added to every
    slot: the assignments of tokens before these ones."""
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
    if offset_fn is not None:
        slot = slot + offset_fn(flat_e)[flat_e]
    return probs, gate_vals, expert_idx, slot, slot < cap


def _dp_groups(t: int) -> int:
    """Shard-local dispatch groups of ``t`` global tokens: the installed
    mesh's size when it divides ``t`` (the flat token dim split over
    every axis), else 1; 1 without a mesh."""
    mesh = ctx.get_mesh()
    if mesh is None:
        return 1
    n = mesh.size
    return n if n > 1 and t % n == 0 else 1


def _split_experts(cfg: ModelConfig, params: dict, buf: torch.Tensor
                   ) -> torch.Tensor:
    """The experts' (E, C, d) outputs on ``buf``: in a ``ctx.model_shard``
    scope whose params hold this rank's E/m experts, each model rank
    runs them on its slice of ``buf`` and the outputs are gathered over
    the model group (the gradient of the slice gathered, of the gather
    kept to the slice: every rank of the group holds the whole ``buf``
    and takes the whole output on)."""
    wi, wo = params["wi"], params["wo"]
    split = ctx.model_split()
    if split is None or wi.shape[0] == cfg.n_experts:
        return _expert_ffn(cfg, wi, wo, buf)
    mine = split_rows(buf, split.group, split.index, split.size)
    return gather_rows(_expert_ffn(cfg, wi, wo, mine), split.group,
                       split.index)


def _dispatch(cfg: ModelConfig, xt, probs_etc, cap: int):
    """(E, C, d) expert buffers of the kept assignments, and the combine
    that takes the experts' (E, C, d) outputs back to (T, d) f32: each
    token's k weighted contributions added in index order."""
    t, d = xt.shape
    k = cfg.experts_per_token
    _, gate_vals, expert_idx, slot, keep = probs_etc
    flat_e = expert_idx.reshape(-1)
    gates = gate_vals.reshape(-1) * keep
    src = torch.arange(t, device=xt.device).repeat_interleave(k)
    # kept assignments own unique (expert, slot) cells
    buf = torch.zeros((cfg.n_experts, cap, d), dtype=xt.dtype,
                      device=xt.device)
    buf[flat_e[keep], slot[keep].long()] = xt[src[keep]]
    safe_slot = torch.where(keep, slot, cap - 1).long()

    def combine(yb):
        contrib = (yb[flat_e, safe_slot].to(torch.float32)
                   * gates[:, None]).reshape(t, k, d)
        y = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
        for i in range(k):
            y = y + contrib[:, i]
        return y

    return buf, combine


def _shared(cfg: ModelConfig, params: dict, xt, out):
    if cfg.n_shared_experts:
        out = out + mlp_apply(cfg, {"wi": params["shared_wi"],
                                    "wo": params["shared_wo"]}, xt,
                              (cfg.moe_d_ff or cfg.d_ff)
                              * cfg.n_shared_experts)
    return out


def _aux(cfg: ModelConfig, me, kept, n_assign: int):
    """Switch-style load-balance aux loss from the mean router probs (E,)
    and the kept assignments per expert (E,) f32."""
    ce = kept / max(n_assign, 1)
    return cfg.n_experts * torch.sum(me * ce) * cfg.router_aux_weight


def moe_apply(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss (f32 scalar)).  Routed top-k plus
    the optional shared experts, and the Switch-style load-balance aux
    loss.  With ``cfg.moe_dp_local`` under a mesh whose size divides the
    global token count, :func:`moe_apply_dp_local`."""
    b, s, d = x.shape
    t = b * s
    mesh, rows = ctx.get_mesh(), ctx.row_axes()
    n_rows = ctx.mesh_axis_size(mesh, rows)
    if cfg.moe_dp_local and _dp_groups(t * n_rows) > 1:
        return moe_apply_dp_local(cfg, params, x)
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = moe_capacity(cfg, t * n_rows)
    xt = x.reshape(t, d)
    offset_fn = None
    if rows:  # slots count the assignments on lower data ranks first
        group, idx = mesh.group(rows), mesh.index(rows)

        def offset_fn(flat_e):
            counts = torch.bincount(flat_e, minlength=e).to(torch.int32)
            return all_gather(counts[None], group, dim=0)[:idx].sum(
                0, dtype=torch.int32)

    logits = dense(xt, params["router"]).to(torch.float32)  # (T, E)
    routed = moe_route(cfg, logits, cap, offset_fn)
    probs, _, expert_idx, _, keep = routed
    buf, combine = _dispatch(cfg, xt, routed, cap)
    yb = _split_experts(cfg, params, buf)  # (E, C, d)
    out = _shared(cfg, params, xt, combine(yb).to(x.dtype))

    flat_e = expert_idx.reshape(-1)
    kept = torch.bincount(flat_e[keep], minlength=e).to(torch.float32)
    if rows:  # global means; each rank's gradient covers its own tokens
        both = sum_forward(torch.cat([probs.sum(0), kept]), group)
        me, kept = both[:e] / (t * n_rows), both[e:]
    else:
        me = probs.mean(0)  # (E,) mean router prob
    aux = _aux(cfg, me, kept, t * n_rows * k)
    return out.reshape(b, s, d), aux


def _local_experts(w: torch.Tensor, e: int, m: int, j: int):
    """Model rank ``j``'s slice of an expert stack (E/m experts), from a
    whole stack or the slice itself (:func:`shard_experts`)."""
    if w.shape[0] == e // m:
        return w
    if w.shape[0] == e:
        return w[j * (e // m):(j + 1) * (e // m)]
    raise ValueError(f"an expert stack of {w.shape[0]} experts: neither "
                     f"all {e} nor a model rank's {e // m}")


def moe_apply_dp_local(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """DP-local-capacity MoE under the installed mesh: each rank routes
    one group of the flat (batch x seq) tokens on its own.

    The flat global tokens are split into one group a rank, in rank
    order: rank (d, m) of a (data, model) mesh takes group ``d * M + m``,
    the ``m``-th of its data rank's rows where those are its own
    (``ctx.row_axes()``), else of the whole batch.  Routing, capacity
    (``moe_capacity(T / G)``), dispatch, the shared experts and the
    combine are the group's alone, so a group's output equals
    ``moe_apply`` without a mesh on that group's tokens.  The experts
    live on the model axis: the rank holds E/M of them (a stack of
    :func:`shard_experts`, or its slice of a whole one), sends each model
    rank its experts' part of the group's (E, C, d) buffer
    (:func:`all_to_all` over the model group), runs its experts on the M
    buffers it receives, one group at a time, and sends the outputs back.
    The group outputs are gathered over the axes that split the rows, so
    every rank returns its whole rows.  The aux loss takes the router's
    mean probs and kept counts summed over the whole mesh.  With the
    backbone split over ``model`` (``ctx.model_split()``) the shared
    experts, tensor-parallel, run on the gathered rows instead of each
    group's.
    """
    mesh, rows = ctx.get_mesh(), ctx.row_axes()
    split = tuple(a for a in mesh.axis_names if a not in rows)
    n_split = ctx.mesh_axis_size(mesh, split)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t_g = b * s // n_split
    cap = moe_capacity(cfg, t_g)
    xt = x.reshape(b * s, d)
    if n_split > 1:
        sgroup, sidx = mesh.group(split), mesh.index(split)
        xt = split_rows(xt, sgroup, sidx, n_split)

    logits = dense(xt, params["router"]).to(torch.float32)
    routed = moe_route(cfg, logits, cap)
    probs, _, expert_idx, _, keep = routed
    buf, combine = _dispatch(cfg, xt, routed, cap)
    m = mesh.shape.get("model", 1)
    if m > 1 and e % m == 0:
        j = mesh.index("model")
        wi, wo = (_local_experts(params[n], e, m, j) for n in ("wi", "wo"))
        mgroup = mesh.group("model")
        recv = all_to_all(buf.reshape(m, e // m, cap, d), mgroup)
        yb = torch.stack([_expert_ffn(cfg, wi, wo, recv[i])
                          for i in range(m)])
        yb = all_to_all(yb, mgroup).reshape(e, cap, d)
    else:
        yb = _expert_ffn(cfg, params["wi"], params["wo"], buf)
    out = combine(yb).to(x.dtype)
    if ctx.model_split() is not None:
        # the shared experts are tensor-parallel: they run on the rows
        # every rank of the model group holds, after the gather
        if n_split > 1:
            out = gather_rows(out, sgroup, sidx)
        out = _shared(cfg, params, x.reshape(b * s, d), out)
    else:
        out = _shared(cfg, params, xt, out)
        if n_split > 1:
            out = gather_rows(out, sgroup, sidx)

    kept = torch.bincount(expert_idx.reshape(-1)[keep], minlength=e) \
        .to(torch.float32)
    both = sum_forward(torch.cat([probs.sum(0), kept]),
                       mesh.group(mesh.axis_names))
    t = t_g * mesh.size
    aux = _aux(cfg, both[:e] / t, both[e:], t * k)
    return out.reshape(b, s, d), aux


def shard_experts(cfg: ModelConfig, params, mesh):
    """``params`` with every routed-expert stack (the ``wi`` and ``wo`` of
    a MoE layer: logical axis ``experts`` -> "model",
    sharding/axes.py:PARAM_RULES) cut to this rank's E/M experts over
    ``mesh``'s model axis, copied (so the whole stack can be freed); a
    stacked layer's leading ``layers`` axis stays whole.  The rest of the
    tree is returned as is.  For :func:`moe_apply_dp_local`."""
    m = mesh.shape.get("model", 1)
    e = cfg.n_experts
    if m <= 1 or e % m:
        return params
    j = mesh.index("model")
    glu = cfg.ffn_kind in ("swiglu", "geglu")

    def cut(w: torch.Tensor, rank: int) -> torch.Tensor:
        # rank: the unstacked leaf's (E, d, [2,] f) or (E, f, d)
        return w.narrow(w.ndim - rank, j * (e // m), e // m).clone()

    def walk(t):
        if isinstance(t, dict):
            if "router" in t:
                return {**t, "wi": cut(t["wi"], 4 if glu else 3),
                        "wo": cut(t["wo"], 3)}
            return {key: walk(v) for key, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(params)
