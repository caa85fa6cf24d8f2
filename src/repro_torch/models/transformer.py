"""Decoder-LM assembly: pattern-based layers, stacked blocks, caches.

The port of ``repro/models/transformer.py``.  An architecture is a
per-layer sequence of (mixer, ffn) kinds (ModelConfig.layer_kinds):
mixers are ``global`` / ``local`` attention, ``ssd`` (Mamba-2,
models/ssm.py) and ``rec`` (RG-LRU, models/rglru.py); ffns are ``mlp``
and ``moe`` (models/moe.py).  Layers are grouped into the smallest
repeating unit whose params carry a leading ``layers`` axis (the
reference's ``lax.scan`` layout), with aperiodic prefix/suffix layers
apart.  Here the scan is a Python loop over that axis: each step takes
the layer's slice of the params and of the stacked caches as views, and
the caches are written in place: a KV cache by its update, a recurrent
state (a dict of tensors) by copying the mixer's new state into it.

Three modes:
  train   — full sequence, no cache;
  prefill — full sequence, writes caches;
  decode  — one token against caches.

Tensor parallelism (the reference's ``param_specs`` over ``model``,
written by hand as Megatron's): in a ``ctx.model_shard`` scope
(sharding/ctx.py) the params are this rank's slices
(sharding/axes.py:shard_params).  Attention runs on the rank's heads
where the model axis divides the kv heads (its kv heads and their q
heads, contiguous columns of wq, wk, wv; its KV caches hold only them),
``wo`` row-parallel.  Where it does not, the rank's columns of q, k and
v are gathered over the model group (a projection the layout keeps whole
gives them whole), every rank runs the whole attention (B5 / B4 on whole
heads, as one process) and keeps its rows' part of the output for
``wo``; its KV caches then take the head_dim layout where the axis
divides head_dim (:func:`kv_layout`: every kv head, the whole keys and
the plane-stacked keys, its ``dh / m`` of the values; decode's PV runs
on that slice and the slices are gathered), else stay whole.  The SSD and
RG-LRU mixers split as models/ssm.py and models/rglru.py say, the MLP is
models/mlp.py's, MoE models/moe.py's; a block whose weights the layout
keeps whole runs whole (models/common.py:residual_dense); the embedding
lookup takes each token's row from the rank that holds it.  With
``seq`` the residual stream between blocks holds this rank's part of
the sequence: norms run on it, it is gathered before a block's
column-parallel products and reduce-scattered after its row-parallel
ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quant import QuantizedWeights
from repro_torch.device import resolve_device
from repro_torch.sharding import ctx
from repro_torch.sharding.collectives import (all_gather, copy_in,
                                              gather_columns, gather_rows,
                                              split_rows)

from .attention import (KVCache, apply_rope, chunked_attention,
                        decode_attention, init_kv_cache, update_kv_cache)
from .common import (Param, dense, layer_norm, leading, out_width,
                     residual_dense, rms_norm, tree_map)
from .config import ModelConfig
from .mlp import mlp_apply, mlp_build
from .moe import moe_apply, moe_build
from .rglru import init_rglru_state, rglru_apply, rglru_build, rglru_decode
from .ssm import init_ssm_state, ssm_apply, ssm_build, ssm_decode

__all__ = [
    "attn_build",
    "attn_apply",
    "layer_build",
    "layer_apply",
    "layer_norm_fn",
    "lm_build",
    "lm_forward",
    "logits_from_hidden",
    "init_lm_state",
    "layer_slice",
    "LMState",
    "local_kv_heads",
    "kv_layout",
    "attn_qkv",
]


def kv_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(kv heads, the keys' head width, the values' head width) of a
    rank's KV caches.  Whole; in a ``ctx.model_shard`` scope its ``n_kv /
    m`` kv heads where the model axis divides them; else the head_dim
    layout where it divides head_dim: every kv head, the keys whole (a
    float QK^T summed over slices of dh would reassociate) and the
    values' ``dh / m`` (PV's sum runs over the keys, not dh); else
    whole."""
    kv, dh = cfg.n_kv, cfg.head_dim
    split = ctx.model_split()
    if split is None:
        return kv, dh, dh
    if kv % split.size == 0:
        return kv // split.size, dh, dh
    if dh % split.size == 0:
        return kv, dh, dh // split.size
    return kv, dh, dh


def local_kv_heads(cfg: ModelConfig) -> int:
    """The kv heads a rank's attention runs on and its KV caches hold
    (:func:`kv_layout`)."""
    return kv_layout(cfg)[0]


def attn_qkv(cfg: ModelConfig, p: dict, xq: torch.Tensor,
             xkv: torch.Tensor, names: str = "qkv", rope_positions=None):
    """The projections ``names`` of an attention layer as (B, S, heads,
    dh) tensors, and whether the layer runs on this rank's heads.  In a
    ``ctx.model_shard`` scope: where the model axis divides the kv heads,
    this rank's heads (its q heads those of its kv heads); else each
    projection whole, gathered over the model group where its weight is
    this rank's columns (whose gradient then takes the rank's part back,
    summed over the ranks through ``copy_in``: a whole weight's input is
    not, every rank computing its whole gradient)."""
    split = ctx.model_split()
    heads = split is None or cfg.n_kv % split.size == 0
    n = {"q": cfg.n_heads, "k": cfg.n_kv, "v": cfg.n_kv}
    dh = cfg.head_dim
    x_in = {}
    out = []
    for name in names:
        w = p["w" + name]
        x = xq if name == "q" else xkv
        cut = split is not None and out_width(w) != n[name] * dh
        if cut:
            if id(x) not in x_in:
                x_in[id(x)] = copy_in(x, split.group)
            x = x_in[id(x)]
        y = dense(x, w, cfg.l2r, cfg.l2r_levels)
        if "b" + name in p:
            y = y + p["b" + name].to(y.dtype)
        if cut and not heads:
            y = gather_rows(y, split.group, split.index, dim=-1)
        out.append(y.reshape(x.shape[0], x.shape[1], -1, dh))
    if rope_positions is not None:
        out = [apply_rope(t, rope_positions, cfg.rope_theta, cfg.rope_mode,
                          cfg.mrope_sections) if name in "qk" else t
               for name, t in zip(names, out)]
    return out, heads


def attn_out(cfg: ModelConfig, p: dict, out: torch.Tensor, heads: bool
             ) -> torch.Tensor:
    """``wo`` of the attention output (B, S, H_local * dh): row-parallel on
    this rank's heads; a whole output (the rank ran every head) gives the
    rank's rows' part to a split ``wo``, or goes whole to a whole one."""
    split = ctx.model_split()
    k_whole = cfg.n_heads * cfg.head_dim
    if not heads and leading(p["wo"]) != k_whole:
        out = split_rows(out, split.group, split.index, split.size, dim=-1)
    return residual_dense(out, p["wo"], cfg.l2r, cfg.l2r_levels, k_whole)


def cache_values(cfg: ModelConfig, v: torch.Tensor) -> torch.Tensor:
    """The part of whole values ``v`` (..., dh) a rank's cache holds in
    the head_dim layout (:func:`kv_layout`), else ``v``."""
    vd = kv_layout(cfg)[2]
    if vd == v.shape[-1]:
        return v
    i = ctx.model_split().index
    return v[..., i * vd:(i + 1) * vd]


def value_cols(cfg: ModelConfig) -> tuple | None:
    """(offset, dh) of a rank's value slice in the head_dim layout, else
    None (models/attention.py:decode_attention's ``v_cols``)."""
    vd = kv_layout(cfg)[2]
    if vd == cfg.head_dim:
        return None
    return ctx.model_split().index * vd, cfg.head_dim


def whole_values(cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """Decode attention's output on the head_dim layout's value slices
    (B, 1, H, dh / m), all-gathered into whole heads; else ``out``."""
    if out.shape[-1] == cfg.head_dim:
        return out
    split = ctx.model_split()
    return gather_rows(out, split.group, split.index, dim=-1)


# --------------------------------------------------------------- attention
def attn_build(cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "wq": Param((d, h * dh), ("embed", "qkv")),
        "wk": Param((d, kv * dh), ("embed", "qkv")),
        "wv": Param((d, kv * dh), ("embed", "qkv")),
        "wo": Param((h * dh, d), ("qkv", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = Param((h * dh,), ("qkv",), init="zeros")
        p["bk"] = Param((kv * dh,), ("qkv",), init="zeros")
        p["bv"] = Param((kv * dh,), ("qkv",), init="zeros")
    return p


def attn_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    mode: str,
    rope_positions: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache | None,
    window: int | None,
):
    """Self-attention layer.  Returns (out, cache), the cache written in
    place in prefill and decode.  With ``cfg.attn_l2r`` the scores run
    digit-serially: the prefill fills the plane-stacked key cache and
    runs ``chunked_attention(l2r=)``; decode appends, then walks the
    cache's planes (``attn_levels``, ``attn_early_exit``,
    ``attn_exit_tol``)."""
    b, s, _ = x.shape
    (q, k, v), heads = attn_qkv(cfg, p, x, x, rope_positions=rope_positions)
    if mode == "decode":
        cache = update_kv_cache(cache, k, cache_values(cfg, v), positions,
                                quant=cfg.attn_l2r)
        out = whole_values(cfg, decode_attention(
            q, cache.k, cache.v, cache.positions, positions[:, 0],
            window=window, scale=cfg.attn_scale, softcap=cfg.logit_softcap,
            l2r=cfg.attn_l2r, levels=cfg.attn_levels,
            early_exit=cfg.attn_early_exit, exit_tol=cfg.attn_exit_tol,
            k_planes=cache.k_planes, k_scale=cache.k_scale,
            kv_whole=cfg.n_kv, v_cols=value_cols(cfg)))
    else:
        if mode == "prefill":
            # a plane-stacked cache fills here too: the decode steps after
            # this prefill read a ready operand
            cache = update_kv_cache(cache, k, cache_values(cfg, v),
                                    positions, quant=cfg.attn_l2r)
        out = chunked_attention(
            q, k, v, causal=True, window=window, scale=cfg.attn_scale,
            softcap=cfg.logit_softcap,
            score_dtype=getattr(torch, cfg.attn_score_dtype),
            head_shard=cfg.attn_head_shard,
            l2r=cfg.attn_l2r, levels=cfg.attn_levels)
    return attn_out(cfg, p, out.reshape(b, s, -1), heads), cache


# ------------------------------------------------------------ layer dispatch
def _mixer_build(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("global", "local"):
        return attn_build(cfg)
    if kind == "ssd":
        return ssm_build(cfg)
    if kind == "rec":
        return rglru_build(cfg)
    raise ValueError(kind)


def _ffn_build(cfg: ModelConfig, kind: str) -> dict:
    if kind == "moe":
        return moe_build(cfg)
    # MoE models use a wider hidden on their dense layers
    if cfg.n_experts and cfg.dense_d_ff:
        return mlp_build(cfg, d_ff=cfg.dense_d_ff)
    return mlp_build(cfg)


def layer_build(cfg: ModelConfig, kinds: tuple[str, str]) -> dict:
    mixer, ffn = kinds
    out = {
        "mixer_norm": Param((cfg.d_model,), ("embed",), init="zeros"),
        "mixer": _mixer_build(cfg, mixer),
    }
    if ffn != "none":
        out["ffn_norm"] = Param((cfg.d_model,), ("embed",), init="zeros")
        out["ffn"] = _ffn_build(cfg, ffn)
    return out


def _mixer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype: torch.dtype, device) -> KVCache | dict:
    """A KV cache in ``dtype`` for attention; an f32 state dict for
    ``ssd`` and ``rec`` whatever ``dtype`` says, as in the reference."""
    if kind in ("global", "local"):
        kv, kd, vd = kv_layout(cfg)
        length = max_len if kind == "global" else min(cfg.window, max_len)
        return init_kv_cache(batch, length, kv, kd, dtype,
                             quant=cfg.attn_l2r, device=device,
                             v_head_dim=vd)
    if kind == "ssd":
        return init_ssm_state(cfg, batch, device=device)
    if kind == "rec":
        return init_rglru_state(cfg, batch, device=device)
    raise ValueError(kind)


def layer_apply(
    cfg: ModelConfig,
    params: dict,
    kinds: tuple[str, str],
    x: torch.Tensor,
    *,
    mode: str,
    rope_positions: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache | dict | None,
):
    """One (mixer + ffn) residual layer.  Returns (x, cache, aux): aux is
    the MoE router loss (an f32 scalar tensor), 0.0 for other ffns.  In
    prefill and decode a recurrent state is written in place: the
    mixer's new tensors are copied into ``cache``'s."""
    mixer_kind, ffn_kind = kinds
    norm = layer_norm_fn(cfg)
    split = ctx.model_split()
    seq = split is not None and split.seq
    h = norm(x, params["mixer_norm"])
    if seq:  # the whole sequence into the column-parallel products
        h = gather_rows(h, split.group, split.index, dim=1)
    if mixer_kind in ("global", "local"):
        mixed, cache = attn_apply(
            cfg, params["mixer"], h, mode=mode,
            rope_positions=rope_positions, positions=positions, cache=cache,
            window=cfg.window if mixer_kind == "local" else None)
    elif mixer_kind in ("ssd", "rec"):
        apply, decode = (ssm_apply, ssm_decode) if mixer_kind == "ssd" \
            else (rglru_apply, rglru_decode)
        if mode == "decode":
            mixed, new = decode(cfg, params["mixer"], h, cache)
        else:
            mixed, new = apply(cfg, params["mixer"], h,
                               cache if mode == "prefill" else None)
        if cache is None:
            cache = new
        else:
            for key, t in new.items():
                cache[key].copy_(t)
    else:
        raise ValueError(mixer_kind)
    x = x + mixed
    aux = 0.0
    if ffn_kind != "none":
        h = norm(x, params["ffn_norm"])
        if seq:
            h = gather_rows(h, split.group, split.index, dim=1)
        if ffn_kind == "moe" and seq:
            # routing sees the whole sequence, replicated over the model
            # group; the rank keeps its part of the output
            with ctx.model_shard(split.mesh):
                out, aux = moe_apply(cfg, params["ffn"], h)
            out = split_rows(out, split.group, split.index, split.size, 1)
        elif ffn_kind == "moe":
            out, aux = moe_apply(cfg, params["ffn"], h)
        else:
            out = mlp_apply(cfg, params["ffn"], h,
                            cfg.dense_d_ff if cfg.n_experts
                            and cfg.dense_d_ff else cfg.d_ff)
        x = x + out
    return x, cache, aux


def layer_norm_fn(cfg: ModelConfig) -> Callable:
    if cfg.use_layer_norm:
        return lambda x, g: layer_norm(x, 1.0 + g, torch.zeros_like(g),
                                       cfg.norm_eps)
    return lambda x, g: rms_norm(x, g, cfg.norm_eps)


# --------------------------------------------------------------- LM assembly
def lm_build(cfg: ModelConfig) -> dict:
    prefix, repeats, unit, suffix = cfg.block_grouping()
    params: dict[str, Any] = {
        "embed": Param((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       init="embed"),
        "final_norm": Param((cfg.d_model,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        params["head"] = Param((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                               scale=0.02)
    params["prefix"] = [layer_build(cfg, kk) for kk in prefix]
    if repeats:
        # every leaf gets a leading "layers" axis of size `repeats`
        def stack_param(p: Param) -> Param:
            return Param((repeats, *p.shape), ("layers", *p.axes),
                         init=p.init, scale=p.scale, dtype=p.dtype,
                         held=p.held)
        params["stack"] = tree_map(stack_param,
                                   [layer_build(cfg, kk) for kk in unit])
    params["suffix"] = [layer_build(cfg, kk) for kk in suffix]
    return params


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree: every tensor's, weight cache's and
    KV cache's leading axis indexed, as views (writes reach the stack)."""
    if tree is None:
        return None
    if isinstance(tree, KVCache):
        return KVCache(*(None if f is None else f[i] for f in tree))
    if isinstance(tree, QuantizedWeights):
        planes = tree.planes
        if planes is not None:
            planes = dataclasses.replace(planes, stack=planes.stack[i])
        return dataclasses.replace(tree, q=tree.q[i], scale=tree.scale[i],
                                   planes=planes)
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [layer_slice(v, i) for v in tree]
    return tree[i]


@dataclasses.dataclass
class LMState:
    """Serving state: caches grouped like the params + next position."""

    prefix: list
    stack: Any  # per unit layer, a KVCache or state dict whose tensors
    #             lead with (repeats,)
    suffix: list
    pos: torch.Tensor  # (B,) int32, next position to write


def init_lm_state(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: str | torch.device | None = None) -> LMState:
    prefix, repeats, unit, suffix = cfg.block_grouping()
    device = resolve_device(device)

    def mk(kk, lead=()):
        c = _mixer_cache(cfg, kk[0], batch, max_len, dtype, device)
        if isinstance(c, dict):
            return {k: v.expand(*lead, *v.shape).contiguous()
                    for k, v in c.items()}
        return KVCache(*(None if f is None else
                         f.expand(*lead, *f.shape).contiguous() for f in c))

    return LMState(
        prefix=[mk(kk) for kk in prefix],
        stack=[mk(kk, (repeats,)) for kk in unit] if repeats else None,
        suffix=[mk(kk) for kk in suffix],
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def lm_forward(
    cfg: ModelConfig,
    params: dict,
    *,
    tokens: torch.Tensor | None = None,
    embeds: torch.Tensor | None = None,
    rope_positions: torch.Tensor | None = None,
    mode: str = "train",
    state: LMState | None = None,
    remat: bool = False,
):
    """Backbone forward.

    Returns (hidden (B, S, d), new_state, aux_loss): aux_loss is the MoE
    router losses summed over layers (an f32 scalar).  ``tokens`` xor
    ``embeds``.  In prefill and decode the caches of ``state`` are
    written in place and ``new_state`` holds the same caches with
    ``pos`` advanced by S.  ``remat`` checkpoints each block of the
    stacked layers (``torch.utils.checkpoint``; the reference's
    ``jax.checkpoint`` of its scanned block): one block's activations
    live in the backward, which runs the block's forward again, so a
    kernel under it launches twice a step.  Prefix and suffix layers
    are not checkpointed, as in the reference.
    """
    prefix_k, repeats, unit, suffix_k = cfg.block_grouping()
    compute_dtype = getattr(torch, cfg.compute_dtype)
    if embeds is None:
        # gather, then cast: the reference's cast-then-gather, elementwise
        x = _embed(cfg, params["embed"], tokens).to(compute_dtype)
    else:
        x = embeds.to(compute_dtype)
    if cfg.scale_embeddings:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=compute_dtype,
                           device=x.device)

    b, s = x.shape[:2]
    steps = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    positions = state.pos[:, None] + steps if state is not None \
        else steps.expand(b, s)
    if rope_positions is None:
        rope_positions = positions

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    split = ctx.model_split()
    seq = split is not None and split.seq
    if seq:  # the residual stream holds this rank's part of the sequence
        x = split_rows(x, split.group, split.index, split.size, 1)

    def run_layer(x, lp, kinds, cache):
        return layer_apply(cfg, lp, kinds, x, mode=mode,
                           rope_positions=rope_positions,
                           positions=positions, cache=cache)

    new_prefix = []
    for i, kk in enumerate(prefix_k):
        c = state.prefix[i] if state is not None else None
        x, c2, aux = run_layer(x, params["prefix"][i], kk, c)
        new_prefix.append(c2)
        aux_total += aux

    def block(x, aux_acc, blk):
        for u_idx, kk in enumerate(unit):
            c = layer_slice(state.stack[u_idx], blk) \
                if state is not None else None
            x, _, aux = run_layer(x, layer_slice(params["stack"][u_idx], blk),
                                  kk, c)
            aux_acc = aux_acc + aux
        return x, aux_acc

    scope = ctx.snapshot()

    def block_in_scope(x, aux_acc, blk):
        # the backward recomputes the block after the caller's scopes
        # (the rows', the model split) have exited: it re-enters them
        with ctx.restored(scope):
            return block(x, aux_acc, blk)

    for blk in range(repeats):  # the reference's scan over the stack
        if remat:
            x, aux_total = checkpoint(block_in_scope, x, aux_total, blk,
                                      use_reentrant=False)
        else:
            x, aux_total = block(x, aux_total, blk)

    new_suffix = []
    for i, kk in enumerate(suffix_k):
        c = state.suffix[i] if state is not None else None
        x, c2, aux = run_layer(x, params["suffix"][i], kk, c)
        new_suffix.append(c2)
        aux_total += aux

    x = layer_norm_fn(cfg)(x, params["final_norm"])
    if seq:
        x = gather_rows(x, split.group, split.index, dim=1)

    new_state = None
    if state is not None:
        new_state = LMState(prefix=new_prefix, stack=state.stack,
                            suffix=new_suffix, pos=state.pos + s)
    return x, new_state, aux_total


def _embed(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor
           ) -> torch.Tensor:
    """The rows of ``tokens`` in the embedding ``table``; a vocab-split
    table (this rank's ``V / m`` rows in a ``ctx.model_shard`` scope)
    looks up the tokens it holds, the ranks' lookups are gathered and
    each token takes its owner's row (a select: a float sum with the
    other ranks' zeros would turn -0.0 into +0.0)."""
    t = tokens.long()
    split = ctx.model_split()
    if split is None or table.shape[0] == cfg.vocab:
        return table[t]
    v_l = table.shape[0]
    off = split.index * v_l
    own = (t >= off) & (t < off + v_l)
    mine = table[torch.where(own, t - off, torch.zeros_like(t))]
    rows = gather_rows(mine[None], split.group, split.index, dim=0)
    owner = (t // v_l)[None, ..., None].expand(1, *t.shape, table.shape[1])
    return torch.gather(rows, 0, owner)[0]


def logits_from_hidden(cfg: ModelConfig, params: dict, hidden: torch.Tensor
                       ) -> torch.Tensor:
    """LM head.  With an L2R config the head matmul runs through the
    digit-plane pipeline like every other matmul; a ``head_q`` cache
    entry (serve/engine.py:prepare_params) skips the per-step head-weight
    quantization; a vocab-sharded one (``prepare_params(mesh=)``) gives
    this rank's columns, gathered over its mesh axis."""
    if cfg.l2r is not None and "head_q" in params:
        head_q = params["head_q"]
        return gather_columns(dense(hidden, head_q, cfg.l2r, cfg.l2r_levels),
                              head_q.shard)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = dense(hidden, w.to(hidden.dtype), cfg.l2r, cfg.l2r_levels)
    split = ctx.model_split()
    if split is not None and w.shape[-1] != cfg.vocab:  # vocab-split
        logits = all_gather(logits, split.group, dim=-1)
    return logits
