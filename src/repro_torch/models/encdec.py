"""Encoder-decoder transformer (the whisper-base backbone).

The port of ``repro/models/encdec.py``.  The conv/mel audio front end is
a stub, as in the reference: callers supply frame embeddings (B,
encoder_seq, d_model).  The encoder is bidirectional self-attention; the
decoder is causal self-attention plus cross-attention whose K/V are
computed once per layer from the encoder output at prefill time and
cached.  Whisper idioms kept: LayerNorm (gain ``1 + g``, zero bias),
GELU MLP, learned position embeddings, no RoPE.

Every matmul goes through :func:`dense` (kernel B1 on the card with an
L2R config); the encoder's self-attention, the prefill's causal
self-attention and every cross-attention go through
:func:`chunked_attention` (kernel B5 on the card where ``b5_fits``
holds: the cross-attention of a decode step is one launch at Sq = 1);
the decode step's self-attention is :func:`decode_attention`, plain
torch.  The stacked layers run as a Python loop over their leading
``layers`` axis (``layer_slice`` views, as ``lm_forward``), and the
state's caches are written in place.

Tensor parallelism (a ``ctx.model_shard`` scope, sharding/ctx.py): the
encoder's and decoder's attention layers, the cross-attention and the
GELU MLPs split as ``lm_forward``'s (models/transformer.py:attn_qkv,
attn_out; models/mlp.py): a rank's heads where the model axis divides
the kv heads, its self and cross caches holding them; the vocabulary
(51,865 for whisper-base) and the position tables stay whole.  With
``seq`` the decoder's residual stream holds this rank's part of the
sequence between blocks (the reference's ``resid_shard``); the encoder's
is whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.sharding import ctx
from repro_torch.sharding.collectives import gather_rows, split_rows

from .attention import (KVCache, chunked_attention, decode_attention,
                        init_kv_cache, update_kv_cache)
from .common import Param, layer_norm, tree_map
from .config import ModelConfig
from .mlp import mlp_apply, mlp_build
from .transformer import (_embed, attn_build, attn_out, attn_qkv,
                          cache_values, kv_layout, layer_slice, value_cols,
                          whole_values)

__all__ = ["encdec_build", "encdec_forward", "init_encdec_state",
           "EncDecState", "encode", "MAX_DEC_POSITIONS"]

MAX_DEC_POSITIONS = 32_768


def _ln(cfg: ModelConfig, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, 1.0 + g, torch.zeros_like(g), cfg.norm_eps)


def _enc_layer_build(cfg: ModelConfig) -> dict:
    return {
        "attn_norm": Param((cfg.d_model,), ("embed",), init="zeros"),
        "attn": attn_build(cfg),
        "ffn_norm": Param((cfg.d_model,), ("embed",), init="zeros"),
        "ffn": mlp_build(cfg),
    }


def _dec_layer_build(cfg: ModelConfig) -> dict:
    return {
        "self_norm": Param((cfg.d_model,), ("embed",), init="zeros"),
        "self": attn_build(cfg),
        "cross_norm": Param((cfg.d_model,), ("embed",), init="zeros"),
        "cross": attn_build(cfg),
        "ffn_norm": Param((cfg.d_model,), ("embed",), init="zeros"),
        "ffn": mlp_build(cfg),
    }


def _stack(n: int, tree):
    def s(p: Param) -> Param:
        return Param((n, *p.shape), ("layers", *p.axes), init=p.init,
                     scale=p.scale, dtype=p.dtype, held=p.held)
    return tree_map(s, tree)


def encdec_build(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "enc_pos": Param((cfg.encoder_seq, d), (None, "embed"), scale=0.02),
        "enc_stack": _stack(cfg.encoder_layers, _enc_layer_build(cfg)),
        "enc_norm": Param((d,), ("embed",), init="zeros"),
        "embed": Param((cfg.vocab, d), ("vocab", "embed"), init="embed"),
        "dec_pos": Param((MAX_DEC_POSITIONS, d), (None, "embed"),
                         scale=0.02),
        "dec_stack": _stack(cfg.n_layers, _dec_layer_build(cfg)),
        "dec_norm": Param((d,), ("embed",), init="zeros"),
    }


def _mha(cfg: ModelConfig, p: dict, xq: torch.Tensor, xkv: torch.Tensor, *,
         causal: bool, mode: str = "train", cache: KVCache | None = None,
         positions: torch.Tensor | None = None):
    """Plain (no RoPE) MHA of the encoder and the decoder's
    self-attention.  Returns (out, cache), the cache written in place in
    prefill and decode."""
    b, sq, _ = xq.shape
    (q, k, v), heads = attn_qkv(cfg, p, xq, xkv)
    if mode == "decode":
        cache = update_kv_cache(cache, k, cache_values(cfg, v), positions)
        out = whole_values(cfg, decode_attention(
            q, cache.k, cache.v, cache.positions, positions[:, 0],
            scale=cfg.attn_scale, kv_whole=cfg.n_kv,
            v_cols=value_cols(cfg)))
    else:
        if mode == "prefill":
            cache = update_kv_cache(cache, k, cache_values(cfg, v),
                                    positions)
        out = chunked_attention(q, k, v, causal=causal, scale=cfg.attn_scale)
    return attn_out(cfg, p, out.reshape(b, sq, -1), heads), cache


def _seq_whole(x: torch.Tensor) -> torch.Tensor:
    """A norm's output into a block: the whole sequence under sequence
    parallelism (``x`` this rank's part), else ``x``."""
    split = ctx.model_split()
    if split is not None and split.seq:
        return gather_rows(x, split.group, split.index, dim=1)
    return x


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, encoder_seq, d) precomputed embeddings (front-end
    stub) -> the encoder output (B, encoder_seq, d) in the compute
    dtype."""
    split = ctx.model_split()
    if split is not None and split.seq:  # the encoder's stream is whole
        with ctx.model_shard(split.mesh):
            return encode(cfg, params, frames)
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + params["enc_pos"][None, :x.shape[1]].to(x.dtype)
    for i in range(cfg.encoder_layers):
        lp = layer_slice(params["enc_stack"], i)
        h = _ln(cfg, x, lp["attn_norm"])
        x = x + _mha(cfg, lp["attn"], h, h, causal=False)[0]
        x = x + mlp_apply(cfg, lp["ffn"], _ln(cfg, x, lp["ffn_norm"]))
    return _ln(cfg, x, params["enc_norm"])


@dataclasses.dataclass
class EncDecState:
    """Serving state of the decoder."""

    self_cache: Any  # KVCache whose tensors lead with (n_layers,)
    cross_k: torch.Tensor  # (L, B, S_enc, Kv, dh)
    cross_v: torch.Tensor
    pos: torch.Tensor  # (B,) int32, next position to write


def init_encdec_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device | None = None
                      ) -> EncDecState:
    device = resolve_device(device)
    n = cfg.n_layers
    kv, kd, vd = kv_layout(cfg)
    c = init_kv_cache(batch, max_len, kv, kd, dtype, device=device,
                      v_head_dim=vd)
    # the cross caches: a rank's kv heads where the model axis divides
    # them, else whole (the cross-attention runs on whole heads)
    cross = (n, batch, cfg.encoder_seq, kv if vd == kd else cfg.n_kv,
             cfg.head_dim)
    return EncDecState(
        self_cache=KVCache(*(None if f is None else
                             f.expand(n, *f.shape).contiguous() for f in c)),
        cross_k=torch.zeros(cross, dtype=dtype, device=device),
        cross_v=torch.zeros(cross, dtype=dtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def encdec_forward(
    cfg: ModelConfig,
    params: dict,
    *,
    tokens: torch.Tensor,
    frames: torch.Tensor | None = None,
    enc_out: torch.Tensor | None = None,
    mode: str = "train",
    state: EncDecState | None = None,
    remat: bool = False,
):
    """Decoder forward (runs the encoder when ``enc_out`` is not given).

    Returns (hidden, new_state, aux = 0).  In decode the cross K/V come
    from the state (computed at prefill) and no frames are needed; in
    train and prefill they are computed from ``enc_out`` per layer, and
    prefill writes them into the state.  ``new_state`` holds the state's
    tensors, written in place, with ``pos`` advanced by S.  ``remat``
    checkpoints each decoder block (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` of its scanned block); the encoder is
    not checkpointed, as in the reference.
    """
    compute_dtype = getattr(torch, cfg.compute_dtype)
    b, s = tokens.shape
    if mode != "decode" and enc_out is None:
        assert frames is not None, "encoder frames required"
        enc_out = encode(cfg, params, frames)

    steps = torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
    positions = state.pos[:, None] + steps if state is not None \
        else steps.expand(b, s)

    # gather, then cast: the reference's cast-then-gather, elementwise
    x = _embed(cfg, params["embed"], tokens).to(compute_dtype)
    x = x + params["dec_pos"][positions.long()].to(compute_dtype)
    split = ctx.model_split()
    if split is not None and split.seq:  # this rank's part of the sequence
        x = split_rows(x, split.group, split.index, split.size, 1)

    def block(x, i):
        lp = layer_slice(params["dec_stack"], i)
        self_c = layer_slice(state.self_cache, i) if state is not None \
            else None
        xs = _seq_whole(_ln(cfg, x, lp["self_norm"]))
        out, _ = _mha(cfg, lp["self"], xs, xs, causal=True, mode=mode,
                      cache=self_c, positions=positions)
        x = x + out
        # cross-attention
        xq = _seq_whole(_ln(cfg, x, lp["cross_norm"]))
        if mode == "decode":
            (q,), heads = attn_qkv(cfg, lp["cross"], xq, xq, "q")
            k_enc, v_enc = state.cross_k[i], state.cross_v[i]
        else:
            (q, k_enc, v_enc), heads = attn_qkv(cfg, lp["cross"], xq,
                                                enc_out)
            if state is not None:
                state.cross_k[i].copy_(k_enc)
                state.cross_v[i].copy_(v_enc)
        attn = chunked_attention(q, k_enc.to(x.dtype), v_enc.to(x.dtype),
                                 causal=False, scale=cfg.attn_scale)
        x = x + attn_out(cfg, lp["cross"], attn.reshape(b, s, -1), heads)
        return x + mlp_apply(cfg, lp["ffn"],
                             _seq_whole(_ln(cfg, x, lp["ffn_norm"])))

    scope = ctx.snapshot()

    def block_in_scope(x, i):
        # the backward recomputes the block after the caller's scopes have
        # exited: it re-enters them
        with ctx.restored(scope):
            return block(x, i)

    for i in range(cfg.n_layers):
        x = checkpoint(block_in_scope, x, i, use_reentrant=False) if remat \
            else block(x, i)
    x = _ln(cfg, x, params["dec_norm"])
    if split is not None and split.seq:
        x = gather_rows(x, split.group, split.index, dim=1)

    new_state = None
    if state is not None:
        new_state = dataclasses.replace(state, pos=state.pos + s)
    return x, new_state, torch.zeros((), dtype=torch.float32,
                                     device=x.device)
