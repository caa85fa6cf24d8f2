"""Serving engine: load-time weight preparation, the prefill and decode
step factories, batched greedy decoding.

The port of the non-progressive core of ``repro/serve/engine.py`` for
LM families on one card.  The progressive head stream
(``progressive=True``, ``progressive_logits_from_hidden``, kernel B2 on
the LM head), bucketed prefill, the batcher, the gateway and the
sharding of caches and head are ROADMAP A11 and A13; asking for
``progressive`` raises.  PyTorch runs eagerly, so the factories return
plain functions where the reference returns functions to ``jax.jit``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.quant import QuantizedWeights, quantize_weights
from repro_torch.models.common import quantize_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (init_lm_state, lm_build,
                                            lm_forward, logits_from_hidden)

__all__ = ["prepare_params", "make_prefill_step", "make_decode_step",
           "greedy_generate"]


def _lm_only(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError("encoder-decoder serving is not in the "
                                  "port yet (ROADMAP A10)")


def _no_progressive(progressive: bool) -> None:
    if progressive:
        raise NotImplementedError(
            "progressive=True streams the LM head level by level (kernel "
            "B2), which the port takes with the rest of serving (ROADMAP "
            "A11)")


# ------------------------------------------------------- weight preparation
def prepare_params(cfg: ModelConfig, params, desc=None):
    """Load-time serving weights: build the L2R weight cache ONCE.

    When ``cfg.l2r`` is set, every eligible matmul weight becomes a
    :class:`~repro_torch.core.quant.QuantizedWeights` record (int8 + per-
    out-channel scale) here, so the prefill and decode steps stream
    activations through the level-stacked digit-plane GEMM (kernel B1 on
    the card) with no per-step weight quantization.  Without an L2R
    config this is the identity.

    Every record also caches its reversed RHS plane stack in B1's
    operand format (pre-shifted, K-major:
    models/common.py:quantize_tree), so no step extracts, shifts or
    transposes a weight plane.  The LM head (the tied embedding's
    transpose, excluded from quantize_tree so lookups keep the float
    table) gets its own cache ``head_q``, window-padded as the
    reference's (2D-1 plane blocks); the stacked schedule reads its first
    D blocks in place.  Costs D x (the head 2D-1 x) the int8 weight
    bytes.

    ``desc`` is the Param descriptor tree (for eligibility); defaults to
    ``lm_build(cfg)``.
    """
    if cfg.l2r is None:
        return params
    if desc is None:
        _lm_only(cfg)
        desc = lm_build(cfg)
    out = quantize_tree(desc, params, cfg.l2r, prestack=True)
    head = out["embed"].T if cfg.tie_embeddings else out.get("head")
    if head is not None and not isinstance(head, QuantizedWeights):
        out = {**out, "head_q": quantize_weights(
            head, cfg.l2r, prestack=True, window_pad=True,
            plane_shifted=True, k_major=True)}
    return out


# ------------------------------------------------------------ step factories
def make_prefill_step(cfg: ModelConfig, max_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      progressive: bool = False) -> Callable:
    """(params, batch) -> (state, last_token_logits (B, 1, V)).

    ``batch`` holds ``tokens`` (B, S) int (or ``embeds``) and optionally
    ``rope_positions``; the state's caches are allocated on the batch's
    device, ``max_len`` long, in ``cache_dtype``.  The head runs on the
    last prompt position only.
    """
    _no_progressive(progressive)
    _lm_only(cfg)

    def prefill(params, batch):
        tokens = batch.get("tokens")
        embeds = batch.get("embeds")
        src = tokens if tokens is not None else embeds
        state = init_lm_state(cfg, src.shape[0], max_len, cache_dtype,
                              device=src.device)
        hidden, state, _ = lm_forward(
            cfg, params, tokens=tokens, embeds=embeds,
            rope_positions=batch.get("rope_positions"), mode="prefill",
            state=state)
        return state, logits_from_hidden(cfg, params, hidden[:, -1:])

    return prefill


def make_decode_step(cfg: ModelConfig, progressive: bool = False
                     ) -> Callable:
    """(params, state, tokens (B, 1)) -> (state, next_tokens (B, 1) int32,
    logits (B, 1, V)).  The state's caches are updated in place."""
    _no_progressive(progressive)
    _lm_only(cfg)

    def decode(params, state, tokens, rope_positions=None):
        hidden, state, _ = lm_forward(
            cfg, params, tokens=tokens, rope_positions=rope_positions,
            mode="decode", state=state)
        logits = logits_from_hidden(cfg, params, hidden)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return state, next_tok, logits

    return decode


def greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                    steps: int, max_len: int | None = None,
                    cache_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Batched greedy decoding (host-driven): the prefill's token, then
    ``steps - 1`` decode steps -> (B, steps) int32 on the prompt's
    device."""
    b, s = prompt.shape
    max_len = max_len or (s + steps)
    prefill = make_prefill_step(cfg, max_len, cache_dtype)
    decode = make_decode_step(cfg)
    state, logits = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(steps - 1):
        state, tok, _ = decode(params, state, tok)
        out.append(tok)
    return torch.cat(out, dim=1)
