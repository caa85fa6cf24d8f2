"""Attention math: RoPE / M-RoPE, GQA, chunked (flash-style) attention,
full and ring (sliding-window) KV caches, and digit-serial attention.

The port of ``repro/models/attention.py``.  Prefill and training
attention (:func:`chunked_attention`) runs a flash kernel on the card
where the arguments fit it (B5 on the float path, B4 with ``l2r=``), and
otherwise the reference's query-chunk loop with an online softmax over
KV chunks, in torch.  Decode (q = 1) attends directly against the cache
in plain torch, as the reference does outside any Pallas kernel.

Digit-serial attention (``l2r=``) routes QK^T through the MSDF score
walks of core/l2r_attention.py over per-vector-quantized q and k; the
plane-stacked key cache (``init_kv_cache(quant=)``) is filled as tokens
append, and decode can stop the score walk early once every row's max
and normalizer are decided (``early_exit``, ``policy``).

Caches are updated in place: :func:`update_kv_cache` writes the new
entries into the cache's own tensors and returns the same cache, where
the reference returns a new one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.l2r_attention import (attn_scores_stacked,
                                            attn_scores_streaming_while,
                                            quantize_per_vector)
from repro_torch.core.policy import LevelPolicy, attn_walk_machinery
from repro_torch.core.progressive import level_bounds
from repro_torch.core.quant import (PlaneOperands, QuantConfig,
                                    _symmetric_quant, stack_planes_rhs)
from repro_torch.device import card_path, no_tf32, resolve_device
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.sharding import ctx
from repro_torch.sharding.collectives import TAG_CONSENSUS, all_reduce, tag

__all__ = [
    "apply_rope",
    "chunked_attention",
    "decode_attention",
    "attn_exit_tap",
    "default_chunks",
    "b5_fits",
    "b4_fits",
    "KVCache",
    "init_kv_cache",
    "update_kv_cache",
    "kv_plane_operands",
]

_NEG = -1e30  # finite sentinel: -inf breeds NaNs in fully-masked blocks


# ------------------------------------------------- progressive exit-level tap
_EXIT_TAP: list | None = None


@contextlib.contextmanager
def attn_exit_tap():
    """Collect per-call decode-attention exit levels.

    Yields a list; every ``decode_attention(..., early_exit=True)`` (or
    ``policy=``) call inside the context appends ``{"levels_run": int,
    "exit_levels": (B, Kv, G) int32 array}``, in call order (layer order
    for one decode step).  The port runs eagerly, so every call records
    (reading the exit levels to the host); the reference's refusal to
    record under ``jit`` has no counterpart here.
    """
    global _EXIT_TAP
    prev, records = _EXIT_TAP, []
    _EXIT_TAP = records
    try:
        yield records
    finally:
        _EXIT_TAP = prev


# ----------------------------------------------------------------- RoPE
def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> torch.Tensor:
    """positions (...,) -> angles (..., head_dim//2), f32."""
    half = head_dim // 2
    dev = positions.device
    ar = torch.arange(0, half, dtype=torch.float32, device=dev)
    # torch.full, not torch.tensor: no host-to-device copy (which syncs)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=dev),
                      -ar / half)
    return positions.to(torch.float32)[..., None] * freqs


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10_000.0,
    mode: str = "standard",
    sections: tuple[int, int, int] = (16, 24, 24),
) -> torch.Tensor:
    """Rotary embedding.

    x: (B, S, H, dh).  positions: (B, S) for standard RoPE, or (3, B, S)
    for M-RoPE (temporal/height/width position streams, each rotating its
    own slice of the frequency spectrum).  The angles are f32; cos and
    sin are cast to x's dtype before the rotation, as in the reference.
    """
    if mode == "none":
        return x
    b, s, h, dh = x.shape
    half = dh // 2
    angles = _rope_angles(positions, dh, theta)
    if mode == "mrope":
        assert positions.shape[0] == 3, "mrope expects (3, B, S) positions"
        sec = torch.cumsum(torch.tensor(sections), 0).to(x.device)
        idx = torch.searchsorted(sec, torch.arange(half, device=x.device),
                                 right=True)  # 0/1/2 per frequency
        angles = torch.gather(angles.movedim(0, -1), -1,
                              idx.view(1, 1, half, 1).expand(b, s, half, 1)
                              )[..., 0]  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)  # (B, S, 1, half)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ------------------------------------------------------ chunked attention
def _block_scores(q, k, scale, softcap, score_dtype):
    """q (B, qc, Kv, G, dh), k (B, kc, Kv, dh) -> (B, Kv, G, qc, kc):
    an f32 product (both sides upcast first, the reference's
    ``preferred_element_type``) stored in ``score_dtype``."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                     k.to(torch.float32)).to(score_dtype)
    s = s * torch.full((), scale, dtype=score_dtype, device=s.device)
    if softcap is not None:
        s = (torch.tanh(s / softcap) * softcap).to(score_dtype)
    return s


def default_chunks(sq: int) -> tuple[int, int]:
    """(q_chunk, kv_chunk): ~8 query chunks, KV blocks of 1024-2048."""
    q = max(1024, sq // 8)
    kv = max(1024, min(2048, sq // 8))
    return q, kv


def b5_fits(q, k, v, softcap: float | None, q_offset: int) -> bool:
    """Does this float :func:`chunked_attention` call go to kernel B5?  On
    the card's path (a CUDA tensor, or a ``meta`` one: device.card_path),
    with no softcap, no q offset (the reference kernel has neither) and q,
    k, v of one dtype, f32 or bf16; any head width."""
    return (card_path(q) and softcap is None and q_offset == 0
            and q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16))


def b4_fits(q, k, v, softcap: float | None, q_offset: int,
            l2r: QuantConfig) -> bool:
    """Does this ``chunked_attention(l2r=)`` call go to kernel B4?  On the
    card's path (device.card_path), with no softcap, no q offset and v f32
    or bf16 (q and k are quantized); any head width and plane type (int8,
    or int16 for n_bits 9-16)."""
    del l2r  # every config: int8 and int16 planes both have a route
    return (card_path(q) and softcap is None and q_offset == 0
            and v.dtype in (torch.float32, torch.bfloat16))


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    softcap: float | None = None,
    q_chunk: int | None = None,
    kv_chunk: int | None = None,
    q_offset: int = 0,
    score_dtype: torch.dtype = torch.float32,
    head_shard: bool = False,
    l2r: QuantConfig | None = None,
    levels: int | None = None,
) -> torch.Tensor:
    """GQA flash-style attention.

    q: (B, Sq, H, dh); k, v: (B, Skv, Kv, dh) with H % Kv == 0 -> (B, Sq,
    H, dh) in v's dtype.  ``q_offset``: absolute position of q[0]
    relative to k[0] (prefill continuation); causal masks compare
    absolute positions.

    ``l2r`` routes QK^T through the digit-serial score walk
    (core/l2r_attention.py): q rows and k slots quantize with per-vector
    scales, and ``levels`` truncates the MSDF stream (None = exact W8A8
    scores); softmax and PV stay float, and the quantized scores are f32
    whatever ``score_dtype`` says.

    Dispatch is by the arguments, never a fallback (a failing launch
    raises):

    * with ``l2r``, where :func:`b4_fits` holds, one launch of kernel B4
      (``kernels/flash_attention/kernel.py:flash_attention_l2r``, which
      quantizes q and k per vector and walks 64-key tiles);
    * without, where :func:`b5_fits` holds, one launch of kernel B5;
    * both kernels differentiate as the loop below does: their autograd
      Functions (``kernel.FlashAttentionL2R``, ``ops.FlashAttention``)
      recompute this call's plain loop, with its own arguments, in the
      backward and return its gradient (no launch there);
    * every other call, and every CPU call, runs the reference's loop:
      static query chunks with exact KV ranges, an online softmax over KV
      chunks in f32, p cast to v's dtype before PV (true f32 products,
      TF32 off); with ``l2r`` the planes are extracted once per call and
      each chunk's scores are ``attn_scores_stacked`` dequantized as
      ``s_int * q_scale * k_scale * scale`` in f32, in that order.

    ``score_dtype`` and ``head_shard`` do not change the kernels'
    arithmetic (f32 scores and statistics; there is no mesh), and
    ``q_chunk``/``kv_chunk`` do not apply to them.
    """
    del head_shard  # no mesh in the port

    def plain(q, k, v):
        with no_tf32():
            return _chunked_plain(q, k, v, causal, window, scale, softcap,
                                  q_chunk, kv_chunk, q_offset, score_dtype,
                                  l2r, levels)

    if l2r is not None and b4_fits(q, k, v, softcap, q_offset, l2r):
        return fa_kernel.FlashAttentionL2R.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), l2r.n_bits,
            l2r.log2_radix, levels, causal, window, scale, plain)
    if l2r is None and b5_fits(q, k, v, softcap, q_offset):
        return fa_ops.FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
            scale, plain)
    return plain(q, k, v)


def _l2r_chunk_scores(q, k, l2r: QuantConfig, levels: int | None, scale):
    """The digit-serial score function of the chunk loop: q (B, Sq, Kv,
    G, dh) and the padded k (B, Skv', Kv, dh) quantized per vector and
    plane-stacked once; ``scores(q0, q1, k0, k1)`` gives the f32
    (B, Kv, G, q1-q0, k1-k0) scores ``s_int * q_scale * k_scale * scale``
    of one chunk pair (the sequence axes slice through both stacks)."""
    qq, qs = quantize_per_vector(q, l2r)
    kq, ks = quantize_per_vector(k, l2r)
    q_po = PlaneOperands.prepare_lhs(qq, l2r.n_bits, l2r.log2_radix)
    k_po = PlaneOperands.prepare_rhs(kq, l2r.n_bits, l2r.log2_radix,
                                     axis=-1)
    qs_t = qs.permute(0, 2, 3, 1, 4)  # (B, Kv, G, Sq, 1)
    ks_t = ks[..., 0].transpose(1, 2)[:, :, None, None, :]  # (B,Kv,1,1,S)
    sf = torch.tensor(np.float32(scale), device=q.device)

    def scores(q0, q1, k0, k1):
        q_blk = dataclasses.replace(q_po, stack=q_po.stack[:, q0:q1])
        k_blk = dataclasses.replace(k_po, stack=k_po.stack[:, k0:k1])
        s_int = attn_scores_stacked(q_blk, k_blk, l2r.n_bits,
                                    l2r.log2_radix, levels)
        return s_int.to(torch.float32) * qs_t[:, :, :, q0:q1] \
            * ks_t[..., k0:k1] * sf

    return scores


def _chunked_plain(q, k, v, causal, window, scale, softcap, q_chunk,
                   kv_chunk, q_offset, score_dtype, l2r=None, levels=None):
    b, sq, h, dh = q.shape
    _, skv, kv_heads, _ = k.shape
    g = h // kv_heads
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    dq, dkv = default_chunks(sq)
    q_chunk = min(q_chunk or dq, sq)
    kv_chunk = min(kv_chunk or dkv, skv)
    n_q = (sq + q_chunk - 1) // q_chunk
    pad_kv = (-skv) % kv_chunk  # whole chunks; the mask hides the tail
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    q = q.reshape(b, sq, kv_heads, g, dh)
    l2r_scores = None if l2r is None else \
        _l2r_chunk_scores(q, k, l2r, levels, scale)
    outs = []
    for qi in range(n_q):
        q_start = qi * q_chunk
        qc = min(q_chunk, sq - q_start)
        q_blk = q[:, q_start:q_start + qc]
        q_abs_end = q_offset + q_start + qc - 1  # last query position
        hi = min(skv, q_abs_end + 1) if causal else skv
        lo = 0
        if window is not None:
            lo = max(0, q_offset + q_start - window + 1)
        lo_c, hi_c = lo // kv_chunk, (hi + kv_chunk - 1) // kv_chunk
        q_pos = q_offset + q_start + torch.arange(qc, device=dev)
        acc = torch.zeros((b, kv_heads, g, qc, dh), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, kv_heads, g, qc), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv_heads, g, qc), dtype=torch.float32,
                        device=dev)
        for kc_i in range(lo_c, hi_c):
            k0, k1 = kc_i * kv_chunk, (kc_i + 1) * kv_chunk
            v_blk = v[:, k0:k1]
            if l2r_scores is None:
                s = _block_scores(q_blk, k[:, k0:k1], scale, softcap,
                                  score_dtype)
            else:
                s = l2r_scores(q_start, q_start + qc, k0, k1)
                if softcap is not None:
                    s = torch.tanh(s / softcap) * softcap
            kv_pos = k0 + torch.arange(kv_chunk, device=dev)
            mask = kv_pos[None, :] < skv  # tail padding guard
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, torch.full((), _NEG, dtype=s.dtype,
                                                device=dev))
            # softmax statistics in f32 regardless of the score dtype
            m_new = torch.maximum(m, s.amax(-1).to(torch.float32))
            p = torch.exp(s.to(torch.float32) - m_new[..., None])
            p = torch.where(mask, p, 0.0).to(v.dtype)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, dtype=torch.float32)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(torch.float32),
                              v_blk.to(torch.float32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.movedim(3, 1))  # (B, qc, Kv, G, dh)
    o = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return o.reshape(b, sq, h, dh).to(v.dtype)


_DECODE_ROWS = 8  # the batch rows of every decode QK / PV product


def _f32_pairs(x: torch.Tensor, n: int, cols: tuple | None = None
               ) -> torch.Tensor:
    """``x`` (batch rows, kv heads, ...) as ``n`` f32 (row, head) pairs,
    contiguous, in row-major order; the pairs past ``x``'s are zeros.
    ``cols`` = (offset, width): ``x``'s last dim is that slice of a
    ``width``-wide one, written into zeros at its columns."""
    pairs = x.shape[0] * x.shape[1]
    if cols is None:
        if pairs == n and x.dtype == torch.float32 and x.is_contiguous():
            return x.reshape(n, *x.shape[2:])
        out = x.new_empty((n, *x.shape[2:]), dtype=torch.float32)
        out[:pairs].view(x.shape).copy_(x)
        out[pairs:].zero_()
        return out
    lo, width = cols
    out = x.new_zeros((n, *x.shape[2:-1], width), dtype=torch.float32)
    out[:pairs, ..., lo:lo + x.shape[-1]].copy_(
        x.reshape(pairs, *x.shape[2:]))
    return out


def _decode_block(kv_heads: int, kv_whole: int | None = None) -> int:
    """The (batch row, kv head) pairs of one decode product:
    ``_DECODE_ROWS`` rows of the whole model's kv heads, ``kv_whole``
    (a rank holding a part of them pads its pairs to the same block),
    else the call's own."""
    return _DECODE_ROWS * (kv_whole or kv_heads)


def _fixed_pairs(a: torch.Tensor, b: torch.Tensor, b_t: bool,
                 kv_whole: int | None = None, cols: tuple | None = None
                 ) -> torch.Tensor:
    """``a @ b`` (``b`` transposed when ``b_t``) for every (batch row, kv
    head) pair in f32: ``a`` (B, Kv, m, k), ``b`` (B, Kv, k, n) or
    (B, Kv, n, k) -> (B, Kv, m, n), the pairs in blocks of
    :func:`_decode_block`, the last padded with zero pairs.  A batched
    product may split its sums differently as the batch count changes
    (cuBLAS picks its kernel by it), so a pair's result would depend on
    the rows and heads beside it; with every call of one shape it does
    not, and a rank of the ``"batch"`` slot layout (its rows) or of the
    ``"specs"`` one (its kv heads) decodes as one process does.  One
    process decoding ``_DECODE_ROWS`` rows makes one call a product.
    ``cols`` = (offset, width): ``b`` (not transposed) holds that slice of
    its columns; the product runs on them written into zeros at their
    place, every call the whole width's shape as in one process, and
    returns those columns (the head_dim layout's values: a product of
    fewer columns may sum in another order on the CPU)."""
    rows, heads = a.shape[:2]
    pairs, r = rows * heads, _decode_block(heads, kv_whole)
    padded = -(-pairs // r) * r
    width = b.shape[-1]
    a, b = _f32_pairs(a, padded), _f32_pairs(b, padded, cols)
    if b_t:
        b = b.transpose(1, 2)
    out = a.new_empty((padded, a.shape[1], b.shape[2]))
    for i in range(0, padded, r):
        torch.bmm(a[i:i + r], b[i:i + r], out=out[i:i + r])
    out = out[:pairs].view(rows, heads, *out.shape[1:])
    return out if cols is None else out[..., cols[0]:cols[0] + width]


def _softmax_pv(s, valid_b, v_cache, shape, kv_whole=None, v_cols=None):
    """Masked softmax over the slots and the PV product of decode: p cast
    to v's dtype, f32 products (TF32 off) -> ``shape`` in v's dtype."""
    with no_tf32():
        s = torch.where(valid_b, s, _NEG)
        p = torch.softmax(s, dim=-1)
        b, kv, g, q, n = p.shape
        o = _fixed_pairs(p.to(v_cache.dtype).reshape(b, kv, g * q, n),
                         v_cache.permute(0, 2, 1, 3), False, kv_whole,
                         v_cols)
    return o.reshape(shape).to(v_cache.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_positions: torch.Tensor,
    q_position: torch.Tensor,
    *,
    window: int | None = None,
    scale: float | None = None,
    softcap: float | None = None,
    l2r: QuantConfig | None = None,
    levels: int | None = None,
    early_exit: bool = False,
    exit_tol: float = 1e-4,
    k_planes: torch.Tensor | PlaneOperands | None = None,
    k_scale: torch.Tensor | None = None,
    policy: LevelPolicy | None = None,
    kv_whole: int | None = None,
    v_cols: tuple | None = None,
) -> torch.Tensor:
    """Single-token attention against a (possibly ring) cache, in plain
    torch on any device (true f32 products, TF32 off).

    q: (B, 1, H, dh); caches: (B, L, Kv, dh); kv_positions: (B, L) int32
    absolute positions (-1 = empty slot); q_position: (B,) int32.  The
    value cache may hold a slice of each head's dh (the head_dim layout of
    a split, models/transformer.py): the result is then that slice of
    each head's output, (B, 1, H, its width).  ``kv_whole``: the whole
    model's kv heads, which size the products' fixed blocks (default: the
    cache's; a caller holding a rank's heads passes the whole count);
    ``v_cols`` = (offset, dh): the value slice's place in each head's
    dh (PV then runs at the whole width, :func:`_fixed_pairs`).

    ``l2r`` routes QK^T through the digit-serial score walk with an exact
    softmax and float PV; ``levels`` truncates the MSDF stream.
    ``k_planes``/``k_scale`` feed the plane-stacked key cache
    (:func:`update_kv_cache` with a quant config): the per-slot planes
    and scales are used as they are, with no per-step plane extraction
    over the history, bit-identical to quantizing ``k_cache`` here.  On
    the card the walk's level einsums run in true f32 under the
    exactness guard, and a digit config that fails the guard raises.

    ``early_exit=True`` runs the margin-bounded progressive walk: the
    level loop stops once every (batch, kv head, group) score row has
    BOTH its running max decided (the argmax margin beats the scaled
    tail bound, core/policy.py:decision_state) and its normalizer pinned
    (every unmasked score known to within ``exit_tol``).  The done flag
    is read on the host before each level (one sync a level on the
    card).  Rows that never decide consume the whole stream, so the
    output is then exactly the full-depth result; decided rows return
    softmax over the exit-level prefix.  Incompatible with ``softcap``.
    Where a rank holds some of the call's rows or heads (a
    ``ctx.row_shard`` or ``ctx.model_shard`` scope) the walk stops when
    every rank's rows have decided, as one process's would.

    ``policy`` (core/policy.py:LevelPolicy, one row per batch entry)
    runs the walk with per-row precision classes: ``bounded(tol)`` rows
    use their own normalizer tolerance (``bounded(exit_tol)`` is the
    early-exit walk bit for bit), ``budget(L)`` rows snapshot their int32
    score prefix at level L (their softmax sees exactly the ``levels=L``
    scores, even when batch-mates stream deeper), and ``exact`` rows
    never commit early.  Bounded rows keep the batch-coupled semantics
    of the reference: their softmax runs over the prefix at the global
    stop level.  Requires ``l2r``.
    """
    b, _, h, dh = q.shape
    kv_heads = k_cache.shape[2]
    g = h // kv_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out_shape = (b, 1, h, v_cache.shape[-1])
    qg = q.reshape(b, 1, kv_heads, g, dh)
    valid = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    if window is not None:
        valid = valid & (kv_positions > (q_position[:, None] - window))
    valid_b = valid[:, None, None, None, :]  # (B, 1, 1, 1, L)

    if l2r is None:
        with no_tf32():
            s = _fixed_pairs(qg.permute(0, 2, 3, 1, 4).reshape(
                b, kv_heads, g, dh), k_cache.permute(0, 2, 1, 3), True,
                kv_whole)
            s = s.reshape(b, kv_heads, g, 1, -1) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        return _softmax_pv(s, valid_b, v_cache, out_shape, kv_whole, v_cols)

    # ---- digit-serial QK^T -------------------------------------------
    qq, qs = quantize_per_vector(qg, l2r)
    qs_t = qs.permute(0, 2, 3, 1, 4)  # (B, Kv, G, 1, 1)
    if k_planes is not None:
        if k_scale is None:
            raise ValueError("plane-stacked cache: k_planes and k_scale "
                             "travel together")
        k_op = k_planes if isinstance(k_planes, PlaneOperands) else \
            PlaneOperands(k_planes, "rhs", l2r.n_bits, l2r.log2_radix, dh,
                          -1, False, l2r.planes - 1)
        ks = k_scale
    else:
        kq, ks3 = quantize_per_vector(k_cache, l2r)
        k_op, ks = kq, ks3[..., 0]
    ks_t = ks.transpose(1, 2)[:, :, None, None, :]  # (B, Kv, 1, 1, L)
    sf = torch.tensor(np.float32(scale), device=q.device)

    def dequant(acc):
        return acc.to(torch.float32) * qs_t * ks_t * sf

    if not early_exit and policy is None:
        s = dequant(attn_scores_stacked(qq, k_op, l2r.n_bits,
                                        l2r.log2_radix, levels))
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        return _softmax_pv(s, valid_b, v_cache, out_shape, kv_whole, v_cols)

    # ---- margin-bounded progressive walk -----------------------------
    if softcap is not None:
        raise ValueError("progressive attention (early_exit/policy) does "
                         "not compose with softcap: tanh re-scales the "
                         "score margins the tail bounds are stated in")
    bounds = level_bounds(l2r.planes, l2r.log2_radix, dh, levels,
                          device=q.device)
    n_levels = int(bounds.f32.shape[0])
    if policy is not None:
        policy = policy.to(q.device)
    fold, init, done_fn = attn_walk_machinery(
        bounds.f32, dequant, valid_b,
        qs_t[:, :, :, 0, :] * ks_t[:, :, :, 0, :] * sf,
        rows_shape=(b, kv_heads, g), n_levels=n_levels,
        exit_tol=exit_tol, policy=policy,
        score_shape=(b, kv_heads, g, 1, k_cache.shape[1]))
    done_fn = _global_done(done_fn)
    acc, carry, levels_run = attn_scores_streaming_while(
        qq, k_op, fold, init, done_fn, l2r.n_bits, l2r.log2_radix, levels)
    if policy is None:
        _, lv = carry
        s_int = acc
    else:
        _, lv, forced_any, s_commit = carry
        # budget rows committed at their clamp: serve THEIR softmax from
        # the snapshot, so a mixed batch is bit-identical to a solo
        # levels=L run even when batch-mates stream deeper
        s_int = torch.where(forced_any[..., None, None], s_commit, acc)
    if _EXIT_TAP is not None:
        _EXIT_TAP.append({"levels_run": int(levels_run),
                          "exit_levels": lv.cpu().numpy()})
    return _softmax_pv(dequant(s_int), valid_b, v_cache, out_shape,
                       kv_whole, v_cols)


def _global_done(done_fn):
    """``done_fn`` of the walk over every rank's part of the call: where a
    ``ctx.row_shard`` or ``ctx.model_shard`` scope gives this rank some of
    the rows or heads, the walk stops when every rank's have decided (a
    MIN all-reduce of the flag over those axes), at the level one process
    stops at, so bounded rows see the same prefix."""
    mesh, split = ctx.get_mesh(), ctx.model_split()
    axes = ctx.row_axes() + (("model",) if split is not None else ())
    if not axes:
        return done_fn
    group = mesh.group(axes)

    def done(carry):
        flag = done_fn(carry).to(torch.int32).reshape(1)
        with tag(TAG_CONSENSUS):
            return all_reduce(flag, "min", group)[0] > 0

    return done


# ------------------------------------------------------------- KV caches
class KVCache(NamedTuple):
    """Full or ring KV cache.  ``length`` (the cache's second axis) is the
    allocated size, the window for ring caches; ``positions`` tracks
    absolute token positions.

    ``k_planes``/``k_scale`` (present iff the cache was built with a quant
    config) are the incrementally plane-stacked key cache: every update
    also quantizes the new keys per slot and writes their raw-digit
    descending plane stack, window-padded to 2D-1 blocks (the
    ``PlaneOperands.prepare_rhs(axis=-1, window_pad=True)`` layout), so
    the decode walk reads a ready operand instead of re-extracting
    planes over the whole history each step.
    """

    k: torch.Tensor  # (B, L, Kv, dh)
    v: torch.Tensor  # (B, L, Kv, dh)
    positions: torch.Tensor  # (B, L) int32, -1 = empty
    k_planes: torch.Tensor | None = None  # (B, L, Kv, (2D-1)*dh) int8
    k_scale: torch.Tensor | None = None   # (B, L, Kv) f32 per-slot scales


def init_kv_cache(batch: int, length: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  quant: QuantConfig | None = None,
                  device: str | torch.device | None = None,
                  v_head_dim: int | None = None) -> KVCache:
    """A zero cache; ``v_head_dim``: the value cache's head width where it
    differs from the keys' (a rank's slice, the head_dim layout)."""
    device = resolve_device(device)
    k_planes = k_scale = None
    if quant is not None:
        k_planes = torch.zeros(
            (batch, length, kv_heads, (2 * quant.planes - 1) * head_dim),
            dtype=torch.int8, device=device)
        # empty slots carry the scale a zero key vector quantizes to, so
        # the whole stacked cache, used slots or not, is bit-identical to
        # re-extracting planes from the (zero-initialized) float cache
        zero = torch.zeros((), dtype=torch.float32, device=device)
        _, s0 = _symmetric_quant(zero, zero, quant)
        k_scale = s0.expand(batch, length, kv_heads).contiguous()
    return KVCache(
        k=torch.zeros((batch, length, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, length, kv_heads, v_head_dim or head_dim),
                      dtype=dtype, device=device),
        positions=torch.full((batch, length), -1, dtype=torch.int32,
                             device=device),
        k_planes=k_planes,
        k_scale=k_scale,
    )


def update_kv_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    positions: torch.Tensor,
                    quant: QuantConfig | None = None) -> KVCache:
    """Write S new entries at slots positions % L (ring semantics; for a
    full-length cache L >= max position this is a plain indexed write),
    IN PLACE, and return the same cache.

    k_new/v_new: (B, S, Kv, dh); positions: (B, S) absolute.  Where one
    write wraps the ring (S > L), a slot keeps the last of its entries,
    as the reference's scatter leaves it.

    A plane-stacked cache (``init_kv_cache(..., quant=...)``) takes the
    same ``quant`` here: the new keys' digit planes and scales go into
    its stack.  What is quantized is the key as stored in the float cache
    (after the cast to the cache's dtype), so the stack is bit-identical
    to re-extracting planes from the float cache at any later step.
    """
    if cache.k_planes is not None and quant is None:
        raise ValueError("plane-stacked KV cache: pass the QuantConfig that "
                         "built it")
    length = cache.k.shape[1]
    bsz, s = positions.shape
    slots = (positions % length).long()
    rows = torch.arange(bsz, device=slots.device)[:, None].expand(bsz, s)
    k_new, v_new = k_new.to(cache.k.dtype), v_new.to(cache.v.dtype)
    new_stack = new_scale = None
    if cache.k_planes is not None:
        kq, ks = quantize_per_vector(k_new, quant)
        new_stack = F.pad(stack_planes_rhs(kq, quant.n_bits, quant.log2_radix,
                                           axis=-1, shifted=False),
                          (0, (quant.planes - 1) * cache.k.shape[-1]))
        new_scale = ks[..., 0]
    if s > length:  # keep each slot's last write
        idx = torch.arange(s, device=slots.device).expand(bsz, s)
        last = torch.full((bsz, length), -1, dtype=torch.long,
                          device=slots.device).scatter_reduce(
            1, slots, idx, "amax")
        win = last.gather(1, slots) == idx
        rows, slots = rows[win], slots[win]
        k_new, v_new, positions = k_new[win], v_new[win], positions[win]
        if new_stack is not None:
            new_stack, new_scale = new_stack[win], new_scale[win]
    cache.k[rows, slots] = k_new
    cache.v[rows, slots] = v_new
    cache.positions[rows, slots] = positions.to(torch.int32)
    if new_stack is not None:
        cache.k_planes[rows, slots] = new_stack
        cache.k_scale[rows, slots] = new_scale
    return cache


def kv_plane_operands(cache: KVCache, quant: QuantConfig) -> PlaneOperands:
    """The cache's plane stack as the RHS operand the score walks consume
    (raw digits, descending on the head dim, window-padded: no per-step
    operand preparation)."""
    if cache.k_planes is None:
        raise ValueError("cache has no plane stack: init_kv_cache(..., "
                         "quant=...)")
    return PlaneOperands(cache.k_planes, "rhs", quant.n_bits,
                         quant.log2_radix, cache.k.shape[-1], -1, False,
                         quant.planes - 1)
