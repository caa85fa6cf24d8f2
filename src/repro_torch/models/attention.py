"""Attention math: RoPE / M-RoPE, GQA, chunked (flash-style) attention,
full and ring (sliding-window) KV caches.

The port of ``repro/models/attention.py`` on the float path.  Prefill
and training attention (:func:`chunked_attention`) runs kernel B5 on
the card where the arguments fit it, and otherwise the reference's
query-chunk loop with an online softmax over KV chunks, in torch.
Decode (q = 1) attends directly against the cache in plain torch, as
the reference does outside any Pallas kernel.

The digit-serial attention of the reference (``l2r=``/``levels=`` on
both attention functions, the plane-stacked key cache built with a
``quant`` config, the progressive decode walk) is the next slice of the
port (ROADMAP A9b): asking for it raises.

Caches are updated in place: :func:`update_kv_cache` writes the new
entries into the cache's own tensors and returns the same cache, where
the reference returns a new one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantConfig
from repro_torch.device import no_tf32, resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.kernel import _MAX_DH

__all__ = [
    "apply_rope",
    "chunked_attention",
    "decode_attention",
    "default_chunks",
    "b5_fits",
    "KVCache",
    "init_kv_cache",
    "update_kv_cache",
]

_NEG = -1e30  # finite sentinel: -inf breeds NaNs in fully-masked blocks


def _no_digit_serial(l2r: QuantConfig | None, where: str) -> None:
    if l2r is not None:
        raise NotImplementedError(
            f"{where}: digit-serial attention (l2r=, the plane-stacked key "
            f"cache) is the next slice of the port (ROADMAP A9b)")


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
    """Does this :func:`chunked_attention` call go to kernel B5?  On a
    CUDA tensor, with no softcap, no q offset, dh <= 128 and q, k, v of
    one dtype, f32 or bf16."""
    return (q.is_cuda and softcap is None and q_offset == 0
            and q.shape[-1] <= _MAX_DH
            and q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16))


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

    Where :func:`b5_fits` holds (a CUDA tensor, no ``softcap``,
    ``q_offset == 0``, dh <= 128, q, k, v all f32 or all bf16), the call
    is one launch of kernel B5 (``kernels/flash_attention/ops.py``), with
    ``scale`` passed through.  This is dispatch by the arguments, not a
    fallback: a failing launch raises, and the call never drops to the
    loop below.  ``score_dtype`` and ``head_shard`` do not change B5's
    arithmetic (it keeps f32 scores and statistics; there is no mesh),
    and ``q_chunk``/``kv_chunk`` do not apply to it.

    Every other call, and every CPU call, runs the reference's loop:
    static query chunks with exact KV ranges, an online softmax over KV
    chunks in f32, scores stored in ``score_dtype``, p cast to v's dtype
    before PV (true f32 products, TF32 off).
    """
    _no_digit_serial(l2r, "chunked_attention")
    del levels, head_shard  # no digit-serial walk, no mesh in the port
    if b5_fits(q, k, v, softcap, q_offset):
        return fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window, scale=scale)
    with no_tf32():
        return _chunked_plain(q, k, v, causal, window, scale, softcap,
                              q_chunk, kv_chunk, q_offset, score_dtype)


def _chunked_plain(q, k, v, causal, window, scale, softcap, q_chunk,
                   kv_chunk, q_offset, score_dtype):
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
            k_blk = k[:, kc_i * kv_chunk:(kc_i + 1) * kv_chunk]
            v_blk = v[:, kc_i * kv_chunk:(kc_i + 1) * kv_chunk]
            s = _block_scores(q_blk, k_blk, scale, softcap, score_dtype)
            kv_pos = kc_i * kv_chunk + torch.arange(kv_chunk, device=dev)
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
) -> torch.Tensor:
    """Single-token attention against a (possibly ring) cache, in plain
    torch on any device (true f32 products, TF32 off).

    q: (B, 1, H, dh); caches: (B, L, Kv, dh); kv_positions: (B, L) int32
    absolute positions (-1 = empty slot); q_position: (B,) int32.
    """
    _no_digit_serial(l2r, "decode_attention")
    del levels
    b, _, h, dh = q.shape
    kv_heads = k_cache.shape[2]
    g = h // kv_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, 1, kv_heads, g, dh)
    valid = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    if window is not None:
        valid = valid & (kv_positions > (q_position[:, None] - window))
    valid_b = valid[:, None, None, None, :]  # (B, 1, 1, 1, L)
    with no_tf32():
        s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                         k_cache.to(torch.float32)) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(valid_b, s, _NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bkgqd",
                         p.to(v_cache.dtype).to(torch.float32),
                         v_cache.to(torch.float32))
    return o.reshape(b, 1, h, dh).to(v_cache.dtype)


# ------------------------------------------------------------- KV caches
class KVCache(NamedTuple):
    """Full or ring KV cache.  ``length`` (the cache's second axis) is the
    allocated size, the window for ring caches; ``positions`` tracks
    absolute token positions.  ``k_planes``/``k_scale`` are the
    reference's plane-stacked key cache (A9b) and stay None here."""

    k: torch.Tensor  # (B, L, Kv, dh)
    v: torch.Tensor  # (B, L, Kv, dh)
    positions: torch.Tensor  # (B, L) int32, -1 = empty
    k_planes: torch.Tensor | None = None
    k_scale: torch.Tensor | None = None


def init_kv_cache(batch: int, length: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  quant: QuantConfig | None = None,
                  device: str | torch.device | None = None) -> KVCache:
    _no_digit_serial(quant, "init_kv_cache(quant=)")
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros((batch, length, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, length, kv_heads, head_dim), dtype=dtype,
                      device=device),
        positions=torch.full((batch, length), -1, dtype=torch.int32,
                             device=device),
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
    """
    _no_digit_serial(quant, "update_kv_cache(quant=)")
    length = cache.k.shape[1]
    bsz, s = positions.shape
    slots = (positions % length).long()
    rows = torch.arange(bsz, device=slots.device)[:, None].expand(bsz, s)
    k_new, v_new = k_new.to(cache.k.dtype), v_new.to(cache.v.dtype)
    if s > length:  # keep each slot's last write
        idx = torch.arange(s, device=slots.device).expand(bsz, s)
        last = torch.full((bsz, length), -1, dtype=torch.long,
                          device=slots.device).scatter_reduce(
            1, slots, idx, "amax")
        win = last.gather(1, slots) == idx
        rows, slots = rows[win], slots[win]
        k_new, v_new, positions = k_new[win], v_new[win], positions[win]
    cache.k[rows, slots] = k_new
    cache.v[rows, slots] = v_new
    cache.positions[rows, slots] = positions.to(torch.int32)
    return cache
