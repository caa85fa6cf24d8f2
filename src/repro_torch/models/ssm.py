"""Mamba-2 (SSD, state-space duality) mixer, chunked scan formulation.

The port of ``repro/models/ssm.py``.  Train and prefill use the chunked
SSD algorithm (an intra-chunk quadratic term and an inter-chunk state
recurrence); decode is the O(1) per-token recurrence.  The two
projections (``in_proj``, ``out_proj``) go through :func:`dense`, so with
an L2R config each is one launch of kernel B1 on the card.  Everything
between them (the causal conv, the SSD chunk einsums, the sequential
recurrence over chunks, the decode update) is plain torch on every
device, as it is plain JAX in the reference: no Pallas kernel there,
none here.  Products run with TF32 off.

Two quirks of the reference are kept, since it is the oracle: the
sequence is zero-padded to a multiple of ``ssm_chunk``, and the incoming
``state["ssd"]`` is ignored (the chunked scan starts from zeros; only
the conv state carries into a continued prefill).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import no_tf32, resolve_device

from .common import Param, dense, rms_norm
from .config import ModelConfig

__all__ = [
    "ssm_build",
    "ssm_apply",
    "ssm_decode",
    "init_ssm_state",
    "ssd_chunked",
    "softplus",
]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` in its own form,
    ``max(x, 0) + log1p(exp(-|x|))`` (XLA's exp and log1p round apart
    from torch's in the last bit of a few percent of elements)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n  # x, B, C share the temporal conv
    return d_inner, heads, n, conv_dim


def ssm_build(cfg: ModelConfig) -> dict:
    d_inner, heads, n, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * n + heads  # z, xBC, dt
    return {
        "in_proj": Param((cfg.d_model, d_in_proj), ("embed", "ffn")),
        "conv_w": Param((cfg.ssm_conv, conv_dim), (None, "ffn"), scale=0.1),
        "conv_b": Param((conv_dim,), ("ffn",), init="zeros"),
        "a_log": Param((heads,), (None,), init="ones"),
        "d_skip": Param((heads,), (None,), init="ones"),
        "dt_bias": Param((heads,), (None,), init="zeros"),
        "norm": Param((d_inner,), ("ffn",), init="zeros"),
        "out_proj": Param((d_inner, cfg.d_model), ("ffn", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv along S.  x: (B, S, C); w: (W, C).

    Returns (y, new_state) with state = the last W-1 inputs (the decode
    carry).  The taps add in the reference's order, each product rounded.
    """
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(width - 1):]


def _segsum_scores(ca: torch.Tensor) -> torch.Tensor:
    """ca: (..., Q, H) within-chunk inclusive cumsum of a.  Returns the
    decay (..., H, Q, Q): exp(ca_i - ca_j) for j <= i, else 0.  The
    masked entries may be inf before the mask, so it selects (never
    multiplies: inf * 0 is NaN)."""
    q = ca.shape[-2]
    diff = (ca[..., :, None, :] - ca[..., None, :, :]).movedim(-1, -3)
    mask = torch.ones((q, q), dtype=torch.bool, device=ca.device).tril()
    return torch.where(mask, torch.exp(diff), 0.0)


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD.

    x: (B, S, H, P) inputs, dt: (B, S, H) softplus'd step sizes,
    a: (B, S, H) = -exp(A_log) * dt, b, c: (B, S, N) (one group, shared
    across heads).  Returns y: (B, S, H, P), final_state: (B, H, N, P).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    ac = a.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)

    with no_tf32():
        ca = torch.cumsum(ac, dim=2)  # (B, NC, Q, H) inclusive
        dtx = xc * dtc[..., None]  # (B, NC, Q, H, P)

        # intra-chunk (quadratic within a chunk)
        decay = _segsum_scores(ca)  # (B, NC, H, Q, Q)
        cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B, NC, Q, Q)
        scores = cb[:, :, None] * decay  # (B, NC, H, Q, Q)
        y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, dtx)

        # chunk summary states: S_c = sum_j exp(ca_last - ca_j) B_j dtx_j^T
        last = ca[:, :, -1:, :]  # (B, NC, 1, H)
        w_end = torch.exp(last - ca)  # (B, NC, Q, H)
        states = torch.einsum("bcjn,bcjhp->bchnp", bc,
                              w_end[..., None] * dtx)

        # inter-chunk recurrence over NC (sequential), emitting the state
        # entering each chunk
        chunk_decay = torch.exp(last[:, :, 0, :])  # (B, NC, H)
        r = torch.zeros((bsz, h, n, p), dtype=x.dtype, device=x.device)
        r_in = []
        for ci in range(nc):
            r_in.append(r)
            r = r * chunk_decay[:, ci, :, None, None] + states[:, ci]
        r_in = torch.stack(r_in, dim=1)  # (B, NC, H, N, P)

        # inter-chunk contribution: y2_i = C_i * exp(ca_i) . R_in
        w_in = torch.exp(ca)  # decay from the chunk start to position i
        y_inter = torch.einsum("bcin,bchnp->bcihp", cc, r_in) \
            * w_in[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, r


def init_ssm_state(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None) -> dict:
    d_inner, heads, n, conv_dim = _dims(cfg)
    device = resolve_device(device)
    return {
        "ssd": torch.zeros((batch, heads, n, cfg.ssm_head_dim), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, heads, n, conv_dim = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, conv_dim, heads], dim=-1)


def ssm_apply(cfg: ModelConfig, params: dict, u: torch.Tensor,
              state: dict | None = None):
    """Full-sequence SSD mixer.  u: (B, S, d_model).

    Returns (y, new_state), new tensors: the conv state carries a
    continued prefill; the chunked scan starts from zeros whatever
    ``state["ssd"]`` holds, as in the reference.
    """
    d_inner, heads, n, conv_dim = _dims(cfg)
    bsz, s, _ = u.shape
    f32 = torch.float32
    zxbcdt = dense(u, params["in_proj"], cfg.l2r, cfg.l2r_levels)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xbc = F.silu(xbc)
    x, b, c = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))
    a = -torch.exp(params["a_log"].to(f32)) * dt  # (B, S, H)

    x4 = x.reshape(bsz, s, heads, cfg.ssm_head_dim)
    pad = (-s) % cfg.ssm_chunk
    xs, b, c = x4.to(f32), b.to(f32), c.to(f32)
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt, a, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (dt, a, b, c))
    y, final = ssd_chunked(xs, dt, a, b, c, cfg.ssm_chunk)
    y = y[:, :s] + params["d_skip"].to(f32)[None, None, :, None] \
        * x4.to(f32)
    y = y.reshape(bsz, s, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = dense(y, params["out_proj"], cfg.l2r, cfg.l2r_levels)
    return out, {"ssd": final, "conv": new_conv}


def ssm_decode(cfg: ModelConfig, params: dict, u: torch.Tensor,
               state: dict):
    """One-token step.  u: (B, 1, d_model); O(1) state update.  Returns
    (y, new_state), new tensors."""
    d_inner, heads, n, conv_dim = _dims(cfg)
    bsz = u.shape[0]
    f32 = torch.float32
    zxbcdt = dense(u, params["in_proj"], cfg.l2r, cfg.l2r_levels)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 state["conv"])
    xbc = F.silu(xbc)
    x, b, c = torch.split(xbc[:, 0], [d_inner, n, n], dim=-1)  # (B, .)
    dt = softplus(dt[:, 0].to(f32) + params["dt_bias"].to(f32))
    a = torch.exp(-torch.exp(params["a_log"].to(f32)) * dt)  # (B, H)

    xh = x.reshape(bsz, heads, cfg.ssm_head_dim).to(f32)
    dtx = xh * dt[..., None]
    with no_tf32():
        s_new = state["ssd"] * a[..., None, None] \
            + b.to(f32)[:, None, :, None] * dtx[:, :, None, :]
        y = torch.einsum("bn,bhnp->bhp", c.to(f32), s_new)
    y = y + params["d_skip"].to(f32)[None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = dense(y, params["out_proj"], cfg.l2r, cfg.l2r_levels)
    return out, {"ssd": s_new, "conv": new_conv}
