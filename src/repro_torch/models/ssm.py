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

The SSD's chunk products and the decode readout run as batched products
in calls of a fixed shape (models/common.py:fixed_bmm: 8 rows' worth of
entries, the whole model's heads; :func:`ssd_chunked`), so a row's and a
head's bits do not depend on the rows and heads beside it.

Tensor parallelism (a ``ctx.model_shard`` scope, sharding/ctx.py): where
the model axis divides the heads a rank runs its heads.  Its ``in_proj``
and conv slices are head-aligned (:func:`held_columns`: its heads' z, x
and dt columns, and B and C whole, which every rank uses: one group), its
SSD state holds its heads, the gated RMSNorm takes the whole row's mean
(models/common.py:split_row_mean) and ``out_proj`` is row-parallel.  A
weight the layout keeps whole (the model axis does not divide it) gives
its whole output, of which the rank takes its heads' part; where the
axis does not divide the heads the mixer runs whole on every rank.  The
gradient of what every rank holds alike (B and C's columns, the per-head
vectors, a whole weight) is summed over the ranks
(sharding/collectives.py:copy_in, copy_in_columns).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.device import no_tf32, resolve_device
from repro_torch.sharding import ctx
from repro_torch.sharding.collectives import (copy_in, copy_in_columns,
                                              gather_channels)

from .common import (Param, dense, fixed_bmm, leading, residual_dense,
                     rms_norm)
from .config import ModelConfig

__all__ = [
    "ssm_build",
    "ssm_apply",
    "ssm_decode",
    "init_ssm_state",
    "ssd_chunked",
    "softplus",
    "ssm_heads",
    "ssd_readout",
    "held_columns",
]

ROWS = 8  # the rows of one fixed product call (fixed_bmm's block)


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


def held_columns(cfg: ModelConfig, leaf: str, m: int):
    """How rank ``j`` of a model axis of ``m`` holds ``in_proj`` (``leaf``
    "in_proj") or the conv's weights and state ("conv"): head-aligned,
    its heads' z, x (and dt) columns and B's and C's whole (one group,
    used by every head), ``[z_r, x_r, B, C, dt_r]`` and ``[x_r, B, C]``,
    where ``param_specs`` would cut contiguous blocks across the z / xBC
    boundary.  ``(columns, shared)`` (models/common.py:Param ``held``);
    None, whole on every rank, where ``m`` does not divide the heads or
    the leaf's width (``param_specs`` then keeps it whole).  The one
    place this layout is stated: :class:`_Mixer` splits ``in_proj``'s and
    the conv's outputs in this order, :func:`init_ssm_state` and
    serve/engine.py:local_state hold the conv state so."""
    d_inner, heads, n, conv_dim = _dims(cfg)
    width = 2 * d_inner + 2 * n + heads if leaf == "in_proj" else conv_dim
    if heads % m or width % m:
        return None
    di, hl = d_inner // m, heads // m
    x0 = d_inner if leaf == "in_proj" else 0

    def columns(j: int) -> torch.Tensor:
        parts = [torch.arange(x0 + j * di, x0 + (j + 1) * di),
                 torch.arange(x0 + d_inner, x0 + d_inner + 2 * n)]
        if leaf == "in_proj":
            parts = [torch.arange(j * di, (j + 1) * di), *parts,
                     torch.arange(2 * d_inner + 2 * n + j * hl,
                                  2 * d_inner + 2 * n + (j + 1) * hl)]
        return torch.cat(parts)

    lo = 2 * di if leaf == "in_proj" else di
    return columns, (lo, lo + 2 * n)


def ssm_build(cfg: ModelConfig) -> dict:
    d_inner, heads, n, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * n + heads  # z, xBC, dt
    conv = functools.partial(held_columns, cfg, "conv")
    return {
        "in_proj": Param((cfg.d_model, d_in_proj), ("embed", "ffn"),
                         held=functools.partial(held_columns, cfg,
                                                "in_proj")),
        "conv_w": Param((cfg.ssm_conv, conv_dim), (None, "ffn"), scale=0.1,
                        held=conv),
        "conv_b": Param((conv_dim,), ("ffn",), init="zeros", held=conv),
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


def _whole_heads(t: torch.Tensor, heads: int, h0: int) -> torch.Tensor:
    """``t`` (..., H, P) a rank's heads written at ``h0`` into zeros of the
    whole model's ``heads`` (``t`` itself where it holds them all)."""
    if t.shape[-2] == heads:
        return t
    out = t.new_zeros((*t.shape[:-2], heads, t.shape[-1]))
    out[..., h0:h0 + t.shape[-2], :] = t
    return out


def ssd_chunked(x, dt, a, b, c, chunk: int, heads: int | None = None,
                h0: int = 0):
    """Chunked SSD.

    x: (B, S, H, P) inputs, dt: (B, S, H) softplus'd step sizes,
    a: (B, S, H) = -exp(A_log) * dt, b, c: (B, S, N) (one group, shared
    across heads).  Returns y: (B, S, H, P), final_state: (B, H, N, P).
    ``heads``, ``h0``: where ``x`` holds a rank's heads, the whole model's
    count and the first of them.  Each product runs in fixed calls
    (models/common.py:fixed_bmm) of 8 rows' worth of entries: the
    per-head score product over (row, chunk, head) entries; the chunk
    states and the inter-chunk readout over (row, chunk) entries whose
    columns are every head of the whole model, a rank's written into
    zeros at their place (a product's column does not depend on the
    others; B and C are shared by the heads and stay unrepeated).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    heads = heads or h
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    ac = a.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz * nc, chunk, n)
    cc = c.reshape(bsz * nc, chunk, n)
    per_chunk = ROWS * nc  # (row, chunk) entries of one fixed call

    def by_head(t):  # (B, NC, H, ...) -> (B * NC * H, ...)
        return t.reshape(-1, *t.shape[3:])

    def mine(t):  # (B * NC, ., heads * P) -> (B, NC, ., H, P)
        return t.view(bsz, nc, t.shape[1], heads, p)[..., h0:h0 + h, :]

    with no_tf32():
        ca = torch.cumsum(ac, dim=2)  # (B, NC, Q, H) inclusive
        dtx = xc * dtc[..., None]  # (B, NC, Q, H, P)

        # intra-chunk (quadratic within a chunk)
        decay = _segsum_scores(ca)  # (B, NC, H, Q, Q)
        cb = fixed_bmm(cc, bc.transpose(1, 2), per_chunk) \
            .view(bsz, nc, chunk, chunk)
        scores = cb[:, :, None] * decay  # (B, NC, H, Q, Q)
        y_intra = fixed_bmm(by_head(scores),
                            by_head(dtx.permute(0, 1, 3, 2, 4)),
                            per_chunk * heads).view(bsz, nc, h, chunk, p)

        # chunk summary states: S_c = sum_j exp(ca_last - ca_j) B_j dtx_j^T
        last = ca[:, :, -1:, :]  # (B, NC, 1, H)
        w_end = torch.exp(last - ca)  # (B, NC, Q, H)
        xw = _whole_heads(w_end[..., None] * dtx, heads, h0)
        states = mine(fixed_bmm(bc.transpose(1, 2),
                                xw.reshape(bsz * nc, chunk, heads * p),
                                per_chunk)).permute(0, 1, 3, 2, 4)

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
        rw = _whole_heads(r_in.permute(0, 1, 3, 2, 4), heads, h0)
        y_inter = mine(fixed_bmm(cc, rw.reshape(bsz * nc, n, heads * p),
                                 per_chunk)) * w_in[..., None]
    y = (y_intra.permute(0, 1, 3, 2, 4) + y_inter).reshape(bsz, s, h, p)
    return y, r


def init_ssm_state(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None) -> dict:
    """Zero states; in a ``ctx.model_shard`` scope this rank's: the SSD
    state of its heads (:func:`ssm_heads`), the conv state as its conv
    weights are held (:func:`held_columns`)."""
    d_inner, heads, n, conv_dim = _dims(cfg)
    device = resolve_device(device)
    h0, h1 = ssm_heads(cfg)
    split = ctx.model_split()
    held = None if split is None else held_columns(cfg, "conv", split.size)
    if held is not None:
        conv_dim = held[0](split.index).numel()
    return {
        "ssd": torch.zeros((batch, h1 - h0, n, cfg.ssm_head_dim),
                           dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def ssd_readout(c: torch.Tensor, s: torch.Tensor, heads: int
                ) -> torch.Tensor:
    """Decode's ``y_h = c . S_h``: c (B, N), S (B, H, N, P) -> (B, H, P),
    each (row, head) one entry of fixed calls of ``ROWS * heads`` (the
    whole model's heads)."""
    bsz, h, n, p = s.shape
    cq = c[:, None, None, :].expand(bsz, h, 1, n)
    return fixed_bmm(cq.reshape(-1, 1, n), s.reshape(-1, n, p),
                     ROWS * heads).view(bsz, h, p)


def ssm_heads(cfg: ModelConfig) -> tuple[int, int]:
    """This rank's heads ``[h0, h1)`` of the mixer: in a
    ``ctx.model_shard`` scope whose model axis divides the heads its
    ``1 / m`` of them, else all of them (the mixer runs whole)."""
    heads = _dims(cfg)[1]
    split = ctx.model_split()
    if split is None or heads % split.size:
        return 0, heads
    hl = heads // split.size
    return split.index * hl, (split.index + 1) * hl


class _Mixer:
    """The mixer's weights as this rank uses them, and the cuts of
    ``in_proj``'s output to its heads (module docstring)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        d_inner, heads, n, conv_dim = _dims(cfg)
        self.cfg, self.n, self.pd = cfg, n, cfg.ssm_head_dim
        self.d_inner, self.heads = d_inner, heads
        self.h0, self.h1 = ssm_heads(cfg)
        self.hl = self.h1 - self.h0
        self.di = self.hl * self.pd  # this rank's x, z and y width
        split = ctx.model_split()
        self.split = split
        self.heads_split = split is not None and self.hl < heads
        # the last product row-parallel: the rank's graph reaches a part
        # of the output, so what it holds whole has its gradient summed
        self.rowpar = split is not None \
            and leading(params["out_proj"]) != d_inner
        p = params
        whole_in = p["in_proj"].shape[-1] == 2 * d_inner + 2 * n + heads
        self.whole_in = whole_in
        if self.rowpar and not whole_in:  # head-aligned: B, C shared
            self.in_proj = copy_in_columns(
                p["in_proj"], split.group,
                *held_columns(cfg, "in_proj", split.size)[1])
            conv = held_columns(cfg, "conv", split.size)
            self.conv_w, self.conv_b = (
                copy_in_columns(p[k], split.group, *conv[1]) if conv
                else self.shared(p[k]) for k in ("conv_w", "conv_b"))
        else:
            self.in_proj, self.conv_w, self.conv_b = (
                self.shared(p[k]) for k in ("in_proj", "conv_w", "conv_b"))
        cut = slice(self.h0, self.h1)
        self.a_log, self.d_skip, self.dt_bias = (
            self.shared(p[k])[cut] for k in ("a_log", "d_skip", "dt_bias"))
        self.norm = p["norm"]
        if not self.heads_split and self.norm.shape[0] != d_inner:
            # a whole mixer beside a split gamma (the model axis divides
            # d_inner but not the heads): every rank norms the whole rows
            self.norm = gather_channels(self.norm, split.group, split.index)
        self.out_proj = p["out_proj"]

    def shared(self, w):
        return copy_in(w, self.split.group) if self.rowpar else w

    def proj(self, u):
        """z, xBC (as the conv takes them) and dt of ``u``."""
        if self.rowpar:
            u = copy_in(u, self.split.group)
        zxbcdt = dense(u, self.in_proj, self.cfg.l2r, self.cfg.l2r_levels)
        if self.whole_in:
            z, xbc, dt = torch.split(
                zxbcdt, [self.d_inner, self.d_inner + 2 * self.n,
                         self.heads], dim=-1)
            return z[..., self.h0 * self.pd:self.h1 * self.pd], xbc, \
                dt[..., self.h0:self.h1]
        return torch.split(zxbcdt, [self.di, self.di + 2 * self.n, self.hl],
                           dim=-1)

    def xbc(self, xbc):
        """x of this rank's heads, B and C, from the conv's output."""
        n = self.n
        x, b, c = torch.split(xbc, [xbc.shape[-1] - 2 * n, n, n], dim=-1)
        if x.shape[-1] != self.di:  # a whole conv: this rank's heads
            x = x[..., self.h0 * self.pd:self.h1 * self.pd]
        return x, b, c

    def out(self, y, z, u_dtype):
        """The gated RMSNorm and ``out_proj`` of y (B, S, this rank's
        heads' width)."""
        cfg = self.cfg
        y = rms_norm(y.to(u_dtype) * F.silu(z), self.norm, cfg.norm_eps,
                     split=self.split if self.heads_split else None)
        if self.rowpar and not self.heads_split:  # out_proj's rows split
            k = leading(self.out_proj)
            y = y[..., self.split.index * k:(self.split.index + 1) * k]
        return residual_dense(y, self.out_proj, cfg.l2r, cfg.l2r_levels,
                              self.d_inner)


def ssm_apply(cfg: ModelConfig, params: dict, u: torch.Tensor,
              state: dict | None = None):
    """Full-sequence SSD mixer.  u: (B, S, d_model).

    Returns (y, new_state), new tensors: the conv state carries a
    continued prefill; the chunked scan starts from zeros whatever
    ``state["ssd"]`` holds, as in the reference.  In a
    ``ctx.model_shard`` scope the states hold this rank's heads (module
    docstring).
    """
    mx = _Mixer(cfg, params)
    bsz, s, _ = u.shape
    f32 = torch.float32
    z, xbc, dt = mx.proj(u)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, mx.conv_w, mx.conv_b, conv_state)
    x, b, c = mx.xbc(F.silu(xbc))
    dt = softplus(dt.to(f32) + mx.dt_bias.to(f32))
    a = -torch.exp(mx.a_log.to(f32)) * dt  # (B, S, H)

    x4 = x.reshape(bsz, s, mx.hl, cfg.ssm_head_dim)
    pad = (-s) % cfg.ssm_chunk
    xs, b, c = x4.to(f32), b.to(f32), c.to(f32)
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt, a, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (dt, a, b, c))
    y, final = ssd_chunked(xs, dt, a, b, c, cfg.ssm_chunk, mx.heads, mx.h0)
    y = y[:, :s] + mx.d_skip.to(f32)[None, None, :, None] * x4.to(f32)
    out = mx.out(y.reshape(bsz, s, mx.di), z, u.dtype)
    return out, {"ssd": final, "conv": new_conv}


def ssm_decode(cfg: ModelConfig, params: dict, u: torch.Tensor,
               state: dict):
    """One-token step.  u: (B, 1, d_model); O(1) state update.  Returns
    (y, new_state), new tensors."""
    mx = _Mixer(cfg, params)
    bsz = u.shape[0]
    f32 = torch.float32
    z, xbc, dt = mx.proj(u)
    xbc, new_conv = _causal_conv(xbc, mx.conv_w, mx.conv_b, state["conv"])
    x, b, c = (t[:, 0] for t in mx.xbc(F.silu(xbc)))  # (B, .)
    dt = softplus(dt[:, 0].to(f32) + mx.dt_bias.to(f32))
    a = torch.exp(-torch.exp(mx.a_log.to(f32)) * dt)  # (B, H)

    xh = x.reshape(bsz, mx.hl, cfg.ssm_head_dim).to(f32)
    dtx = xh * dt[..., None]
    with no_tf32():
        s_new = state["ssd"] * a[..., None, None] \
            + b.to(f32)[:, None, :, None] * dtx[:, :, None, :]
        y = ssd_readout(c.to(f32), s_new, mx.heads)
    y = y + mx.d_skip.to(f32)[None, :, None] * xh
    out = mx.out(y.reshape(bsz, 1, mx.di), z, u.dtype)
    return out, {"ssd": s_new, "conv": new_conv}
