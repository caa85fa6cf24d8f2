"""Public L2R GEMM/conv ops: plane stacking, dispatch, quant/dequant.

The port of ``repro/kernels/l2r_gemm/ops.py`` for the VGG-16 path.
Every integer GEMM here goes to a kernel wrapper of
:mod:`~repro_torch.kernels.l2r_gemm.kernel`, which follows the tensors'
device: the CUDA kernel on the card, its plain version on the CPU.
There is no backend switch.

* ``l2r_gemm``: ``schedule="stacked"`` on kernel B1, ``"pairs"`` on
  kernel B3, ``"streaming"`` (the per-level stream's final prefix) on B1
  on the card, or as the streaming walk (core/progressive.py) on the CPU
  and wherever ``early_exit`` asks for the level loop;
* ``l2r_gemm_progressive`` / ``l2r_conv2d_progressive``: the per-level
  snapshot stream with tail bounds, kernel B2 on the card;
  ``l2r_conv2d_progressive_while``: the early-exit conv stream, one B1
  level slab per tap and level on the card;
* ``CUDA_WALK``: the level walk core/progressive.py takes on CUDA
  operands (one B2 launch per scan, one B1 level slab per while-loop
  level).  The device routing of the progressive path lives here; core
  imports no kernel;
* ``l2r_attn_scores``: the digit-serial attention scores
  (core/l2r_attention.py's walks on the CPU), on the card one B1 launch
  per (batch, kv head).

``l2r_conv2d`` performs implicit im2col: activation planes are extracted
once per feature map, and each of the kh*kw taps feeds a shifted
(stride-stepped, dilation-spaced) view of the stacked map through the
GEMM, adding into one int32 accumulator.  No TPU block padding is done:
the kernels mask ragged edges themselves.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.analysis.overflow import check_or_raise
from repro_torch.core.l2r_attention import (attn_scores_stacked,
                                            attn_scores_streaming_scan,
                                            attn_scores_streaming_while)
from repro_torch.core.l2r_gemm import _f32_dot_exact, wrap_int32
from repro_torch.core.progressive import (LevelWalk, ProgressiveResult,
                                          _level_walk, _shift_add,
                                          _while_emitter, _window_dot,
                                          l2r_matmul_int_streaming,
                                          level_bounds, progressive_matmul)
from repro_torch.core.quant import (PlaneOperands, QuantConfig,
                                    QuantizedWeights, _amax,
                                    _symmetric_quant, quantize,
                                    quantize_weights, stack_planes_lhs,
                                    stack_planes_rhs)
from repro_torch.sharding.collectives import all_reduce, group_size, sum_int

from . import kernel

__all__ = ["l2r_gemm", "l2r_matmul_f", "l2r_conv2d", "l2r_gemm_progressive",
           "l2r_attn_scores",
           "l2r_conv2d_progressive", "l2r_conv2d_progressive_while",
           "CUDA_WALK", "PlaneOperands", "SCHEDULES"]

SCHEDULES = ("stacked", "streaming", "pairs")


def _lhs_stack(a, n_bits: int, log2_radix: int) -> torch.Tensor:
    """Pre-shifted (M, D*K) LHS plane stack of a raw (M, K) operand or a
    2-D :class:`PlaneOperands`."""
    if isinstance(a, PlaneOperands):
        return a.core_stack(shifted=True)
    return stack_planes_lhs(a, n_bits, log2_radix)


def _rhs_stack(b, n_bits: int, log2_radix: int) -> torch.Tensor:
    """Pre-shifted descending (D*K, N) RHS plane stack of a raw (K, N)
    operand or a 2-D :class:`PlaneOperands`."""
    if isinstance(b, PlaneOperands):
        return b.core_stack(shifted=True)
    return stack_planes_rhs(b, n_bits, log2_radix)


def _walk_stacks(aq, bq, n_bits: int, log2_radix: int):
    """The kernels' 2-D stacks of a streaming walk's operands: ``(a (M',
    D*K), b (D*K, N), lead)``, M' the product of the LHS lead; ``b`` in
    the layout it came in (B1 reads a K-major cache in place)."""
    a, b = _lhs_stack(aq, n_bits, log2_radix), _rhs_stack(bq, n_bits,
                                                          log2_radix)
    if b.ndim != 2:
        raise ValueError(f"the streaming walk takes a (K, N) right operand, "
                         f"got a stack of shape {tuple(b.shape)}")
    return (a.reshape(-1, a.shape[-1]).contiguous(), b,
            tuple(a.shape[:-1]))


def _b2_stream(aq, bq, n_bits: int, log2_radix: int, levels: int | None
               ) -> torch.Tensor:
    """The whole (L, ..., M, N) prefix stream: one launch of kernel B2."""
    a, b, lead = _walk_stacks(aq, bq, n_bits, log2_radix)
    stream = kernel.l2r_gemm_streaming_planes(a, b, n_bits, log2_radix,
                                              levels)
    return stream.reshape(stream.shape[0], *lead, b.shape[1])


def _b1_stepper(aq, bq, n_bits: int, log2_radix: int, levels: int | None
                ) -> Callable:
    """``advance(acc, t)``: one launch of kernel B1 over level t's slab (a
    one-row level table) into a copy of the running accumulator."""
    a, b, _ = _walk_stacks(aq, bq, n_bits, log2_radix)
    b = kernel._k_major(b)[0].t()  # once, not at every level

    def advance(acc, t):
        acc = acc.clone()
        kernel.l2r_gemm_stacked_planes(a, b, n_bits, log2_radix,
                                       levels=t + 1, first_level=t,
                                       out=acc.view(-1, b.shape[1]))
        return acc

    return advance


#: the level walk of core/progressive.py on CUDA operands
CUDA_WALK = LevelWalk(stream=_b2_stream, stepper=_b1_stepper)


def _describe_operand(x) -> str:
    if isinstance(x, PlaneOperands):
        return x.describe()
    return f"tensor(shape={tuple(x.shape)}, dtype={x.dtype})"


def _check_plane_operand(x, side: str, n_bits: int, log2_radix: int,
                         other=None) -> None:
    if not isinstance(x, PlaneOperands):
        return
    paired = "" if other is None \
        else f" (other operand: {_describe_operand(other)})"
    if x.side != side:
        raise ValueError(
            f"{x.describe()} prepared as {x.side!r} passed as the {side} "
            f"operand (LHS stacks ascend, RHS stacks descend — they are "
            f"not interchangeable){paired}")
    if (x.n_bits, x.log2_radix) != (n_bits, log2_radix):
        raise ValueError(
            f"{x.describe()} does not match the call "
            f"(n_bits={n_bits}, log2_radix={log2_radix}){paired}; "
            f"re-prepare the stack for this config")


def l2r_gemm(
    aq,
    bq,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    schedule: str = "stacked",
    early_exit: bool = False,
) -> torch.Tensor:
    """Integer MSDF GEMM. (M,K)x(K,N) -> int32, any shape.

    ``schedule="stacked"`` runs kernel B1 on CUDA tensors (its plain
    version on CPU tensors); either operand may be a pre-stacked
    :class:`PlaneOperands`.  ``schedule="streaming"`` asks for the final
    prefix of the per-level stream: on the card that IS B1's stacked
    result (same walk, no snapshot planes), on the CPU the streaming
    walk computes it.  ``early_exit=True`` (streaming only) runs the walk
    as the early-exit level loop, one B1 level slab per level on the
    card; with no consumer fold it runs every level.  ``schedule="pairs"``
    is the D² pair-loop baseline on raw operands, kernel B3 on the card.
    Bit-identical across schedules, including truncated ``levels``.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; valid: "
                         f"{', '.join(SCHEDULES)}")
    if early_exit and schedule != "streaming":
        raise ValueError(
            f"early_exit is a streaming-schedule control flow; "
            f"schedule={schedule!r} has no level loop to stop short "
            f"(it would be silently dropped)")
    _check_plane_operand(aq, "lhs", n_bits, log2_radix, other=bq)
    _check_plane_operand(bq, "rhs", n_bits, log2_radix, other=aq)
    k = aq.k if isinstance(aq, PlaneOperands) else (
        bq.k if isinstance(bq, PlaneOperands) else int(aq.shape[-1]))
    check_or_raise(n_bits, log2_radix, int(k), levels=levels,
                   where="l2r_gemm")
    if schedule == "pairs":
        if isinstance(aq, PlaneOperands) or isinstance(bq, PlaneOperands):
            raise TypeError(
                "schedule='pairs' (the D²-pass baseline) consumes raw int "
                "operands; pre-stacked PlaneOperands are a stacked/"
                "streaming-schedule format")
        return kernel.l2r_gemm_pairs(aq, bq, n_bits, log2_radix, levels)
    on_card = (aq.stack if isinstance(aq, PlaneOperands) else aq).is_cuda
    if schedule == "streaming" and (early_exit or not on_card):
        return l2r_matmul_int_streaming(aq, bq, n_bits, log2_radix, levels,
                                        early_exit, CUDA_WALK)
    return kernel.l2r_gemm_stacked_planes(
        _lhs_stack(aq, n_bits, log2_radix), _rhs_stack(bq, n_bits, log2_radix),
        n_bits, log2_radix, levels)


def l2r_gemm_progressive(aq, bq, n_bits: int = 8, log2_radix: int = 2,
                         levels: int | None = None) -> ProgressiveResult:
    """Per-level MSDF snapshot stream with tail bounds.

    Level l of ``result.partial`` is bit-identical to
    ``l2r_gemm(..., levels=l+1)``; on CUDA tensors the stream is one
    launch of kernel B2.  Either operand may be a pre-stacked
    :class:`PlaneOperands`.  Consumers that only fold over the stream
    should use ``core.progressive.streaming_matmul_scan``.
    """
    _check_plane_operand(aq, "lhs", n_bits, log2_radix, other=bq)
    _check_plane_operand(bq, "rhs", n_bits, log2_radix, other=aq)
    return progressive_matmul(aq, bq, n_bits, log2_radix, levels,
                              CUDA_WALK)


def _attn_b1_scores(q_po: PlaneOperands, k_po: PlaneOperands,
                    n_bits: int, log2_radix: int, levels: int | None
                    ) -> torch.Tensor:
    """Attention scores through kernel B1, the reference's kernel route.

    The score walk is a batch of independent (Q*G, dh) x (dh, S) GEMMs,
    one per (batch, kv head), and each is B1's problem: one launch each
    over slices of the same stacks the plain walk consumes, pre-shifted.
    The cache's descending head-dim blocks are, per key, the contiguous
    D*dh bytes B1 reads K-major, so the key slice goes in in place; the
    query rows (q, g) are copied contiguous.  For parity runs and small
    decode shapes: the loop launches B*Kv kernels.
    """
    qs = q_po.core_stack(shifted=True)   # (B, Q, Kv, G, D*dh) ascending
    ks = k_po.core_stack(shifted=True)   # (B, S, Kv, D*dh) descending
    b_, q_, kv, g = qs.shape[:4]
    s_ = ks.shape[1]
    out = torch.empty((b_, kv, g, q_, s_), dtype=torch.int32,
                      device=qs.device)
    for bi in range(b_):
        for kvi in range(kv):
            a = qs[bi, :, kvi].reshape(q_ * g, -1).contiguous()
            t = kernel.l2r_gemm_stacked_planes(a, ks[bi, :, kvi].t(), n_bits,
                                               log2_radix, levels)
            out[bi, kvi] = t.view(q_, g, s_).transpose(0, 1)
    return out


def l2r_attn_scores(
    qq,
    kq,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    schedule: str = "stacked",
    early_exit: bool = False,
) -> torch.Tensor:
    """Digit-serial QK^T scores: int32 (B, Kv, G, Q, S).

    ``qq`` is the grouped query block (B, Q, Kv, G, dh) as signed ints or
    a prepared LHS :class:`PlaneOperands`; ``kq`` the cached keys
    (B, S, Kv, dh) as signed ints or the KV cache's incrementally
    stacked RHS operand (models/attention.py:kv_plane_operands).
    Bit-identical across devices and schedules at every ``levels``
    truncation; softmax and PV stay float outside this entry.

    CPU tensors take core/l2r_attention.py's walks: ``schedule=
    "stacked"`` the level-stacked schedule, ``"streaming"`` the per-level
    prefix emitter (``early_exit`` its while-loop form, with no consumer
    fold every level runs).  CUDA tensors run kernel B1, one launch per
    (batch, kv head), for either schedule (B1 walks the same levels and
    gives the final prefix); ``early_exit`` is rejected there, as the
    reference rejects it off its jnp backend.
    """
    if schedule not in ("stacked", "streaming"):
        raise ValueError(
            f"l2r_attn_scores schedule must be 'stacked' or 'streaming', "
            f"got {schedule!r} (the pairs baseline is a GEMM-only "
            f"regression schedule)")
    if early_exit and schedule != "streaming":
        raise ValueError(
            f"early_exit is a streaming-schedule control flow; "
            f"schedule={schedule!r} has no level loop to stop short "
            f"(it would be silently dropped)")
    on_card = (qq.stack if isinstance(qq, PlaneOperands) else qq).is_cuda
    if early_exit and on_card:
        raise ValueError(
            "early_exit=True is the plain while-loop emitter; kernel B1's "
            "route on CUDA tensors cannot stop its walk at run time and "
            "would silently drop the flag")
    _check_plane_operand(qq, "lhs", n_bits, log2_radix, other=kq)
    _check_plane_operand(kq, "rhs", n_bits, log2_radix, other=qq)
    dh = qq.k if isinstance(qq, PlaneOperands) else (
        kq.k if isinstance(kq, PlaneOperands) else int(qq.shape[-1]))
    check_or_raise(n_bits, log2_radix, int(dh), levels=levels,
                   where="l2r_attn_scores")
    if on_card:
        q_po = qq if isinstance(qq, PlaneOperands) \
            else PlaneOperands.prepare_lhs(qq, n_bits, log2_radix)
        k_po = kq if isinstance(kq, PlaneOperands) \
            else PlaneOperands.prepare_rhs(kq, n_bits, log2_radix, axis=-1)
        return _attn_b1_scores(q_po, k_po, n_bits, log2_radix, levels)
    if schedule == "stacked":
        return attn_scores_stacked(qq, kq, n_bits, log2_radix, levels)
    walk = attn_scores_streaming_while if early_exit \
        else attn_scores_streaming_scan
    acc, _, _ = walk(qq, kq, n_bits=n_bits, log2_radix=log2_radix,
                     levels=levels)
    return acc


def _row_split_quant(xf: torch.Tensor, keep: int | None, cfg: QuantConfig,
                     group) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize`` of a tensor whose contraction dim is split over
    ``group``: the amax (per ``keep`` dim, or per tensor) is the whole
    tensor's, an exact MAX all-reduce of the ranks' amaxes."""
    amax = _amax(xf, {keep % xf.ndim}) if keep is not None \
        else xf.abs().amax()
    return _symmetric_quant(xf, all_reduce(amax, "max", group), cfg)


def l2r_matmul_f(
    x: torch.Tensor,
    w: torch.Tensor | None,
    cfg: QuantConfig = QuantConfig(),
    levels: int | None = None,
    w_q: QuantizedWeights | tuple[torch.Tensor, torch.Tensor] | None = None,
    schedule: str = "stacked",
    group=None,
) -> torch.Tensor:
    """Float -> quantize (per row) -> MSDF GEMM -> dequantized float.

    ``w_q`` (built once at load) skips the weight quantization; when it
    carries a matching pre-stacked RHS plane stack, the GEMM consumes
    the stack directly.

    ``group`` makes it the row-parallel product of a process group whose
    ranks each hold a K-slice of ``x`` (its last dim) and of the weight's
    rows: each activation row's scale comes from the whole row (a MAX
    all-reduce of the slices' amaxes; a float weight's per-out-channel
    scale likewise from the whole column, a cache's scale is the whole
    column's already), the GEMM runs on the rank's K-slice, and the
    ranks' int32 partials are summed exactly (collectives.sum_int, wrapping
    as one accumulator) before the dequantization: the one-rank product
    bit for bit, at every ``levels`` (each level prefix is additive over
    K).  The int32 certificate is the whole K's.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    # per-row (per-token) activation scales commute with the K-contraction
    keep = 0 if cfg.per_channel else None
    if group is not None:
        check_or_raise(cfg.n_bits, cfg.log2_radix,
                       x2.shape[-1] * group_size(group),
                       levels=levels, where="l2r_matmul_f (row-parallel)")
        xq, xs = _row_split_quant(x2.to(torch.float32), keep, cfg, group)
    else:
        xq, xs = quantize(x2, cfg, axis=keep)
    w_in = None
    if w_q is None and group is not None:
        wq, ws = _row_split_quant(w.to(torch.float32), -1, cfg, group)
    elif w_q is None:
        wq, ws = quantize(w, cfg, axis=-1)  # per-out-channel: (1, N)
    elif isinstance(w_q, QuantizedWeights):
        wq, ws = w_q.q, w_q.scale
        p = w_q.planes
        if (p is not None and schedule != "pairs"
                and p.matches(cfg.n_bits, cfg.log2_radix, ndim=2,
                              side="rhs")):
            w_in = p
    else:
        wq, ws = w_q
    out = l2r_gemm(xq, wq if w_in is None else w_in, cfg.n_bits,
                   cfg.log2_radix, levels, schedule=schedule)
    if group is not None:
        out = sum_int(out, group)
    out = out.to(torch.float32) * xs * ws.reshape(1, -1)
    return out.to(x.dtype).reshape(*lead, wq.shape[-1])


def _conv_same_geometry(h: int, w_: int, kh: int, kw: int,
                        stride: tuple[int, int], dilation: tuple[int, int]):
    """Output size + per-edge padding of a "SAME" conv (XLA/TF convention:
    total pad = max((out-1)*stride + eff_k - in, 0), low edge gets the
    floor half)."""
    sh, sw = stride
    dh, dw = dilation
    oh, ow = -(-h // sh), -(-w_ // sw)
    eff_kh, eff_kw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    ph = max((oh - 1) * sh + eff_kh - h, 0)
    pw = max((ow - 1) * sw + eff_kw - w_, 0)
    return oh, ow, (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def _tap_view(xp: torch.Tensor, dy: int, dx: int, oh: int, ow: int,
              stride: tuple[int, int], dilation: tuple[int, int]
              ) -> torch.Tensor:
    """Shifted (strided) view of the padded NHWC map feeding tap (dy, dx):
    out[y, x] consumes xp[y*sh + dy*dh, x*sw + dx*dw]."""
    sh, sw = stride
    dh, dw = dilation
    return xp[:, dy * dh:dy * dh + (oh - 1) * sh + 1:sh,
              dx * dw:dx * dw + (ow - 1) * sw + 1:sw]


def _conv_w_geom(w_in) -> tuple[int, int, int, int]:
    """(kh, kw, cin, cout) of a raw conv weight or its PlaneOperands cache."""
    if isinstance(w_in, PlaneOperands):
        kh, kw = w_in.stack.shape[0], w_in.stack.shape[1]
        return kh, kw, w_in.k, w_in.stack.shape[-1]
    return tuple(w_in.shape)


def _conv_wrev(w_in, n_bits: int, log2_radix: int, shifted: bool
               ) -> torch.Tensor:
    """Reversed RHS plane stack (kh, kw, D*cin, cout) of the conv weight:
    from the load-time cache when present, extracted here otherwise."""
    if isinstance(w_in, PlaneOperands):
        return w_in.core_stack(shifted)
    return stack_planes_rhs(w_in, n_bits, log2_radix, axis=-2,
                            shifted=shifted)


def _conv_taps(xq: torch.Tensor, w_in, n_bits: int, log2_radix: int,
               stride: tuple[int, int], dilation: tuple[int, int]):
    """The GEMM operands of each tap of the fused conv.

    Returns ``(out_shape, taps)``: ``taps()`` yields, per tap (dy, dx),
    its (B*OH*OW, D*cin) activation copy (the shifted view of the
    pre-shifted activation stack, built once per feature map, made
    contiguous) and its (D*cin, cout) reversed weight stack, a view in
    the cache's layout (K-major for B1).  One copy lives at a time.
    """
    bsz, h, w_, cin = xq.shape
    kh, kw, _, cout = _conv_w_geom(w_in)
    oh, ow, (ph_lo, ph_hi), (pw_lo, pw_hi) = _conv_same_geometry(
        h, w_, kh, kw, stride, dilation)
    xp = F.pad(xq, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    xsp = stack_planes_lhs(xp, n_bits, log2_radix)  # (B, H', W', D*cin)
    wrev = _conv_wrev(w_in, n_bits, log2_radix, shifted=True)

    def taps():
        for dy in range(kh):
            for dx in range(kw):
                a = _tap_view(xsp, dy, dx, oh, ow, stride, dilation)
                yield (a.reshape(bsz * oh * ow, -1).contiguous(),
                       wrev[dy, dx])

    return (bsz, oh, ow, cout), taps


def _l2r_conv2d_int(
    xq: torch.Tensor,
    w_in,
    n_bits: int,
    log2_radix: int,
    levels: int | None,
    stride: tuple[int, int] = (1, 1),
    dilation: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Integer core of the fused conv: implicit im2col over kh*kw taps.

    xq: (B, H, W, cin) small ints; ``w_in``: (kh, kw, cin, cout) small
    ints OR the pre-stacked :class:`PlaneOperands` weight cache; "SAME"
    padding.  Bit-identical to quantized im2col + ``l2r_matmul_int``:
    the contraction over (kh, kw, cin) splits into kh*kw cin-contractions
    whose int32 sums add exactly.  Each tap's GEMM (kernel B1) adds into
    one accumulator.
    """
    out_shape, taps = _conv_taps(xq, w_in, n_bits, log2_radix, stride,
                                 dilation)
    acc = torch.zeros((out_shape[0] * out_shape[1] * out_shape[2],
                       out_shape[3]), dtype=torch.int32, device=xq.device)
    for a, w2 in taps():
        kernel.l2r_gemm_stacked_planes(a, w2, n_bits, log2_radix, levels,
                                       out=acc)
    return acc.reshape(out_shape)


def _pair(v: int | tuple[int, int]) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_w_in(w_q: QuantizedWeights, cfg: QuantConfig):
    """The conv weight operand: the cached plane stack when its layout
    matches this call's config (contraction axis -2), else the raw int
    weight (inline extraction — bit-identical)."""
    p = w_q.planes
    if p is not None and p.matches(cfg.n_bits, cfg.log2_radix, ndim=4,
                                   side="rhs", contract_axis=2):
        return p
    return w_q.q


def l2r_conv2d(
    x: torch.Tensor,
    w: torch.Tensor | None,
    b: torch.Tensor | None = None,
    cfg: QuantConfig = QuantConfig(),
    levels: int | None = None,
    w_q: QuantizedWeights | None = None,
    stride: int | tuple[int, int] = 1,
    dilation: int | tuple[int, int] = 1,
) -> torch.Tensor:
    """Fused L2R conv2d, NHWC/HWIO, "SAME" padding, any stride/dilation.

    Activations are quantized per image (scales commute with the window
    contraction); ``w_q`` reuses a load-time weight cache, otherwise
    ``w`` (kh, kw, cin, cout) is quantized per output channel here.
    """
    if w_q is None:
        w_q = quantize_weights(w, cfg)  # (kh,kw,cin,cout), scale (1,1,1,cout)
    kh, kw, cin, _ = w_q.q.shape
    check_or_raise(cfg.n_bits, cfg.log2_radix, int(cin), levels=levels,
                   taps=int(kh * kw), where="l2r_conv2d")
    xq, xs = quantize(x, cfg, axis=0)  # per-image scales (B,1,1,1)
    out = _l2r_conv2d_int(xq, _conv_w_in(w_q, cfg), cfg.n_bits,
                          cfg.log2_radix, levels, _pair(stride),
                          _pair(dilation))
    out = out.to(torch.float32) * xs * w_q.scale.reshape(1, 1, 1, -1)
    out = out.to(x.dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


# ------------------------------------------------------- progressive conv
def _conv_level_term(xq, w_in, n_bits: int, log2_radix: int,
                     stride: tuple[int, int], dilation: tuple[int, int]):
    """Per-level term of the progressive conv's plain (CPU) walk: hoisted
    zero-padded raw-digit plane stacks and a ``term(ao, bo)`` closure
    summing one significance level's tap contributions, the reference's
    window walk with the tap loop inside the level step.  ``w_in`` may
    be the pre-stacked weight cache (its window stack is the padded
    stack built here)."""
    bsz, h, w_, cin = xq.shape
    kh, kw, _, cout = _conv_w_geom(w_in)
    d = n_bits // log2_radix
    oh, ow, (ph_lo, ph_hi), (pw_lo, pw_hi) = _conv_same_geometry(
        h, w_, kh, kw, stride, dilation)
    xp = F.pad(xq, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    xsp = PlaneOperands.prepare_lhs(xp, n_bits, log2_radix).window_stack()
    if not isinstance(w_in, PlaneOperands):
        w_in = PlaneOperands.prepare_rhs(w_in, n_bits, log2_radix, axis=-2)
    wrev = w_in.window_stack()
    use_f32 = _f32_dot_exact(cin, d, log2_radix)
    if use_f32:
        xsp = xsp.to(torch.float32)
        wrev = wrev.to(torch.float32)
    width = d * cin

    def term(ao: int, bo: int) -> torch.Tensor:
        t_sum = torch.zeros((bsz, oh, ow, cout), dtype=torch.int64,
                            device=xq.device)
        for dy in range(kh):
            for dx in range(kw):
                a = _tap_view(xsp, dy, dx, oh, ow, stride, dilation)
                t_sum += _window_dot(a[..., ao * cin:ao * cin + width],
                                     wrev[dy, dx, bo * cin:bo * cin + width])
        return wrap_int32(t_sum)

    return term, (bsz, oh, ow, cout)


def _l2r_conv2d_progressive_int(
    xq: torch.Tensor,
    w_in,
    n_bits: int,
    log2_radix: int,
    levels: int | None,
    stride: tuple[int, int] = (1, 1),
    dilation: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Per-level prefix stream of the fused conv: (L, B, OH, OW, cout).

    Level l is bit-identical to ``_l2r_conv2d_int(..., levels=l+1)``: the
    taps share each significance level, so the per-level conv term is the
    tap sum of per-level GEMM terms.  On CUDA tensors each tap is one
    launch of kernel B2 adding its snapshot stream into one (L, B*OH*OW,
    cout) stream (the reference pads to 128-blocks and sums nine streams;
    int32 wrapping addition is associative, so the bits agree).  CPU
    tensors take the reference's window walk.
    """
    a_off, b_off, svals = _level_walk(n_bits // log2_radix, levels)
    n_steps = len(svals)
    if xq.is_cuda:
        (bsz, oh, ow, cout), taps = _conv_taps(xq, w_in, n_bits, log2_radix,
                                               stride, dilation)
        acc = torch.zeros((n_steps, bsz * oh * ow, cout), dtype=torch.int32,
                          device=xq.device)
        if n_steps:
            for a, w2 in taps():
                kernel.l2r_gemm_streaming_planes(a, w2, n_bits, log2_radix,
                                                 levels, out=acc)
        return acc.reshape(n_steps, bsz, oh, ow, cout)
    term, out_shape = _conv_level_term(xq, w_in, n_bits, log2_radix, stride,
                                       dilation)
    acc = torch.zeros(out_shape, dtype=torch.int32, device=xq.device)
    snaps = []
    for ao, bo, s in zip(a_off, b_off, svals):
        acc = _shift_add(acc, term(ao, bo), log2_radix * s)
        snaps.append(acc)
    return torch.stack(snaps) if snaps else \
        torch.zeros((0, *out_shape), dtype=torch.int32, device=xq.device)


def l2r_conv2d_progressive_while(
    x: torch.Tensor,
    w: torch.Tensor | None = None,
    cfg: QuantConfig = QuantConfig(),
    fold: Callable | None = None,
    init=None,
    done_fn: Callable | None = None,
    levels: int | None = None,
    w_q: QuantizedWeights | None = None,
    stride: int | tuple[int, int] = 1,
    dilation: int | tuple[int, int] = 1,
):
    """Early-exit fused conv stream: one significance level per
    iteration, the consumer's ``fold(carry, partial, level_index)`` after
    each, stopping once ``done_fn(carry)`` is true (``None`` runs every
    level).  After ``levels_run`` levels the prefix is bit-identical to
    ``partial[levels_run - 1]`` of :func:`l2r_conv2d_progressive`.

    CPU tensors take the plain level term (the reference's window walk);
    CUDA tensors take kernel B1, one launch per tap over that level's
    slab (the tap copies are made again at each level), and one host
    read of the done flag per level.

    Returns ``(prefix (B, OH, OW, cout) int32, fold_carry, levels_run,
    scale (B, 1, 1, cout))``; ``prefix * scale`` is the float feature-map
    prefix at the exit level.
    """
    if w_q is None:
        w_q = quantize_weights(w, cfg)
    xq, xs = quantize(x, cfg, axis=0)  # per-image scales (B,1,1,1)
    scale = xs * w_q.scale.reshape(1, 1, 1, -1)
    w_in, stride, dilation = _conv_w_in(w_q, cfg), _pair(stride), \
        _pair(dilation)
    n_bits, log2_radix = cfg.n_bits, cfg.log2_radix
    a_off, b_off, svals = _level_walk(cfg.planes, levels)
    if xq.is_cuda:
        out_shape, taps = _conv_taps(xq, w_in, n_bits, log2_radix, stride,
                                     dilation)

        def advance(acc, t):
            acc = acc.clone()
            for a, w2 in taps():
                kernel.l2r_gemm_stacked_planes(
                    a, w2, n_bits, log2_radix, levels=t + 1, first_level=t,
                    out=acc.view(-1, out_shape[-1]))
            return acc
    else:
        term, out_shape = _conv_level_term(xq, w_in, n_bits, log2_radix,
                                           stride, dilation)

        def advance(acc, t):
            return _shift_add(acc, term(a_off[t], b_off[t]),
                              log2_radix * svals[t])
    acc0 = torch.zeros(out_shape, dtype=torch.int32, device=xq.device)
    t, acc, fold_c = _while_emitter(advance, len(svals), acc0, fold, init,
                                    done_fn)
    return acc, fold_c, t, scale


def l2r_conv2d_progressive(
    x: torch.Tensor,
    w: torch.Tensor | None = None,
    cfg: QuantConfig = QuantConfig(),
    levels: int | None = None,
    w_q: QuantizedWeights | None = None,
    stride: int | tuple[int, int] = 1,
    dilation: int | tuple[int, int] = 1,
):
    """Progressive-precision fused conv: per-level snapshots + tail bounds.

    Returns ``(result, scale)``: ``result.partial[l]`` is the integer
    conv truncated after l+1 MSDF levels (bit-identical to
    ``l2r_conv2d``'s core at ``levels=l+1``), with tail bounds for the
    effective contraction K = kh*kw*cin; ``scale`` (B, 1, 1, cout) is the
    dequantization factor, so ``partial[l] * scale`` is the float
    feature-map prefix and ``tail_bound[l] * scale`` bounds its distance
    from the exact W8A8 conv.
    """
    if w_q is None:
        w_q = quantize_weights(w, cfg)
    xq, xs = quantize(x, cfg, axis=0)  # per-image scales (B,1,1,1)
    kh, kw, cin, _ = w_q.q.shape
    stack = _l2r_conv2d_progressive_int(
        xq, _conv_w_in(w_q, cfg), cfg.n_bits, cfg.log2_radix, levels,
        _pair(stride), _pair(dilation))
    bounds = level_bounds(cfg.planes, cfg.log2_radix, kh * kw * cin, levels,
                          device=stack.device)
    result = ProgressiveResult(partial=stack, tail_bound=bounds.f32,
                               bound_i32=bounds.i32,
                               decidable=bounds.decidable)
    return result, xs * w_q.scale.reshape(1, 1, 1, -1)
