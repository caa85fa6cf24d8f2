"""Public L2R GEMM/conv ops: plane stacking, dispatch, quant/dequant.

The port of ``repro/kernels/l2r_gemm/ops.py`` for the main path.  Every
integer GEMM here feeds pre-shifted plane stacks to
:func:`~repro_torch.kernels.l2r_gemm.kernel.l2r_gemm_stacked_planes`
(kernel B1), which follows the tensors' device: the CUDA kernel on the
card, its plain version on the CPU.  There is no backend switch.

``l2r_conv2d`` performs implicit im2col: activation planes are extracted
once per feature map, and each of the kh*kw taps feeds a shifted
(stride-stepped, dilation-spaced) view of the stacked map through the
GEMM, adding into one int32 accumulator.  No TPU block padding is done:
the kernel masks ragged edges itself.

The progressive (streaming) entries and the attention scores come with
later slices of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.analysis.overflow import check_or_raise
from repro_torch.core.quant import (PlaneOperands, QuantConfig,
                                    QuantizedWeights, quantize,
                                    quantize_weights, stack_planes_lhs,
                                    stack_planes_rhs)

from . import kernel
from .ref import l2r_gemm_ref

__all__ = ["l2r_gemm", "l2r_matmul_f", "l2r_conv2d", "PlaneOperands",
           "SCHEDULES"]

SCHEDULES = ("stacked", "pairs")


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
) -> torch.Tensor:
    """Integer MSDF GEMM. (M,K)x(K,N) -> int32, any shape.

    ``schedule="stacked"`` runs kernel B1 on CUDA tensors (its plain
    version on CPU tensors); either operand may be a pre-stacked
    :class:`PlaneOperands`.  ``schedule="pairs"`` is the D² pair-loop
    baseline on raw operands; its kernel (B3) is not ported yet, so it
    runs on CPU tensors only.  Bit-identical across schedules, including
    truncated ``levels``.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; valid: "
                         f"{', '.join(SCHEDULES)}")
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
                "operands; pre-stacked PlaneOperands are a stacked-"
                "schedule format")
        if aq.is_cuda:
            raise NotImplementedError(
                "schedule='pairs' has no CUDA kernel yet (kernel B3, "
                "repro/kernels/l2r_gemm/kernel.py:l2r_gemm_pallas); use "
                "schedule='stacked' on the card")
        return l2r_gemm_ref(aq, bq, n_bits, log2_radix, levels)
    return kernel.l2r_gemm_stacked_planes(
        _lhs_stack(aq, n_bits, log2_radix), _rhs_stack(bq, n_bits, log2_radix),
        n_bits, log2_radix, levels)


def l2r_matmul_f(
    x: torch.Tensor,
    w: torch.Tensor | None,
    cfg: QuantConfig = QuantConfig(),
    levels: int | None = None,
    w_q: QuantizedWeights | tuple[torch.Tensor, torch.Tensor] | None = None,
    schedule: str = "stacked",
) -> torch.Tensor:
    """Float -> quantize (per row) -> MSDF GEMM -> dequantized float.

    ``w_q`` (built once at load) skips the weight quantization; when it
    carries a matching pre-stacked RHS plane stack, the GEMM consumes
    the stack directly.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    # per-row (per-token) activation scales commute with the K-contraction
    xq, xs = quantize(x2, cfg, axis=0 if cfg.per_channel else None)
    w_in = None
    if w_q is None:
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
    whose int32 sums add exactly.  The activation stack is built once
    per feature map; each tap's view is copied contiguous and the GEMM
    adds it into the accumulator.
    """
    bsz, h, w_, cin = xq.shape
    kh, kw, _, cout = _conv_w_geom(w_in)
    oh, ow, (ph_lo, ph_hi), (pw_lo, pw_hi) = _conv_same_geometry(
        h, w_, kh, kw, stride, dilation)
    xp = F.pad(xq, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    xsp = stack_planes_lhs(xp, n_bits, log2_radix)  # (B, H', W', D*cin)
    wrev = _conv_wrev(w_in, n_bits, log2_radix, shifted=True)
    acc = torch.zeros((bsz * oh * ow, cout), dtype=torch.int32,
                      device=xq.device)
    for dy in range(kh):
        for dx in range(kw):
            a = _tap_view(xsp, dy, dx, oh, ow, stride, dilation)
            kernel.l2r_gemm_stacked_planes(
                a.reshape(bsz * oh * ow, -1).contiguous(),
                wrev[dy, dx].contiguous(), n_bits, log2_radix, levels,
                out=acc)
    return acc.reshape(bsz, oh, ow, cout)


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
