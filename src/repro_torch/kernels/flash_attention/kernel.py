"""Kernels B5 and B4: flash attention, float and with the MSDF level-walk
scores, and their plain versions.

* B5 (``csrc/flash_attention.cu``) replaces
  ``repro/kernels/flash_attention/kernel.py:_kernel`` (entry
  ``flash_attention_pallas``): online-softmax attention over KV tiles with
  causal, window and key-length masks and GQA.  f32 runs both products on
  the TF32 tensor cores as the 3xTF32 split (within the 3e-5 limit; one
  TF32 product would not be); bf16 runs QK^T as f32 FMAs in d order (the
  plain version's dot, bit for bit, so that p rounds to the same bf16)
  and PV on the bf16 tensor cores.
* B4 (``csrc/flash_attention_l2r.cu``) replaces ``_l2r_kernel`` (entry
  ``flash_attention_l2r_pallas``): the same, with each score tile the
  MSDF level walk over the per-vector-quantized int8 q and k, run on the
  int8 tensor cores as the few masked products of
  ``core/online.py:msdf_products`` (one at full depth); ``levels``
  truncates the walk.  PV runs on the bf16 tensor cores for bf16 v and
  as f32 FMAs for f32 v.

Both take any head width.  Above 128 (recurrentgemma-2b's 256) they take
the wide layout of ``csrc/flash_softmax.cuh``: 8 warps own 64 q rows and
up to 256 output columns (a column grid dimension only above dh 256), the
two warps of a row group each compute half of a KV tile's scores over the
whole dh and their exps and exchange p, so each score is computed once.
B4 on int16 q and k (n_bits 9-16), and on int8 above 128, takes its wide
entry ``flash_attention_l2r_wide`` in that layout, QK^T on the int8
tensor cores (an int16 product as its byte split,
:func:`l2r_byte_split_scores`, mod 2^32 as the reference's int32 dot);
both routes count as ``LAUNCHES["flash_attention_l2r"]``.

Both run the warp-layout online softmax, bf16 PV and epilogue of
``csrc/flash_softmax.cuh`` (4 warps of 16 q rows up to dh 128, K and V
double-buffered through ``cp.async``) and differ in how they fill a score
tile.  Layouts are the reference's: q (B, Sq, H, dh), k and v (B, Skv, Kv,
dh), out (B, Sq, H, dh) in v's dtype; kv head = q head // (H / Kv).

Each wrapper dispatches on the operands' device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version.  The
kernels have no backward: :class:`FlashAttentionL2R` here and
``ops.FlashAttention`` launch B4 and B5 forward and take the gradient of
a plain function the caller names (models/attention.py passes its
query-chunk loop with the call's own arguments), recomputed under
autograd (:func:`plain_grads`).  The plain
versions walk KV blocks with the reference's online softmax (``bkv``
keys at a time, by default the kernels' own KV tile, so that the running
max and the rounding of p to v's dtype follow the kernel's steps) in
torch, true f32 (TF32 off).  ``LAUNCHES[name]``
counts one kernel's launches and nothing else.

Inside a graph capture, and on a ``meta`` tensor on the card's path
(kernels/_build.py:as_op), a wrapper calls its kernel as the custom op
``repro_torch::flash_attention`` / ``repro_torch::flash_attention_l2r``
(B4 on the operands the kernel reads: :func:`l2r_kernel_operands`): one
node of the graph, the same launch on the card and the plain version on
the CPU.  The work PERF.md's bound column counts, :func:`flash_cost`
(with :func:`visible_pairs` and :func:`attention_ops`), is the ops' FLOP
formula and chip_smoke.py's bound.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.l2r_attention import quantize_per_vector
from repro_torch.core.l2r_gemm import wrap_int32
from repro_torch.core.online import (msdf_level_slices, msdf_products,
                                    plane_bits)
from repro_torch.core.quant import (QuantConfig, _int_dtype, plane_count,
                                    stack_planes_lhs, stack_planes_rhs)
from repro_torch.device import no_tf32
from repro_torch.kernels import _build
from repro_torch.kernels.l2r_gemm.kernel import byte_split_matmul

__all__ = ["LAUNCHES", "flash_attention_kernel",
           "flash_attention_kernel_plain", "flash_attention_l2r",
           "flash_attention_l2r_plain", "l2r_operands", "l2r_score_tile",
           "l2r_masks", "l2r_byte_split_scores", "l2r_width", "l2r_wide",
           "l2r_kernel_operands",
           "flash_attention_l2r_launch", "plain_grads", "FlashAttentionL2R",
           "visible_pairs", "attention_ops", "flash_cost"]

#: kernel launches per library since the counts were last reset (plain
#: calls are not counted)
LAUNCHES = {"flash_attention": 0, "flash_attention_l2r": 0}

_NEG = -1e30
KV_TILE = 64  # keys per KV tile of both kernels (flash_softmax.cuh: kBKV)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _F, _I],
    "flash_attention_l2r": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _F, _I, _P, _P, _I],
    "flash_attention_l2r_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _F, _I, _P, _P, _I, _I],
}


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, Sq, H, dh) and k, v (B, Skv, Kv, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, dh = q.shape
    _, skv, kvh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or h % kvh:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}: same batch and dh, and H a "
                         f"multiple of Kv")
    return b, sq, h, dh, skv, kvh


def _gqa_rows(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, w) -> (B, Kv, G, S, w): q head h = kv * G + g."""
    b, s, h, w = x.shape
    return x.reshape(b, s, kvh, h // kvh, w).permute(0, 2, 3, 1, 4)


def _gqa_keys(x: torch.Tensor) -> torch.Tensor:
    """(B, S, Kv, w) -> (B, Kv, 1, S, w)."""
    return x.permute(0, 2, 1, 3).unsqueeze(2)


def _online_softmax_plain(scores, v, sq: int, h: int, causal: bool,
                          window: int | None, bkv: int) -> torch.Tensor:
    """The reference kernel's online softmax in torch over KV blocks of
    ``bkv`` keys: ``scores(lo, hi)`` gives the f32 (B, Kv, G, Sq, hi-lo)
    scores of keys [lo, hi).  Returns (B, Sq, H, dh) in v's dtype."""
    b, skv, kvh, dh = v.shape
    dev = v.device
    g = h // kvh
    m = torch.full((b, kvh, g, sq, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, dh), dtype=torch.float32, device=dev)
    q_pos = torch.arange(sq, device=dev)[:, None]
    vt = _gqa_keys(v)
    for lo in range(0, skv, bkv):
        hi = min(lo + bkv, skv)
        if causal and lo > sq - 1:  # the whole block lies above the band
            break
        kv_pos = torch.arange(lo, hi, device=dev)[None, :]
        mask = torch.ones((sq, hi - lo), dtype=torch.bool, device=dev)
        if causal:
            mask &= kv_pos <= q_pos
        if window is not None:
            mask &= kv_pos > q_pos - window
        s = torch.where(mask, scores(lo, hi), _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).to(torch.float32),
                          vt[:, :, :, lo:hi].to(torch.float32))
        acc = acc * alpha + pv
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)).to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """The (query, key) pairs a mask lets through: key j of query i is seen
    when ``j <= i`` (causal) and ``j > i - window`` (a window)."""
    total = 0
    for i in range(sq):
        hi = min(skv, i + 1) if causal else skv
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def attention_ops(b: int, h: int, dh: int, pairs: int, dtype: torch.dtype,
                  qk_int8: bool = False, qk_int16: bool = False) -> dict:
    """QK^T and PV at 2 dh operations per visible pair each, by the peak
    they run at (launch/roofline.py:PEAKS): bf16 on the bf16 tensor cores,
    f32 as the 3xTF32 split (``"tf32x3"``), B4's QK^T on the int8 tensor
    cores; on int16 q and k (``qk_int16``) each product counts as four
    int8 products (the byte split)."""
    per = 2 * b * h * pairs * dh
    peak = "bf16" if dtype == torch.bfloat16 else "tf32x3"
    ops = {peak: per}
    qk = "int8" if qk_int8 or qk_int16 else peak
    ops[qk] = ops.get(qk, 0) + per * (4 if qk_int16 else 1)
    return ops


def flash_cost(b: int, sq: int, skv: int, h: int, kvh: int, dh: int,
               causal: bool, window, dtype: torch.dtype,
               qk_int8: bool = False, qk_int16: bool = False
               ) -> tuple[dict, int]:
    """Kernel B5's (B4's with ``qk_int8``, on int16 q and k with
    ``qk_int16``) work: :func:`attention_ops` over the visible pairs, and
    q, k, v read and the output written once in ``dtype``."""
    elem = torch.empty((), dtype=dtype).element_size()
    return (attention_ops(b, h, dh, visible_pairs(sq, skv, causal, window),
                          dtype, qk_int8, qk_int16),
            (2 * b * sq * h * dh + 2 * b * skv * kvh * dh) * elem)


def _require(which: str, *tensors, dtypes=None) -> None:
    dev = tensors[0].device
    for x in tensors:
        if (x.device != dev or not x.is_contiguous()
                or (dtypes is not None and x.dtype not in dtypes)):
            raise ValueError(
                f"kernel {which} takes contiguous tensors on one card"
                f"{'' if dtypes is None else f' of dtype {dtypes}'}, got "
                f"{x.dtype} on {x.device}")


# ------------------------------------------------------------ B5: float
def flash_attention_kernel_plain(q, k, v, causal: bool = True,
                                 window: int | None = None,
                                 scale: float | None = None,
                                 bkv: int = KV_TILE) -> torch.Tensor:
    """Plain version of kernel B5: the reference kernel's online softmax
    over blocks of ``bkv`` keys, f32 QK^T, p cast to v's dtype before PV."""
    b, sq, h, dh, skv, kvh = _shapes(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qt = _gqa_rows(q, kvh).to(torch.float32)
    kt = _gqa_keys(k).to(torch.float32)

    def scores(lo, hi):
        return torch.matmul(qt, kt[:, :, :, lo:hi].transpose(-1, -2)) * scale

    with no_tf32():
        return _online_softmax_plain(scores, v, sq, h, causal, window,
                                     min(bkv, skv))


def flash_attention_kernel(q, k, v, causal: bool = True,
                           window: int | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """Flash attention: kernel B5.  q (B, Sq, H, dh), k and v (B, Skv, Kv,
    dh) -> (B, Sq, H, dh) in v's dtype.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel: q, k, v contiguous, all f32 or all bf16, any dh (above 128 the
    wide layout).
    """
    b, sq, h, dh, skv, kvh = _shapes(q, k, v)
    if _build.as_op(q):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window,
                                                     scale)
    if not q.is_cuda:
        return flash_attention_kernel_plain(q, k, v, causal, window, scale)
    return _b5_launch(q, k, v, causal, window, scale)


def _b5_launch(q, k, v, causal, window, scale) -> torch.Tensor:
    """B5 on the card: the eager path and the op's CUDA implementation."""
    b, sq, h, dh, skv, kvh = _shapes(q, k, v)
    _require("B5", q, k, v, dtypes=(torch.float32, torch.bfloat16))
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"kernel B5 takes q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    if 0 in (b, sq, h, dh, skv):
        return out.zero_()
    _build.launch("flash_attention", _ARGTYPES["flash_attention"], q.device,
                  f"B={b} Sq={sq} Skv={skv} H={h} Kv={kvh} dh={dh}",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, skv, h, kvh, dh, int(causal),
                  int(window is not None), window or 0, scale,
                  int(q.dtype == torch.bfloat16), reads=(q, k, v),
                  writes=(out,))
    LAUNCHES["flash_attention"] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _b5_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], scale: Optional[float]) -> torch.Tensor:
    return flash_attention_kernel_plain(q, k, v, causal, window, scale)


_b5_op.register_kernel("cuda")(_b5_launch)
_b5_op.register_fake(lambda q, k, v, *args: v.new_empty(q.shape))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _b5_flops(q_shape, k_shape, v_shape, causal, window, scale, *,
              out_val=None, **_):
    b, sq, h, dh = q_shape
    ops, _ = flash_cost(b, sq, k_shape[1], h, k_shape[2], dh, causal, window,
                        out_val.dtype if out_val is not None
                        else torch.float32)
    return sum(ops.values())


# ----------------------------------------------------- B4: level-walk QK^T
def l2r_operands(q, k, n_bits: int = 8, log2_radix: int = 2):
    """The host-side work around kernel B4, as the reference does it:
    per-vector quantization of q and k, then pre-shifted plane stacks,
    ascending for q (B, Sq, H, D*dh) and descending for k
    (B, Skv, Kv, D*dh).  Returns (q_stack, q_scale, k_stack, k_scale), the
    scales (..., 1) f32."""
    cfg = QuantConfig(n_bits=n_bits, log2_radix=log2_radix)
    qq, qs = quantize_per_vector(q, cfg)
    kq, ks = quantize_per_vector(k, cfg)
    return (stack_planes_lhs(qq, n_bits, log2_radix), qs,
            stack_planes_rhs(kq, n_bits, log2_radix, axis=-1), ks)


def l2r_score_tile(q_stack, k_stack, n_bits: int = 8, log2_radix: int = 2,
                   levels: int | None = None) -> torch.Tensor:
    """The int32 score tile of the level walk: q_stack (..., Q, D*dh)
    ascending and k_stack (..., S, D*dh) descending pre-shifted stacks ->
    (..., Q, S), every level one contraction over a contiguous slice pair
    (``msdf_level_slices``, truncated by ``levels``).  The dots run in f64,
    exact for integers below 2^53 on any device, and wrap to int32 as the
    reference's int32 accumulator does."""
    d = plane_count(n_bits, log2_radix)
    dh = q_stack.shape[-1] // d
    acc = torch.zeros(torch.broadcast_shapes(q_stack.shape[:-2],
                                             k_stack.shape[:-2])
                      + (q_stack.shape[-2], k_stack.shape[-2]),
                      dtype=torch.float64, device=q_stack.device)
    for (s, i_lo, i_hi) in msdf_level_slices(d, levels):
        a_l = q_stack[..., i_lo * dh:(i_hi + 1) * dh].to(torch.float64)
        r0 = (d - 1 - s + i_lo) * dh
        b_l = k_stack[..., r0:r0 + (i_hi - i_lo + 1) * dh].to(torch.float64)
        acc += torch.matmul(a_l, b_l.transpose(-1, -2))
    return wrap_int32(acc.to(torch.int64))


def flash_attention_l2r_plain(q, k, v, n_bits: int = 8, log2_radix: int = 2,
                              levels: int | None = None, causal: bool = True,
                              window: int | None = None,
                              scale: float | None = None,
                              bkv: int = KV_TILE) -> torch.Tensor:
    """Plain version of kernel B4: :func:`l2r_operands`, then the
    reference kernel's online softmax over blocks of ``bkv`` keys with
    each score ``s_int * q_scale * k_scale * scale`` (f32, that order)."""
    _shapes(q, k, v)
    return _l2r_plain_walk(*l2r_operands(q, k, n_bits, log2_radix), v,
                           n_bits, log2_radix, levels, causal, window, scale,
                           bkv)


def _l2r_plain_walk(q_stack, qs, k_stack, ks, v, n_bits, log2_radix, levels,
                    causal, window, scale, bkv=KV_TILE) -> torch.Tensor:
    b, skv, kvh, dh = v.shape
    sq, h = q_stack.shape[1], q_stack.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qst, qsc = _gqa_rows(q_stack, kvh), _gqa_rows(qs, kvh)
    kst = _gqa_keys(k_stack)
    ksc = _gqa_keys(ks).transpose(-1, -2)  # (B, Kv, 1, 1, Skv)

    def scores(lo, hi):
        s_int = l2r_score_tile(qst, kst[:, :, :, lo:hi], n_bits, log2_radix,
                               levels)
        return s_int.to(torch.float32) * qsc * ksc[..., lo:hi] * scale

    with no_tf32():
        return _online_softmax_plain(scores, v, sq, h, causal, window,
                                     min(bkv, skv))


def l2r_masks(n_bits: int, log2_radix: int, levels: int | None
              ) -> list[tuple[int, int]]:
    """Kernel B4's walk: per product of ``msdf_products(D, levels)`` the
    masks (q's, k's) that cut its plane ranges out of the raw int8 (int16
    for n_bits > 8) operands (``plane_bits``); full depth is one product,
    all ones."""
    d = plane_count(n_bits, log2_radix)
    bits = 8 if n_bits <= 8 else 16
    return [(plane_bits(d, log2_radix, il, ih, bits),
             plane_bits(d, log2_radix, jl, jh, bits))
            for il, ih, jl, jh in msdf_products(d, levels)]


def l2r_byte_split_scores(qq, kq, n_bits: int = 16, log2_radix: int = 4,
                          levels: int | None = None) -> torch.Tensor:
    """The int32 score tile of the walk over raw int16 codes as kernel B4's
    wide route computes it on the int8 tensor cores: qq (..., Q, dh) and kq
    (..., S, dh) int16 -> (..., Q, S) int32, the byte split of each product
    of :func:`l2r_masks` (``kernels/l2r_gemm/kernel.py:byte_split_matmul``,
    one fold: a head is far below the 32,896 elements at which a byte
    accumulator could leave int32)."""
    return byte_split_matmul(qq, kq.transpose(-1, -2),
                             l2r_masks(n_bits, log2_radix, levels), fold=None)


def l2r_wide(dh: int, n_bits: int = 8) -> bool:
    """Does B4 take its wide route: int16 q and k (n_bits > 8), or a head
    wider than the base route's 128."""
    return n_bits > 8 or dh > 128


def l2r_width(dh: int, n_bits: int = 8) -> int:
    """The head width kernel B4 reads: on its base route dh zero-padded to
    32, 64 or 128 (whole k32 steps of the int8 mma); on its wide route
    (:func:`l2r_wide`) dh itself (the kernel zero-fills shared memory)."""
    if l2r_wide(dh, n_bits):
        return dh
    return max(32, 1 << (dh - 1).bit_length())


def l2r_kernel_operands(q, k, v, n_bits: int = 8, log2_radix: int = 2):
    """What kernel B4 reads, made on the card: q and k quantized per vector
    (``quantize_per_vector``) as raw int8 (int16 for n_bits > 8) with their
    f32 scales, and on the base route the three zero-padded to
    :func:`l2r_width` when dh is not 32, 64 or 128 (exact: zero columns add
    nothing to a score, and the padded output columns are not written).
    Returns (qq, q_scale, kq, k_scale, v), each contiguous.  No plane
    stack: the kernel masks the planes out of the raw operands
    (:func:`l2r_masks`)."""
    cfg = QuantConfig(n_bits=n_bits, log2_radix=log2_radix)
    qq, qs = quantize_per_vector(q, cfg)
    kq, ks = quantize_per_vector(k, cfg)
    dh = q.shape[-1]
    width = l2r_width(dh, n_bits)
    if width != dh:
        qq, kq, v = (torch.nn.functional.pad(x, (0, width - dh))
                     for x in (qq, kq, v))
    return tuple(x.contiguous() for x in (qq, qs, kq, ks, v))


def flash_attention_l2r_launch(ops, dh: int, n_bits: int = 8,
                               log2_radix: int = 2,
                               levels: int | None = None,
                               causal: bool = True,
                               window: int | None = None,
                               scale: float | None = None) -> torch.Tensor:
    """One launch of kernel B4 on :func:`l2r_kernel_operands` ``ops`` of
    a head width ``dh`` -> (B, Sq, H, dh) in v's dtype."""
    qq, qs, kq, ks, v = ops
    b, sq, h, width = qq.shape
    _, skv, kvh, _ = kq.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((b, sq, h, dh), dtype=v.dtype, device=v.device)
    if 0 in (b, sq, h, dh, skv):
        return out.zero_()
    masks = l2r_masks(n_bits, log2_radix, levels)
    arr = ctypes.c_int * max(len(masks), 1)
    what = f"B={b} Sq={sq} Skv={skv} H={h} Kv={kvh} dh={dh} levels={levels}"
    common = (qq.data_ptr(), qs.data_ptr(), kq.data_ptr(), ks.data_ptr(),
              v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh, dh)
    tail = (int(causal), int(window is not None), window or 0, scale,
            len(masks), arr(*(ma for ma, _ in masks)),
            arr(*(mb for _, mb in masks)), int(v.dtype == torch.bfloat16))
    if l2r_wide(dh, n_bits):
        if qq.dtype != _int_dtype(n_bits) or width != dh:
            raise ValueError(f"kernel B4's wide route takes unpadded "
                             f"{_int_dtype(n_bits)} q, k; got {qq.dtype} "
                             f"of width {width} for dh={dh}")
        _build.launch("flash_attention_l2r",
                      _ARGTYPES["flash_attention_l2r_wide"], v.device, what,
                      *common, *tail, qq.element_size(),
                      reads=(qq, qs, kq, ks, v), writes=(out,),
                      entry="flash_attention_l2r_wide")
    else:
        _build.launch("flash_attention_l2r", _ARGTYPES["flash_attention_l2r"],
                      v.device, what, *common[:12], width, *tail,
                      reads=(qq, qs, kq, ks, v), writes=(out,))
    LAUNCHES["flash_attention_l2r"] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention_l2r", mutates_args=())
def _b4_op(qq: torch.Tensor, qs: torch.Tensor, kq: torch.Tensor,
           ks: torch.Tensor, v: torch.Tensor, dh: int, n_bits: int,
           log2_radix: int, levels: Optional[int], causal: bool,
           window: Optional[int], scale: Optional[float]) -> torch.Tensor:
    # the plain walk on the codes the kernel reads (its zero padding cut)
    qq, kq, v = qq[..., :dh], kq[..., :dh], v[..., :dh]
    return _l2r_plain_walk(
        stack_planes_lhs(qq, n_bits, log2_radix), qs,
        stack_planes_rhs(kq, n_bits, log2_radix, axis=-1), ks, v, n_bits,
        log2_radix, levels, causal, window, scale)


@_b4_op.register_kernel("cuda")
def _(qq, qs, kq, ks, v, dh, n_bits, log2_radix, levels, causal, window,
      scale):
    return flash_attention_l2r_launch((qq, qs, kq, ks, v), dh, n_bits,
                                      log2_radix, levels, causal, window,
                                      scale)


@_b4_op.register_fake
def _(qq, qs, kq, ks, v, dh, *args):
    return v.new_empty((*qq.shape[:3], dh))


@register_flop_formula(torch.ops.repro_torch.flash_attention_l2r)
def _b4_flops(qq_shape, qs_shape, kq_shape, ks_shape, v_shape, dh, n_bits,
              log2_radix, levels, causal, window, scale, *, out_val=None,
              **_):
    b, sq, h, _ = qq_shape
    ops, _ = flash_cost(b, sq, kq_shape[1], h, kq_shape[2], dh, causal,
                        window, out_val.dtype if out_val is not None
                        else torch.float32, qk_int8=True,
                        qk_int16=n_bits > 8)
    return sum(ops.values())


def flash_attention_l2r(q, k, v, n_bits: int = 8, log2_radix: int = 2,
                        levels: int | None = None, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Flash attention whose QK^T is the digit-serial level walk: kernel
    B4.  Same layouts as :func:`flash_attention_kernel`; q and k are
    quantized per vector here and go to the kernel as raw int8 with
    their scales (:func:`l2r_kernel_operands`); v and the softmax stay
    float, ``levels`` truncates the MSDF walk.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel: v f32 or bf16, any dh; int8 q, k up to dh 128 on its base
    route, int16 (n_bits 9-16) and wider heads on its wide route (QK^T on
    the tensor cores in both).
    """
    b, sq, h, dh, skv, kvh = _shapes(q, k, v)
    if _build.as_op(q):
        return torch.ops.repro_torch.flash_attention_l2r(
            *l2r_kernel_operands(q, k, v, n_bits, log2_radix), dh, n_bits,
            log2_radix, levels, causal, window, scale)
    if not q.is_cuda:
        return flash_attention_l2r_plain(q, k, v, n_bits, log2_radix, levels,
                                         causal, window, scale)
    if q.device != v.device or k.device != v.device:
        raise ValueError(f"kernel B4 takes q, k, v on one card, got "
                         f"{q.device}, {k.device}, {v.device}")
    _require("B4", v, dtypes=(torch.float32, torch.bfloat16))
    return flash_attention_l2r_launch(
        l2r_kernel_operands(q, k, v, n_bits, log2_radix), dh, n_bits,
        log2_radix, levels, causal, window, scale)


# ------------------------------------------------------------- autograd
def plain_grads(plain, saved, needs, grad_out) -> tuple:
    """The backward of a kernel with no backward of its own: ``plain(q, k,
    v)`` recomputed from the saved inputs under autograd (TF32 off), and
    its ``torch.autograd.grad`` for each input whose ``needs`` is set
    (None for the others, and for an input the function does not use)."""
    with torch.enable_grad(), no_tf32():
        xs = [x.detach().requires_grad_(n) for x, n in zip(saved, needs)]
        want = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(plain(*xs), want, grad_out,
                                         allow_unused=True) if want else ())
    return tuple(next(grads) if n else None for n in needs)


class FlashAttentionL2R(torch.autograd.Function):
    """Kernel B4 with a gradient: the forward is :func:`flash_attention_l2r`
    (one launch on a CUDA tensor), the backward the gradient of
    ``plain(q, k, v)``, which the caller makes compute the same function.
    The rounding of q and k to int8 has no gradient, so q and k receive
    theirs through the per-vector scales alone, as under ``jax.grad``."""

    @staticmethod
    def forward(ctx, q, k, v, n_bits, log2_radix, levels, causal, window,
                scale, plain):
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return flash_attention_l2r(q, k, v, n_bits, log2_radix, levels,
                                   causal, window, scale)

    @staticmethod
    def backward(ctx, grad_out):
        return (*plain_grads(ctx.plain, ctx.saved_tensors,
                             ctx.needs_input_grad[:3], grad_out),
                *(None,) * 7)
