"""Quantization and digit-plane decomposition for L2R arithmetic.

The port of ``repro/core/quant.py``.  An n-bit integer tensor splits into
D = n / log2(radix) planes of small digits such that

    x = sum_i plane[i] * radix**i            (exact, two's complement)

Low planes hold unsigned digits in [0, radix); the **top plane is signed**
(arithmetic shift) so the reconstruction is exact for negative values.

The formulas and their order are the reference's, so the same float input
gives the same integers (``torch.round`` and ``jnp.round`` both round half
to even).  A weight cache built under a mesh (``quantize_weights(...,
shard=, mesh=)``) holds only this rank's slice of the output channels and
records where it lies (:class:`ColumnShard`).  A tensor-parallel
backbone (sharding/axes.py:shard_params) also cuts caches by their
contraction rows (:func:`shard_weights`, :class:`RowShard`): the rank's
K-slice of ``q`` and of the plane stack, with the whole column's scales.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.analysis.overflow import check_or_raise
from repro_torch.sharding.ctx import mesh_axis_size, safe_axes

__all__ = [
    "QuantConfig",
    "QuantizedWeights",
    "PlaneOperands",
    "ColumnShard",
    "RowShard",
    "shard_weights",
    "quantize",
    "quantize_weights",
    "dequantize",
    "digit_planes",
    "from_digit_planes",
    "shifted_planes",
    "stack_planes_lhs",
    "stack_planes_rhs",
    "plane_count",
    "max_digit",
]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration of the L2R digit-plane arithmetic.

    Attributes:
      n_bits:      operand precision (the paper evaluates n = 8).
      log2_radix:  bits per digit; 1 -> bit-serial (paper's datapath),
                   2 -> radix-4 (default), 4 -> radix-16.
      per_channel: quantize scales per output channel (axis -1) instead of
                   per tensor.
    """

    n_bits: int = 8
    log2_radix: int = 2
    per_channel: bool = True

    def __post_init__(self):
        if self.n_bits % self.log2_radix:
            raise ValueError(
                f"n_bits={self.n_bits} must be divisible by "
                f"log2_radix={self.log2_radix}"
            )

    @property
    def planes(self) -> int:
        return self.n_bits // self.log2_radix

    @property
    def radix(self) -> int:
        return 1 << self.log2_radix

    @property
    def qmax(self) -> int:
        return (1 << (self.n_bits - 1)) - 1

    @property
    def qmin(self) -> int:
        return -(1 << (self.n_bits - 1))


def plane_count(n_bits: int, log2_radix: int) -> int:
    return n_bits // log2_radix


def max_digit(log2_radix: int) -> int:
    return (1 << log2_radix) - 1


def _int_dtype(n_bits: int) -> torch.dtype:
    return torch.int8 if n_bits <= 8 else torch.int16


def _symmetric_quant(xf: torch.Tensor, amax: torch.Tensor, cfg: QuantConfig):
    """Shared scale/round/clip core: the ONE place the quantization
    formula lives, so load-time weight caches (quantize_weights) stay
    bit-identical to on-the-fly quantization (quantize).

    The scale is ``amax * f32(1/qmax)``: XLA folds the reference's
    ``/ qmax`` into that multiply, and the port computes what the
    reference computes."""
    inv_qmax = torch.tensor(1.0 / cfg.qmax, dtype=torch.float32)
    scale = torch.clamp(amax, min=1e-30) * inv_qmax.to(amax.device)
    q = torch.clamp(torch.round(xf / scale), cfg.qmin, cfg.qmax)
    return q.to(_int_dtype(cfg.n_bits)), scale


def _amax(xf: torch.Tensor, keep: set[int]) -> torch.Tensor:
    reduce_dims = tuple(a for a in range(xf.ndim) if a not in keep)
    return torch.amax(xf.abs(), dim=reduce_dims, keepdim=True)


def quantize(x: torch.Tensor, cfg: QuantConfig = QuantConfig(),
             axis: int | None = None):
    """Symmetric quantization to n-bit signed integers.

    Returns (q, scale) with x ~= q * scale.  ``axis`` selects the axis
    kept for the scale; ``None`` uses cfg.per_channel (scale per trailing
    axis) or per-tensor.
    """
    xf = x.to(torch.float32)
    if axis is None and cfg.per_channel and x.ndim >= 2:
        amax = _amax(xf, {x.ndim - 1})
    elif axis is not None:
        amax = _amax(xf, {axis % x.ndim})
    else:
        amax = xf.abs().amax()
    return _symmetric_quant(xf, amax, cfg)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def digit_planes(x: torch.Tensor, n_bits: int = 8,
                 log2_radix: int = 2) -> torch.Tensor:
    """Decompose signed integers into digit planes, **least significant
    plane first**: (D, *x.shape) int8, low planes unsigned in
    [0, radix), the top plane the (signed) arithmetic shift."""
    d = plane_count(n_bits, log2_radix)
    r_mask = (1 << log2_radix) - 1
    xi = x.to(torch.int32)
    planes = [(xi >> (log2_radix * i)) & r_mask for i in range(d - 1)]
    planes.append(xi >> (log2_radix * (d - 1)))  # arithmetic shift: signed top
    return torch.stack(planes).to(torch.int8)


def from_digit_planes(planes: torch.Tensor, log2_radix: int = 2
                      ) -> torch.Tensor:
    """Exact inverse of :func:`digit_planes` (returns int32)."""
    acc = torch.zeros(planes.shape[1:], dtype=torch.int32,
                      device=planes.device)
    for i in range(planes.shape[0]):
        acc = acc + (planes[i].to(torch.int32) << (log2_radix * i))
    return acc


def _shifted_plane(x: torch.Tensor, i: int, n_bits: int, log2_radix: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Pre-shifted plane ``i`` of ``x`` (already in the operand dtype):
    a bit-field of x, so it is computed in that dtype with no upcast."""
    d = plane_count(n_bits, log2_radix)
    if i < d - 1:
        mask = ((1 << log2_radix) - 1) << (log2_radix * i)
        return torch.bitwise_and(x, mask, out=out)
    # signed top bit-field: clear the low bits, keep the sign extension
    return torch.sub(x, x & ((1 << (log2_radix * (d - 1))) - 1), out=out)


def shifted_planes(x: torch.Tensor, n_bits: int = 8,
                   log2_radix: int = 2) -> torch.Tensor:
    """Digit planes pre-shifted to their significance:
    ``out[i] = plane_i << b*i``, each a bit-field of ``x`` (the top one
    sign-extended), in the operand's own n-bit dtype; ``sum_i out[i] == x``.
    """
    x = x.to(_int_dtype(n_bits))
    return torch.stack([_shifted_plane(x, i, n_bits, log2_radix)
                        for i in range(plane_count(n_bits, log2_radix))])


def _stack_shifted(x: torch.Tensor, n_bits: int, log2_radix: int, axis: int,
                   descending: bool) -> torch.Tensor:
    """Pre-shifted planes written straight into their blocks of the stack
    along ``axis`` (no per-plane tensors, no concatenation)."""
    d = plane_count(n_bits, log2_radix)
    x = x.to(_int_dtype(n_bits))
    k = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = d * k
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for i in range(d):
        blk = d - 1 - i if descending else i
        _shifted_plane(x, i, n_bits, log2_radix,
                       out=out.narrow(axis, blk * k, k))
    return out


def stack_planes_lhs(xq: torch.Tensor, n_bits: int = 8, log2_radix: int = 2,
                     shifted: bool = True) -> torch.Tensor:
    """LHS plane stack: (..., M, K) -> (..., M, D*K), plane i at columns
    ``[i*K, (i+1)*K)`` (ascending significance).  ``shifted`` picks
    pre-shifted bit-fields (the kernel's operand format) or raw digits
    (the guarded f32 format)."""
    if shifted:
        return _stack_shifted(xq, n_bits, log2_radix, xq.ndim - 1, False)
    return torch.cat(list(digit_planes(xq, n_bits, log2_radix)), dim=-1)


def stack_planes_rhs(wq: torch.Tensor, n_bits: int = 8, log2_radix: int = 2,
                     axis: int = 0, shifted: bool = True) -> torch.Tensor:
    """RHS plane stack: (K, N) -> (D*K, N), plane j at rows
    ``[(D-1-j)*K, (D-j)*K)`` (descending significance), so every level
    pairs a contiguous LHS column slice with a contiguous RHS row slice
    (online.py:msdf_level_slices).  ``axis`` is the contraction axis
    (conv weights (kh, kw, cin, cout) stack cin, axis=-2)."""
    if shifted:
        return _stack_shifted(wq, n_bits, log2_radix, axis % wq.ndim, True)
    sp = digit_planes(wq, n_bits, log2_radix)
    return torch.cat(list(sp)[::-1], dim=axis % wq.ndim)


def _pad_blocks(st: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``st`` with ``n`` zero elements appended along ``axis``."""
    if n <= 0:
        return st
    shape = list(st.shape)
    shape[axis] = n
    return torch.cat([st, st.new_zeros(shape)], dim=axis)


class ColumnShard(NamedTuple):
    """Where a sharded weight cache's output channels (its last dim) lie:
    this rank holds columns ``[offset, offset + n_local)`` of
    ``n_total``, split over the mesh axis ``axis`` (a name or a tuple of
    names)."""

    mesh: Any
    axis: Any
    n_total: int
    offset: int


class RowShard(NamedTuple):
    """Where a row-split weight cache's contraction rows lie: this rank
    holds rows ``[offset, offset + k_local)`` of ``k_total`` of every
    output channel, split over the mesh axis ``axis``; its scales are the
    whole columns' (a row-parallel product sums the ranks' integer
    partials before it dequantizes)."""

    mesh: Any
    axis: Any
    k_total: int
    offset: int


@dataclasses.dataclass(frozen=True)
class PlaneOperands:
    """A digit-plane stack as a first-class operand.

    Fields:
      stack:   the stack tensor.
      side:    "lhs" (ascending planes on the last axis) or "rhs"
               (descending planes on the contraction axis).
      k:       the un-stacked contraction length (stack axis is D*k).
      axis:    the stacking axis, counted FROM THE END (negative).
      shifted: True -> pre-shifted bit-field planes (the kernel's operand
               format); False -> raw digits in [0, radix).
      pad_planes: trailing zero plane blocks after the D real planes (the
               streaming walk reads fixed-width windows of a (2D-1)-block
               stack; ``window_pad=True`` caches carry the zeros).
      shard:   a :class:`ColumnShard` when the stack holds one rank's
               slice of the output channels (None: all of them).

    The two layouts convert exactly in both directions
    (:meth:`with_layout`), so every consumer accepts either.
    """

    stack: torch.Tensor
    side: str
    n_bits: int
    log2_radix: int
    k: int
    axis: int
    shifted: bool
    pad_planes: int = 0
    shard: ColumnShard | None = None

    @property
    def d(self) -> int:
        return plane_count(self.n_bits, self.log2_radix)

    @classmethod
    def prepare_lhs(cls, aq: torch.Tensor, n_bits: int = 8,
                    log2_radix: int = 2, shifted: bool = False,
                    window_pad: bool = False) -> "PlaneOperands":
        """Stack LHS planes once: (..., M, K) -> (..., M, D*K) operand
        (plus D-1 zero blocks with ``window_pad``)."""
        st = stack_planes_lhs(aq, n_bits, log2_radix, shifted=shifted)
        k = aq.shape[-1]
        pad = plane_count(n_bits, log2_radix) - 1 if window_pad else 0
        st = _pad_blocks(st, st.ndim - 1, pad * k)
        return cls(st, "lhs", n_bits, log2_radix, k, -1, shifted, pad)

    @classmethod
    def prepare_rhs(cls, wq: torch.Tensor, n_bits: int = 8,
                    log2_radix: int = 2, axis: int = 0,
                    shifted: bool = False,
                    window_pad: bool = False,
                    k_major: bool = False) -> "PlaneOperands":
        """Stack RHS planes once: contraction ``axis`` grows to D*K
        (plus D-1 zero blocks with ``window_pad``).  ``k_major`` keeps
        the same tensor with the contraction axis innermost in memory
        (kernel B1 reads each output channel's D*K bytes contiguously);
        the values and the shape are unchanged."""
        ax = axis if axis < 0 else axis - wq.ndim
        st = stack_planes_rhs(wq, n_bits, log2_radix, axis=ax,
                              shifted=shifted)
        k = wq.shape[ax]
        pad = plane_count(n_bits, log2_radix) - 1 if window_pad else 0
        st = _pad_blocks(st, ax % st.ndim, pad * k)
        if k_major:
            st = st.movedim(ax, -1).contiguous().movedim(-1, ax)
        return cls(st, "rhs", n_bits, log2_radix, k, ax, shifted, pad)

    def describe(self) -> str:
        """One-line layout summary for mismatch errors."""
        return (f"PlaneOperands(side={self.side!r}, n_bits={self.n_bits}, "
                f"log2_radix={self.log2_radix}, k={self.k}, "
                f"axis={self.axis}, shifted={self.shifted}, "
                f"pad_planes={self.pad_planes}, "
                f"stack.shape={tuple(self.stack.shape)})")

    def matches(self, n_bits: int, log2_radix: int, ndim: int | None = None,
                side: str | None = None,
                contract_axis: int | None = None) -> bool:
        """Is this stack usable for a call with the given digit config
        (and optionally rank / side / contraction-axis position)?"""
        if (self.n_bits, self.log2_radix) != (n_bits, log2_radix):
            return False
        if ndim is not None and self.stack.ndim != ndim:
            return False
        if side is not None and self.side != side:
            return False
        if contract_axis is not None \
                and self.axis % self.stack.ndim != contract_axis:
            return False
        return True

    def with_layout(self, shifted: bool) -> "PlaneOperands":
        """Exact raw-digit <-> pre-shifted conversion (chunk-wise shifts;
        zero pad blocks are unaffected)."""
        if shifted == self.shifted:
            return self
        ax = self.axis % self.stack.ndim
        n_chunks = self.d + self.pad_planes
        shp = self.stack.shape
        r = self.stack.reshape(*shp[:ax], n_chunks, self.k, *shp[ax + 1:])
        if self.side == "lhs":
            amt = [self.log2_radix * i if i < self.d else 0
                   for i in range(n_chunks)]
        else:
            amt = [self.log2_radix * (self.d - 1 - i) if i < self.d else 0
                   for i in range(n_chunks)]
        # raw low digits are non-negative and the top chunk is a sign-
        # extended bit-field, so arithmetic shifts are exact both ways;
        # cast BEFORE the left shift so high-significance chunks don't wrap
        if shifted:
            r = r.to(_int_dtype(self.n_bits))
        sh = torch.tensor(amt, dtype=r.dtype, device=r.device).reshape(
            (1,) * ax + (n_chunks,) + (1,) * (r.ndim - ax - 1))
        out = (r << sh) if shifted else (r >> sh).to(torch.int8)
        return dataclasses.replace(self, stack=out.reshape(shp),
                                   shifted=shifted)

    def core_stack(self, shifted: bool) -> torch.Tensor:
        """The D-plane stack (window padding sliced off) in the requested
        layout: the stacked-schedule operand."""
        st = self.with_layout(shifted).stack
        if self.pad_planes == 0:
            return st
        return st.narrow(self.axis % st.ndim, 0, self.d * self.k)

    def window_stack(self) -> torch.Tensor:
        """Raw-digit stack zero-padded to the fixed (2D-1)-block streaming
        window: the plain streaming walk's operand (core/progressive.py)."""
        st = self.with_layout(False).stack
        return _pad_blocks(st, self.axis % st.ndim,
                           (self.d - 1 - self.pad_planes) * self.k)


@dataclasses.dataclass
class QuantizedWeights:
    """Pre-quantized matmul/conv weights, built ONCE at model load.

    ``q`` keeps the weight's natural shape ((K, N) dense, (kh, kw, cin,
    cout) conv); ``scale`` broadcasts against the output channels;
    ``planes`` optionally caches the reversed RHS plane stack.  ``shard``
    is set when all three hold one rank's slice of the output channels
    (:class:`ColumnShard`), or of the contraction rows (:class:`RowShard`,
    with the whole columns' scales).
    """

    q: torch.Tensor
    scale: torch.Tensor
    planes: PlaneOperands | None = None
    shard: ColumnShard | RowShard | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def stream_operand(self, n_bits: int, log2_radix: int):
        """The right operand a (K, N) streaming walk reads: the cached
        plane stack where it matches the digit config, else ``q``.  A
        sharded cache must offer its stack, which carries the shard (its
        ``q`` alone would pass for a whole weight)."""
        p = self.planes
        if p is not None and p.matches(n_bits, log2_radix, ndim=2,
                                       side="rhs"):
            return p
        if self.shard is not None:
            raise ValueError(
                f"a sharded weight cache (columns [{self.shard.offset}, "
                f"{self.shard.offset + self.q.shape[-1]}) of "
                f"{self.shard.n_total}) streams through its plane stack: "
                f"build it with prestack=True for n_bits={n_bits}, "
                f"log2_radix={log2_radix}")
        return self.q


def quantize_weights(
    w: torch.Tensor,
    cfg: QuantConfig = QuantConfig(),
    channel_axes: tuple[int, ...] = (-1,),
    prestack: bool = False,
    plane_axis: int | None = None,
    window_pad: bool = False,
    plane_shifted: bool = False,
    k_major: bool = False,
    shard: tuple | None = None,
    mesh=None,
) -> QuantizedWeights:
    """Symmetric per-channel weight quantization -> :class:`QuantizedWeights`.

    ``channel_axes`` KEEP independent scales (default: the trailing
    output-channel axis).  ``prestack=True`` also caches the reversed RHS
    plane stack along ``plane_axis`` (default 0; conv weights pass -2) in
    the layout ``plane_shifted`` picks — True is the kernel's own operand
    format, so the conversion happens once here instead of per call.
    ``window_pad`` appends the D-1 zero plane blocks of the plain
    streaming window to that cache.  ``k_major`` lays the cache out with
    its contraction axis innermost in memory, the layout kernel B1 reads
    (made here, once, not per forward).

    ``shard`` + ``mesh`` keep only this rank's slice of the cache: a
    spec over the raw weight's dims that may name a mesh axis for the
    last dim only (``(None, "model")``: an LM head's vocab shard).  Where
    that axis divides the output channels, ``q``, ``scale`` and the plane
    stack hold this rank's contiguous slice of them (the stack a K-major
    copy with ``k_major``), equal to the matching columns of the whole
    cache, and ``shard`` records the slice (:class:`ColumnShard`); an
    axis that does not divide them leaves the cache whole, as the
    reference replicates it.
    """
    wf = w.to(torch.float32)
    q, scale = _symmetric_quant(
        wf, _amax(wf, {a % w.ndim for a in channel_axes}), cfg)
    col = None
    if shard is not None and mesh is not None:
        q, scale, col = _column_slice(q, scale, tuple(shard), mesh)
    planes = None
    if prestack:
        axis = 0 if plane_axis is None else plane_axis
        check_or_raise(cfg.n_bits, cfg.log2_radix, int(w.shape[axis]),
                       where="quantize_weights")
        planes = PlaneOperands.prepare_rhs(q, cfg.n_bits, cfg.log2_radix,
                                           axis=axis, shifted=plane_shifted,
                                           window_pad=window_pad,
                                           k_major=k_major)
        planes = dataclasses.replace(planes, shard=col)
    return QuantizedWeights(q, scale, planes, col)


def _column_slice(q: torch.Tensor, scale: torch.Tensor, shard: tuple, mesh):
    """This rank's slice of the output channels of (q, scale) under the
    spec ``shard``, and its :class:`ColumnShard` (None: whole)."""
    axes = safe_axes(mesh, tuple(q.shape), shard)
    if any(a is not None for a in axes[:-1]):
        raise ValueError(f"quantize_weights: shard={shard!r} splits a dim "
                         f"other than the output channels; only the last "
                         f"dim of a weight cache is sharded")
    ax = axes[-1]
    if ax is None or mesh_axis_size(mesh, ax) == 1:
        return q, scale, None
    n = q.shape[-1]
    n_l = n // mesh_axis_size(mesh, ax)
    off = mesh.index(ax) * n_l
    # a per-tensor scale (last dim 1) is every slice's
    sc = scale[..., off:off + n_l].contiguous() if scale.shape[-1] == n \
        else scale
    return (q[..., off:off + n_l].contiguous(), sc,
            ColumnShard(mesh, ax, n, off))


def _k_major_copy(st: torch.Tensor, axis: int) -> torch.Tensor:
    """A compact copy of ``st`` with its dim ``axis`` innermost in memory
    (a cut K-major stack keeps its layout and frees the whole one)."""
    return st.movedim(axis, -1).contiguous().movedim(-1, axis)


def shard_weights(w: QuantizedWeights, spec: tuple, mesh,
                  k_dim: int) -> QuantizedWeights:
    """This rank's slice of the weight cache ``w`` under the partition
    spec ``spec`` over ``q``'s dims (copies), ``k_dim`` its contraction
    dim.  One dim may be split: the output channels (the last dim: the
    slice of ``q``, ``scale`` and the plane stack's columns, a
    :class:`ColumnShard`, exactly as ``quantize_weights(shard=)`` cuts a
    head) or the contraction rows (``k_dim``: the K-slice of ``q`` and of
    every plane block of the stack, the whole columns' ``scale``, a
    :class:`RowShard`).  A spec the mesh does not divide leaves ``w``
    whole."""
    axes = safe_axes(mesh, tuple(w.q.shape), tuple(spec))
    split = [i for i, a in enumerate(axes)
             if a is not None and mesh_axis_size(mesh, a) > 1]
    if not split:
        return w
    if len(split) > 1 or split[0] not in (w.q.ndim - 1, k_dim % w.q.ndim):
        raise ValueError(f"shard_weights: spec {tuple(spec)!r} splits dims "
                         f"{split} of a {tuple(w.q.shape)} cache; only its "
                         f"output channels or its contraction rows split")
    dim = split[0]
    ax = axes[dim]
    n = w.q.shape[dim]
    n_l = n // mesh_axis_size(mesh, ax)
    off = mesh.index(ax) * n_l
    p = w.planes
    if dim == w.q.ndim - 1:
        sc = w.scale.narrow(-1, off, n_l).contiguous() \
            if w.scale.shape[-1] == n else w.scale
        rec = ColumnShard(mesh, ax, n, off)
        if p is not None:
            p = dataclasses.replace(p, shard=rec, stack=_k_major_copy(
                p.stack.narrow(-1, off, n_l), p.axis % p.stack.ndim))
        return QuantizedWeights(w.q.narrow(-1, off, n_l).contiguous(), sc,
                                p, rec)
    rec = RowShard(mesh, ax, n, off)
    if p is not None:
        ax_p = p.axis % p.stack.ndim
        shp = p.stack.shape
        blocks = p.stack.reshape(*shp[:ax_p], p.d + p.pad_planes, p.k,
                                 *shp[ax_p + 1:])
        cut = blocks.narrow(ax_p + 1, off, n_l).reshape(
            *shp[:ax_p], (p.d + p.pad_planes) * n_l, *shp[ax_p + 1:])
        p = dataclasses.replace(p, k=n_l, stack=_k_major_copy(cut, ax_p))
    return QuantizedWeights(w.q.narrow(dim, off, n_l).contiguous(), w.scale,
                            p, rec)
