"""Parameter descriptors, initialization, norms and the dense primitive.

The port of ``repro/models/common.py``.  Models are pairs of functions:

    build(cfg)  -> tree of Param descriptors (shape/dtype/logical axes)
    apply(cfg, params, ...) -> activations

Trees are nested dicts and lists with the reference's keys.
:func:`materialize` draws real tensors from an explicit
``torch.Generator``: the port cannot reproduce ``jax.random``, so a test
that compares the two packages builds its params in JAX and carries them
across by value (models/convert.py:lm_params_from_jax).

Every matmul of the LM stack goes through :func:`dense`, which runs the
paper's L2R digit-plane pipeline (kernel B1 on the card) when the config
carries a QuantConfig, and serves the reference's ``{"q", "scale"}``
int8 record (:func:`quantize_desc`/:func:`quantize_params`, the int8
checkpoint codec of checkpoint/quantized.py) as W8A8 integer dense.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.l2r_gemm import l2r_dense
from repro_torch.core.quant import (QuantConfig, QuantizedWeights, quantize,
                                    quantize_weights)
from repro_torch.device import card_path, resolve_device
from repro_torch.kernels.l2r_gemm.ops import l2r_gemm, l2r_matmul_f
from repro_torch.sharding import ctx
from repro_torch.sharding.axes import P
from repro_torch.sharding.collectives import (gather_channels,
                                              reduce_scatter, split_rows,
                                              sum_forward)

__all__ = [
    "Param",
    "materialize",
    "abstract",
    "partition_specs",
    "tree_map",
    "tree_leaves",
    "tree_unflatten",
    "dense",
    "quantize_desc",
    "quantize_params",
    "quantize_tree",
    "rms_norm",
    "layer_norm",
    "count_params",
    "fan_in_scaled",
    "split_row_mean",
    "row_mean_parts",
    "row_mean_of_parts",
    "fixed_bmm",
    "leading",
    "out_width",
    "residual_dense",
]


@dataclasses.dataclass(frozen=True)
class Param:
    """Declarative parameter: shape, logical axes, init recipe.

    ``held``: where a rank of a model axis of ``m`` holds the leaf
    otherwise than ``param_specs``' block (sharding/axes.py:held_layouts),
    ``held(m)`` gives ``(columns, shared)``: ``columns(j)`` the positions
    along the last dim that rank ``j`` holds and ``shared`` the ``(lo,
    hi)`` of them every rank holds alike; or None: whole on every rank.
    The mixer that reads the leaf defines it."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # stddev override; default fan-in
    dtype: torch.dtype = torch.float32
    held: Callable | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (dict keys
    in sorted order, as ``jax.tree`` walks them); ``rest`` are trees of
    the same structure whose leaves ride along."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples in ``jax.tree.leaves``
    order (dict keys sorted)."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, values):
    """``tree``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def materialize(tree, generator: torch.Generator | None = None,
                device: str | torch.device | None = None,
                param_dtype: torch.dtype = torch.float32):
    """Real tensors for a descriptor tree, drawn in order from
    ``generator`` (seed 0 on the device when None): zeros/ones as named,
    normal weights with std ``scale`` or 1/sqrt(fan_in), embeddings with
    std 0.02, as the reference's recipe."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def make(p: Param) -> torch.Tensor:
        dtype = param_dtype if p.dtype == torch.float32 else p.dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        fan_in = p.shape[0] if len(p.shape) >= 2 else max(p.shape[-1], 1)
        if p.init == "embed":
            std = p.scale if p.scale is not None else 0.02
        else:
            std = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(p.shape, generator=generator, device=dev) * std
        return w.to(dtype)

    return tree_map(make, tree)


def abstract(tree, param_dtype: torch.dtype = torch.float32):
    """Stand-ins on the ``meta`` device (shapes and dtypes, no memory):
    the reference's ShapeDtypeStruct tree."""
    def f(p: Param) -> torch.Tensor:
        dtype = param_dtype if p.dtype == torch.float32 else p.dtype
        return torch.empty(p.shape, dtype=dtype, device="meta")

    return tree_map(f, tree)


def partition_specs(tree, rules: dict):
    """Logical axes -> mesh axes: a tree of sharding/axes.py:P specs
    (``rules`` values: an axis name, a tuple of names, or None)."""
    return tree_map(lambda p: P(*(rules.get(a, None) if a is not None
                                  else None for a in p.axes)), tree)


def fan_in_scaled(cfg, params):
    """The params with every stacked default-scale matrix rescaled to
    std 1/sqrt(its contraction width).  :func:`materialize` takes a
    stacked weight's fan-in from its leading layers axis, as the
    reference's recipe does (whisper-base's decoder weights get std
    1/sqrt(6), not 1/sqrt(512)); such a random stack is chaotic: a last-
    bit difference anywhere (another summation order) grows through the
    layers, so a kernel's or a split's effect is read on these weights."""
    from repro_torch.models.encdec import encdec_build
    from repro_torch.models.transformer import lm_build

    def scaled(p, w):
        if p.init != "normal" or p.scale is not None \
                or p.axes[0] != "layers" or len(p.shape) < 3:
            return w
        k = p.shape[2] if p.axes[1] == "experts" else p.shape[1]
        return w * math.sqrt(p.shape[0] / k)

    desc = (encdec_build if cfg.family == "encdec" else lm_build)(cfg)
    return tree_map(scaled, desc, params)


def count_params(tree) -> int:
    total = 0

    def add(p: Param):
        nonlocal total
        total += math.prod(p.shape)

    tree_map(add, tree)
    return total


def _row_reduce(out: torch.Tensor, split, exact: bool) -> torch.Tensor:
    """A row-parallel product's result: the ranks' sum (already taken
    when ``exact``, the integer partials summed before dequantization),
    cut to this rank's part of the sequence (dim 1) under sequence
    parallelism; autograd sees a sum whose gradient passes through
    (:func:`sum_forward`), or its reduce-scatter."""
    if split.seq:
        if exact:
            return split_rows(out, split.group, split.index, split.size, 1)
        return reduce_scatter(out, split.group, split.index, split.size, 1)
    return out if exact else sum_forward(out, split.group)


def dense(
    x: torch.Tensor,
    w,
    l2r: QuantConfig | None = None,
    l2r_levels: int | None = None,
    row_parallel: bool = False,
) -> torch.Tensor:
    """x @ w with optional L2R digit-plane arithmetic (the paper's unit).

    w may have >2 dims (e.g. the fused SwiGLU input (d, 2, d_ff));
    trailing dims are flattened for the contraction and restored after.

    w may also be a :class:`~repro_torch.core.quant.QuantizedWeights`
    record (quantize_tree / serve.engine.prepare_params), the L2R weight
    cache.  With an ``l2r`` config the activations stream through the
    level-stacked digit-plane GEMM (kernel B1 on the card) against the
    cached plane stack; without one it is plain W8A8 integer dense,
    computed by the same GEMM at full depth (exactly ``xq @ wq``: CUDA
    has no integer matmul of its own).  A float w with ``l2r`` is
    quantized here, per call; without ``l2r`` it is a plain product.

    w may also be the reference's ``{"q": int8, "scale"}`` record
    (:func:`quantize_params`, the int8 checkpoint codec): W8A8 serving
    arithmetic whatever ``l2r`` says, per-row activation scales, the
    integer product on the same GEMM at full depth, then ``* xs * scale``
    in the reference's order.

    ``row_parallel`` marks ``w`` as a row-parallel weight of the
    tensor-parallel backbone: in a ``ctx.model_shard`` scope
    (sharding/ctx.py) ``x``'s last dim and ``w``'s rows are this rank's
    K-slice, and the result is the sum of the ranks' partial products:
    the integer partials summed exactly before the dequantization on the
    quantized paths (``l2r_matmul_f(group=)``: the one-rank bits), the
    float products summed (reassociated) otherwise; under sequence
    parallelism the rank keeps its part of the sequence.  A
    column-parallel weight (its output channels this rank's) needs
    nothing here: every rank holds the whole ``x``.
    """
    if isinstance(w, dict) and "q" in w:  # never split (shard_params)
        wq, scale = w["q"], w["scale"]
        trail = wq.shape[1:]
        wq = wq.reshape(wq.shape[0], -1)
        lead = x.shape[:-1]
        xq, xs = quantize(x.reshape(-1, x.shape[-1]), QuantConfig(), axis=0)
        out = l2r_gemm(xq, wq)
        out = out.to(torch.float32) * xs \
            * scale.reshape(()).to(torch.float32)
        return out.to(x.dtype).reshape(*lead, *trail)
    split = ctx.model_split() if row_parallel else None
    group = split.group if split is not None else None
    if isinstance(w, QuantizedWeights):
        trail = w.q.shape[1:]
        wq = w.q.reshape(w.q.shape[0], -1)
        ws = w.scale.expand(1, *trail).reshape(1, -1)
        planes = w.planes
        if planes is not None and planes.stack.ndim > 2:
            # flatten the trailing output dims of the cached stack like q's
            # (the contraction axis leads: the plane layout is untouched,
            # and a K-major stack stays a view)
            planes = dataclasses.replace(
                planes, stack=planes.stack.reshape(planes.stack.shape[0], -1),
                axis=-2)
        out = l2r_matmul_f(x, None, l2r or QuantConfig(),
                           l2r_levels if l2r is not None else None,
                           w_q=QuantizedWeights(wq, ws, planes), group=group)
        out = out.reshape(*x.shape[:-1], *trail)
        return out if split is None else _row_reduce(out, split, True)
    if w.ndim > 2:
        out = dense(x, w.reshape(w.shape[0], -1), l2r, l2r_levels,
                    row_parallel)
        return out.reshape(*out.shape[:-1], *w.shape[1:])
    if l2r is not None:
        out = l2r_matmul_f(x, w, l2r, l2r_levels, group=group)
        return out if split is None else _row_reduce(out, split, True)
    out = l2r_dense(x, w, None)
    return out if split is None else _row_reduce(out, split, False)


def _quantizable(p: Param) -> bool:
    """Matmul weights eligible for int8 storage: 2D+ normal-init params
    that are not embedding/vocab tables (lookup + tied logits stay f32)
    and not routed-expert stacks."""
    return (p.init == "normal" and len(p.shape) >= 2
            and "vocab" not in p.axes and "experts" not in p.axes)


def quantize_desc(desc_tree):
    """Descriptor transform: eligible Param -> ``{"q": int8 Param,
    "scale": f32 Param}``, one scale per (stacked layer x) tensor: the
    int8 storage format :func:`dense` serves."""
    def f(p: Param):
        if not _quantizable(p):
            return p
        stacked = bool(p.axes) and p.axes[0] == "layers"
        sshape = (p.shape[0],) + (1,) * (len(p.shape) - 1) if stacked \
            else (1,) * len(p.shape)
        saxes = ("layers",) + (None,) * (len(p.shape) - 1) if stacked \
            else (None,) * len(p.shape)
        return {"q": Param(p.shape, p.axes, init=p.init, scale=p.scale,
                           dtype=torch.int8),
                "scale": Param(sshape, saxes, init="ones")}
    return tree_map(f, desc_tree)


def quantize_params(desc_tree, params):
    """Materialized params -> the int8 records of :func:`quantize_desc`.

    One symmetric scale per tensor (per layer of a stacked weight),
    ``max(amax, 1e-30) / 127`` divided as the reference divides (it
    calls this eagerly, outside ``jit``, so no multiply by a folded
    reciprocal), codes ``clip(round(w / scale), -127, 127)``.
    """
    def f(p: Param, w):
        if not _quantizable(p):
            return w
        wf = w.to(torch.float32)
        if p.axes and p.axes[0] == "layers":  # one scale per stacked layer
            amax = torch.amax(wf.abs(), dim=tuple(range(1, wf.ndim)),
                              keepdim=True)
        else:
            amax = wf.abs().amax().reshape((1,) * wf.ndim)
        scale = torch.clamp(amax, min=1e-30) / 127.0
        q = torch.clamp(torch.round(wf / scale), -127, 127)
        return {"q": q.to(torch.int8), "scale": scale}
    return tree_map(f, desc_tree, params)


def quantize_tree(desc_tree, params, cfg: QuantConfig = QuantConfig(),
                  prestack: bool = False):
    """Materialized params -> :class:`QuantizedWeights` leaves.

    The load-time L2R weight cache: every eligible matmul weight is
    quantized ONCE, per out-channel (and per stacked layer).
    ``prestack=True`` also caches each weight's reversed RHS plane stack
    along its contraction axis (axis 1 for stacked-layer weights, whose
    leading layer axis the forward strips) in kernel B1's operand
    format: pre-shifted planes, K-major in memory, so a layer's slice
    reaches the kernel in place and no forward extracts, shifts or
    transposes a weight plane.  The stack converts exactly to the
    reference's raw-digit one (``PlaneOperands.with_layout``).
    """
    def f(p: Param, w):
        if not _quantizable(p):
            return w
        stacked = p.axes and p.axes[0] == "layers"
        axes = (0, -1) if stacked else (-1,)
        return quantize_weights(w, cfg, channel_axes=axes, prestack=prestack,
                                plane_axis=1 if stacked else 0,
                                plane_shifted=True, k_major=True)
    return tree_map(f, desc_tree, params)


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last dim, each row summed in an order its width
    alone fixes.  On the card PyTorch's reduction gives each row more
    threads, and so another summation order, when a call holds fewer
    than 16 rows: a row's norm would depend on the rows beside it, and a
    rank decoding its 4 slots of a batch would round apart from one
    process decoding all 8.  Summed as 32 partial sums (32 or more rows
    of work, the widest launch; a width 32 does not divide is padded with
    zeros) and then those 32, it does not.  On the CPU ``torch.mean``
    (a meta tensor takes the card's path: device.card_path)."""
    d = x.shape[-1]
    if not card_path(x):
        return torch.mean(x, dim=-1, keepdim=True)
    if d % 32:
        x = F.pad(x, (0, -d % 32))
    return x.reshape(*x.shape[:-1], 32, x.shape[-1] // 32).sum(-1) \
        .sum(-1, keepdim=True) / d


def split_row_mean(x: torch.Tensor, split) -> torch.Tensor:
    """:func:`_row_mean` of rows split over the model axis: ``x`` holds
    this rank's contiguous ``d / m`` columns of each ``d``-wide row
    (``split``: sharding/ctx.py:ModelSplit).  On the card, where ``m``
    divides 32 and 32 divides ``d``, the rank sums its 32 / m of
    :func:`_row_mean`'s 32 partial sums (whole groups of d / 32 columns)
    and the ranks' partials are all-gathered in rank order and summed as
    :func:`_row_mean` sums them: the same groups summed in the same
    order (a reduction of at most 32 terms an output orders them by its
    width alone), so the one-process bits.  Otherwise, and on the CPU,
    where :func:`_row_mean` is ``torch.mean`` and does not decompose, the
    rows are all-gathered whole and :func:`_row_mean` taken on them.
    The gathered values' gradient is summed over the ranks
    (sharding/collectives.py:gather_channels)."""
    d = x.shape[-1] * split.size
    if card_path(x) and 32 % split.size == 0 and d % 32 == 0:
        parts = gather_channels(row_mean_parts(x, split.size), split.group,
                                split.index)
        return row_mean_of_parts(parts, d)
    return _row_mean(gather_channels(x, split.group, split.index))


def row_mean_parts(x: torch.Tensor, m: int) -> torch.Tensor:
    """A rank's ``32 / m`` of :func:`_row_mean`'s 32 partial sums, ``x``
    its ``d / m`` columns of each row (card path of
    :func:`split_row_mean`)."""
    d = x.shape[-1] * m
    return x.reshape(*x.shape[:-1], 32 // m, d // 32).sum(-1)


def row_mean_of_parts(parts: torch.Tensor, d: int) -> torch.Tensor:
    """The mean of ``d``-wide rows from their 32 partial sums in order, as
    :func:`_row_mean` sums them."""
    return parts.sum(-1, keepdim=True) / d


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             split=None) -> torch.Tensor:
    """RMSNorm with gain ``1 + gamma``; ``split`` (a ModelSplit): ``x``'s
    rows are split over the model axis, ``gamma`` this rank's part, the
    mean the whole row's (:func:`split_row_mean`)."""
    xf = x.to(torch.float32)
    sq = torch.square(xf)
    var = _row_mean(sq) if split is None else split_row_mean(sq, split)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32, one ``F.layer_norm`` call: it
    takes each row's moments on the row alone (one thread block a row on
    the card, in an order the width fixes), so a row's bits do not depend
    on the rows beside it, where a reduction over the whole call may sum
    a row otherwise when the call holds few rows (a rank decoding its
    slots of a batch; :func:`_row_mean`)."""
    d = x.shape[-1]
    out = F.layer_norm(x.to(torch.float32), (d,), gamma.to(torch.float32),
                       beta.to(torch.float32), eps)
    return out.to(x.dtype)



def fixed_bmm(a: torch.Tensor, b: torch.Tensor, block: int) -> torch.Tensor:
    """``torch.bmm(a, b)`` of ``a`` (E, M, K) and ``b`` (E, K, N), made
    contiguous, in calls of ``block`` entries, the last padded with zero
    entries.  A batched product may split its sums differently as its
    batch count changes (cuBLAS picks its kernel by it), so an entry's
    result would depend on how many entries share its call; with every
    call of one shape it does not, and a rank holding some of the rows or
    heads computes them as one process does.  Differentiable."""
    a, b = a.contiguous(), b.contiguous()
    e = a.shape[0]
    outs = []
    for i in range(0, e, block):
        j = min(i + block, e)
        ai, bi = a[i:j], b[i:j]
        if j - i < block:
            ai = torch.cat([ai, ai.new_zeros((block - (j - i),
                                              *a.shape[1:]))])
            bi = torch.cat([bi, bi.new_zeros((block - (j - i),
                                              *b.shape[1:]))])
        outs.append(torch.bmm(ai, bi)[:j - i])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def leading(w) -> int:
    """The contraction width (leading dim) of a dense weight: a tensor, a
    :class:`QuantizedWeights` record or an int8 ``{"q", "scale"}`` one."""
    return _codes(w).shape[0]


def out_width(w) -> int:
    """The output width (last dim) of a layer's dense weight, as
    :func:`leading`."""
    return _codes(w).shape[-1]


def _codes(w):
    if isinstance(w, QuantizedWeights):
        return w.q
    return w["q"] if isinstance(w, dict) else w


def residual_dense(x: torch.Tensor, w, l2r: QuantConfig | None,
                   l2r_levels: int | None, k_whole: int) -> torch.Tensor:
    """A block's last product, whose result joins the residual stream.  In
    a ``ctx.model_shard`` scope a weight holding fewer than ``k_whole``
    rows is this rank's row-parallel slice (:func:`dense` with
    ``row_parallel``); a whole one (a model axis that does not divide its
    rows: the block ran whole on every rank) gives the whole result, of
    which the rank keeps its part of the sequence under sequence
    parallelism (the gradient of the other parts gathered back)."""
    split = ctx.model_split()
    if split is not None and leading(w) != k_whole:
        return dense(x, w, l2r, l2r_levels, row_parallel=True)
    out = dense(x, w, l2r, l2r_levels)
    if split is not None and split.seq:
        return split_rows(out, split.group, split.index, split.size, 1)
    return out
