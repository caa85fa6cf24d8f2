"""VGG-16 — the paper's evaluation network, with the L2R conv path.

The port of ``repro/models/cnn.py``.  Layouts are the reference's: NHWC
activations, HWIO conv weights, (K, N) dense weights, and the param keys
``conv1_1`` … ``conv5_3``, ``fc6`` … ``fc8``, each ``{"w", "b"}``, so a
reference param tree converts by value (models/convert.py).

Convolutions run either as float (``F.conv2d`` with TF32 off) or through
the fused L2R conv (kernels/l2r_gemm/ops.py:l2r_conv2d), whose every tap
and every FC layer is one launch of kernel B1 on the card: 13·9 + 3 =
120 launches per forward.  Weights quantize once per model load
(:func:`vgg16_quantize_weights`).  :func:`vgg16_classify_progressive`
runs the same trunk (119 B1 launches) and streams the fc8 head level by
level: one kernel-B2 launch on the scan path, or at most 2D-1 = 7 B1
level launches on the early-exit path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.cycle_model import VGG16_CONV_LAYERS
from repro_torch.core.progressive import streaming_argmax
from repro_torch.core.quant import (QuantConfig, QuantizedWeights, quantize,
                                    quantize_weights)
from repro_torch.device import no_tf32, resolve_device
from repro_torch.kernels.l2r_gemm.ops import (CUDA_WALK, l2r_conv2d,
                                              l2r_matmul_f)
from repro_torch.models.resize import resize_7x7 as _resize_7x7
from repro_torch.sharding import ctx
from repro_torch.sharding.collectives import gather_columns

__all__ = ["vgg16_build", "vgg16_apply", "vgg16_classify_progressive",
           "vgg16_quantize_weights", "VGG16", "VGG16_CONV_LAYERS"]

_POOL_AFTER = {1, 3, 6, 9, 12}  # conv indices followed by a 2x2 max pool


def vgg16_shapes(n_classes: int = 1000, in_channels: int = 3
                 ) -> dict[str, tuple[int, ...]]:
    """Weight shape per layer (biases are (cout,))."""
    shapes, c_in = {}, in_channels
    for layer in VGG16_CONV_LAYERS:
        shapes[layer.name] = (layer.k, layer.k, c_in, layer.M)
        c_in = layer.M
    shapes["fc6"] = (512 * 7 * 7, 4096)
    shapes["fc7"] = (4096, 4096)
    shapes["fc8"] = (4096, n_classes)
    return shapes


def vgg16_build(n_classes: int = 1000, in_channels: int = 3,
                generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> dict:
    """Random VGG-16 params: He-normal weights (std sqrt(2 / fan_in),
    fan_in = kh*kw*cin or K) drawn from ``generator`` (seed 0 on the
    device when None), zero biases."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = {}
    for name, shape in vgg16_shapes(n_classes, in_channels).items():
        std = math.sqrt(2.0 / math.prod(shape[:-1]))
        w = torch.randn(shape, generator=generator, device=dev) * std
        params[name] = {"w": w, "b": torch.zeros(shape[-1], device=dev)}
    return params


def vgg16_quantize_weights(params: dict, cfg: QuantConfig = QuantConfig(),
                           prestack: bool = True, mesh=None
                           ) -> dict[str, QuantizedWeights]:
    """The L2R weight cache: every weight -> int8 + per-out-channel scale,
    built once at model load.  ``prestack=True`` also caches each layer's
    pre-shifted reversed plane stack (contraction axis -2 for convs, 0
    for the FC head) — kernel B1's operand format, K-major in memory —
    so no weight plane is extracted or transposed per forward.

    ``mesh`` (default: the installed mesh, sharding/ctx.py) splits fc8's
    cache over the ``model`` axis by class: this rank keeps its slice
    (core/quant.py:quantize_weights ``shard=``), the layout the consensus
    walk of :func:`vgg16_classify_progressive` reads.  The trunk's caches
    stay whole."""
    if mesh is None:
        mesh = ctx.get_mesh()
    return {name: quantize_weights(
                p["w"], cfg, prestack=prestack,
                plane_axis=-2 if p["w"].ndim == 4 else 0,
                plane_shifted=True, k_major=True,
                shard=(None, "model") if name == "fc8" else None,
                mesh=mesh if name == "fc8" else None)
            for name, p in params.items()}


def _conv_float(x, w, b):
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding="same")
    return out.permute(0, 2, 3, 1) + b


def _nchw(fn, x):
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def vgg16_apply(
    params: dict,
    images: torch.Tensor,  # (B, H, W, 3)
    l2r: QuantConfig | None = None,
    levels: int | None = None,
    weights_q: dict[str, QuantizedWeights] | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Forward pass on ``device`` (CUDA unless ``device="cpu"``).  Returns
    logits (B, n_classes).

    Any input size that survives 5 pools works; the FC head resizes the
    map to 7x7.  ``weights_q`` is the load-time cache from
    :func:`vgg16_quantize_weights`; when omitted on the L2R path it is
    built here, once per call.
    """
    dev = _forward_device(params, device)
    with torch.no_grad(), no_tf32():
        x, weights_q = _vgg16_trunk(params, torch.as_tensor(images, device=dev),
                                    l2r, levels, weights_q)
        if l2r is not None:
            w8 = weights_q["fc8"]
            return gather_columns(l2r_matmul_f(x, None, l2r, levels, w_q=w8),
                                  w8.shard) + params["fc8"]["b"]
        return x @ params["fc8"]["w"] + params["fc8"]["b"]


def _forward_device(params: dict, device) -> torch.device:
    dev = resolve_device(device)
    if params["fc8"]["w"].device != dev:
        raise ValueError(f"params live on {params['fc8']['w'].device}, the "
                         f"forward runs on {dev}: build or move them there")
    return dev


def vgg16_classify_progressive(
    params: dict,
    images: torch.Tensor,  # (B, H, W, 3)
    l2r: QuantConfig = QuantConfig(),
    weights_q: dict[str, QuantizedWeights] | None = None,
    early_exit: bool = False,
    device: str | torch.device | None = None,
    mesh=None,
):
    """Classification with online early exit on the fc8 logit stream, on
    ``device`` (CUDA unless ``device="cpu"``).

    The trunk (convs + fc6/fc7) runs exactly, all MSDF levels; the fc8
    head streams level by level and each image commits its class as soon
    as the top-1 logit margin beats the scaled tail bound on the unseen
    digits.  The committed class always equals
    ``argmax(vgg16_apply(..., l2r=l2r))``: undecided rows fall back to
    the full stream.

    ``early_exit=True`` stops the head's level loop once every image has
    decided: classes and exit levels are unchanged, and the logits are
    the dequantized prefix at the exit level.  With ``early_exit=False``
    the logits are ``vgg16_apply``'s bit for bit.

    Returns ``(pred (B,) int32, exit_level (B,) int32, logits (B, C))``;
    exit_level counts MSDF levels consumed (2D-2 = needed everything).

    Under a mesh (``mesh=``, else the installed one) every rank runs the
    trunk and the head streams as the consensus walk: images split over
    the data axes, fc8's classes over ``model`` (a cache from
    ``vgg16_quantize_weights(mesh=)`` holds this rank's classes), early
    exit at the slowest image; every rank returns the single-device
    results bit for bit.
    """
    dev = _forward_device(params, device)
    with torch.no_grad(), no_tf32():
        x, weights_q = _vgg16_trunk(params, torch.as_tensor(images, device=dev),
                                    l2r, None, weights_q)
        w_q = weights_q["fc8"]
        # quantized exactly as l2r_matmul_f does, so the streamed
        # accumulator is the one-shot fc8 accumulator
        xq, xs = quantize(x, l2r, axis=0 if l2r.per_channel else None)
        logits, pred, exit_level = streaming_argmax(
            xq, w_q.stream_operand(l2r.n_bits, l2r.log2_radix), xs,
            w_q.scale, l2r.n_bits, l2r.log2_radix, bias=params["fc8"]["b"],
            out_dtype=x.dtype, early_exit=early_exit, cuda_walk=CUDA_WALK,
            mesh=mesh)
    return pred, exit_level, logits


def _vgg16_trunk(params, images, l2r, levels, weights_q):
    """Everything up to the fc8 classifier head: (fc7 activations,
    weights_q)."""
    x = images
    if l2r is not None and weights_q is None:
        weights_q = vgg16_quantize_weights(params, l2r)
    if l2r is not None:
        conv = lambda x, p, name: l2r_conv2d(
            x, None, p["b"], l2r, levels, w_q=weights_q[name])
    else:
        conv = lambda x, p, name: _conv_float(x, p["w"], p["b"])
    for i, layer in enumerate(VGG16_CONV_LAYERS):
        x = torch.relu(conv(x, params[layer.name], layer.name))
        if i in _POOL_AFTER:
            x = _nchw(lambda t: F.max_pool2d(t, 2, 2), x)
    # adaptive head: the FC head works for any input resolution
    x = _resize_7x7(x)
    flat = x.reshape(x.shape[0], -1)
    if l2r is not None:
        mm = lambda a, name: l2r_matmul_f(a, None, l2r, levels,
                                          w_q=weights_q[name])
    else:
        mm = lambda a, name: a @ params[name]["w"]
    x = torch.relu(mm(flat, "fc6") + params["fc6"]["b"])
    x = torch.relu(mm(x, "fc7") + params["fc7"]["b"])
    return x, weights_q


class VGG16(nn.Module):
    """VGG-16 as a module: the param tree as frozen parameters, the L2R
    weight cache built once at construction, ``forward`` =
    :func:`vgg16_apply`."""

    def __init__(self, params: dict, l2r: QuantConfig | None = None,
                 levels: int | None = None):
        super().__init__()
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({
                k: nn.Parameter(v, requires_grad=False) for k, v in p.items()})
            for name, p in params.items()})
        self.l2r, self.levels = l2r, levels
        self.weights_q = (None if l2r is None
                          else vgg16_quantize_weights(self.params(), l2r))

    def params(self) -> dict:
        return {name: dict(pd.items()) for name, pd in self.layers.items()}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return vgg16_apply(self.params(), images, self.l2r, self.levels,
                           self.weights_q, device=self.layers["fc8"]["w"].device)
