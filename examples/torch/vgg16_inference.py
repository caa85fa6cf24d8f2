"""VGG-16 inference through the L2R pipeline on the PyTorch port: the
paper's evaluation.

    python examples/torch/vgg16_inference.py [--device cuda|cpu] [--size 64] [--batch 4] [--width-div 1]

Compares float32 conv, exact W8A8 L2R digit-plane conv (kernel B1 on the
card) and the progressive-precision modes, then prints the per-layer
Cycle_P walk of the modeled accelerator (the execution-cycles evaluation
of the paper).  Runs on the card unless ``--device cpu``.
``--width-div N`` keeps 1/N of every layer's channels (a smoke-width
VGG-16 for a quick run on the CPU; the default is the full width).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.cycle_model import (AcceleratorConfig,  # noqa: E402
                                          VGG16_CONV_LAYERS, layer_cycles)
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.cnn import (vgg16_apply, vgg16_build,  # noqa: E402
                                    vgg16_quantize_weights)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def narrow(params: dict, div: int) -> dict:
    """VGG-16's params with 1/``div`` of every layer's channels (fc6's
    input keeps its 7x7 positions of the narrowed conv5_3 channels)."""
    if div == 1:
        return params
    out = {}
    for name, p in params.items():
        w, b = p["w"], p["b"]
        n_out = w.shape[-1] if name == "fc8" else w.shape[-1] // div
        if name.startswith("conv"):
            c_in = w.shape[2] if name == "conv1_1" else w.shape[2] // div
            w = w[:, :, :c_in, :n_out]
        elif name == "fc6":
            w = w.reshape(49, -1, w.shape[-1])[:, :w.shape[0] // 49 // div,
                                               :n_out].reshape(-1, n_out)
        else:
            w = w[:w.shape[0] // div, :n_out]
        out[name] = {"w": w.contiguous(), "b": b[:n_out].contiguous()}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--size", type=int, default=64,
                    help="image side (>= 32: five pools)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--width-div", type=int, default=1,
                    help="keep 1/N of every layer's channels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = narrow(vgg16_build(
        n_classes=10, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev), args.width_div)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal(
        (args.batch, args.size, args.size, 3)).astype(np.float32)).to(dev)

    # the L2R weight cache: quantize every conv/fc weight ONCE at load
    # time; the forward passes below then carry no weight quantization
    cfg = QuantConfig()
    wq = vgg16_quantize_weights(params, cfg)

    print("forward float32 ...")
    t0 = time.time()
    lf = vgg16_apply(params, img, device=dev).cpu().numpy()
    print(f"  {time.time() - t0:.1f}s  logits[0,:4] = {np.round(lf[0, :4], 3)}")

    print("forward L2R W8A8 (exact MSDF stream, fused conv, cached "
          "weights) ...")
    t0 = time.time()
    lq = vgg16_apply(params, img, l2r=cfg, weights_q=wq,
                     device=dev).cpu().numpy()
    _sync(dev)
    rel = np.abs(lq - lf).max() / np.abs(lf).max()
    print(f"  {time.time() - t0:.1f}s  rel err vs float: {rel:.4f}")
    assert np.isfinite(lq).all() and lq.shape == (args.batch, 10)
    agree = (lq.argmax(-1) == lf.argmax(-1)).mean()
    print(f"  top-1 agreement: {agree * 100:.0f}%")

    for lv in (5, 3):
        lp = vgg16_apply(params, img, l2r=cfg, levels=lv, weights_q=wq,
                         device=dev).cpu().numpy()
        rel = np.abs(lp - lq).max() / (np.abs(lq).max() + 1e-9)
        agree = (lp.argmax(-1) == lq.argmax(-1)).mean()
        print(f"progressive levels={lv}/7: rel err {rel:.3f}, "
              f"top-1 agreement {agree * 100:.0f}% (early MSDF exit)")

    print("\nmodeled accelerator cycles (Cycle_P, 8x8 PEs @ 400 MHz):")
    acc = AcceleratorConfig()
    tot_l = tot_b = 0
    for layer in VGG16_CONV_LAYERS:
        cl, cb = layer_cycles(layer, acc, True), layer_cycles(layer, acc,
                                                               False)
        tot_l += cl
        tot_b += cb
        print(f"  {layer.name:9s} L2R {cl / 1e6:8.1f}M  baseline "
              f"{cb / 1e6:8.1f}M  ({cb / cl:.2f}x)")
    print(f"  {'total':9s} L2R {tot_l / 1e6:8.1f}M  baseline "
          f"{tot_b / 1e6:8.1f}M  ({tot_b / tot_l:.2f}x — paper: 3.40x)")


if __name__ == "__main__":
    main()
