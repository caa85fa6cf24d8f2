#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card (nvidia-smi name and power limit) and the kernel build:
     every ``csrc/*.cu`` of ``repro_torch`` compiled with nvcc into
     ``build/repro_torch/``, one nvcc per source, all at once;
  2. kernel B1 (``l2r_stacked_gemm``) against its plain version on the
     card, bit for bit: ragged shapes (K=3 included) at every listed
     ``levels``, then every distinct GEMM shape of a VGG-16 forward at
     batch 8, each timed (CUDA events) beside its plain version, its
     bound and ``torch._int_mm`` on the unstacked operands;
  3. VGG-16 at its published width (224x224, 1000 classes, seeded
     He-normal weights) serving 3 batches of 8 images through
     ``vgg16_apply(..., l2r=QuantConfig())``: 120 kernel launches per
     forward, finite logits equal bit for bit to the same forward with
     the plain GEMM, and top-1 agreement with the float forward (TF32 off).
Then one JSON line per kernel, the card again, and the result line.

Imports neither jax nor the JAX package; exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM data sheet, dense: int8 tensor-core rate and HBM3 bandwidth
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
BATCH = 8
RAGGED = [(5, 3, 7), (130, 19, 67), (16, 64, 1000), (17, 48, 33),
          (300, 128, 96)]
RAGGED_CONFIGS = [(8, 2), (8, 1), (8, 4), (4, 2)]
LEVELS = [None, 0, 1, 3, 7]
SOURCE = "src/repro_torch/kernels/l2r_gemm/csrc/l2r_stacked_gemm.cu"
REPLACES = "src/repro/kernels/l2r_gemm/kernel.py:180"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main_path_shapes() -> list[dict]:
    """Every distinct GEMM of a VGG-16 forward at BATCH, with the number
    of launches it takes per forward (9 taps per conv layer)."""
    from repro_torch.core.cycle_model import VGG16_CONV_LAYERS

    shapes: dict[tuple, dict] = {}
    for layer in VGG16_CONV_LAYERS:
        key = (BATCH * layer.R * layer.C, layer.N, layer.M)
        row = shapes.setdefault(key, {"name": layer.name, "count": 0,
                                      "accumulate": True})
        row["count"] += layer.k * layer.k
    for name, (k, n) in {"fc6": (25088, 4096), "fc7": (4096, 4096),
                         "fc8": (4096, 1000)}.items():
        shapes[(BATCH, k, n)] = {"name": name, "count": 1,
                                 "accumulate": False}
    return [{"m": m, "k": k, "n": n, **row} for (m, k, n), row in
            shapes.items()]


def phase_kernel(dev) -> list[dict]:
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(0)

    def operands(m, k, n, n_bits):
        hi = 1 << (n_bits - 1)
        a = torch.randint(-hi, hi, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-hi, hi, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        return a, b

    checked = 0
    for (m, k, n) in RAGGED:
        for n_bits, log2_radix in RAGGED_CONFIGS:
            a, b = operands(m, k, n, n_bits)
            sa = stack_planes_lhs(a, n_bits, log2_radix)
            sb = stack_planes_rhs(b, n_bits, log2_radix)
            for lv in LEVELS:
                got = kernel.l2r_gemm_stacked_planes(sa, sb, n_bits,
                                                     log2_radix, lv)
                ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, n_bits,
                                                           log2_radix, lv)
                require(torch.equal(got, ref),
                        f"B1 != plain at M={m} K={k} N={n} n_bits={n_bits} "
                        f"log2_radix={log2_radix} levels={lv}")
                checked += 1
            acc = torch.full((m, n), 7, dtype=torch.int32, device=dev)
            kernel.l2r_gemm_stacked_planes(sa, sb, n_bits, log2_radix,
                                           out=acc)
            require(torch.equal(acc, kernel.l2r_gemm_stacked_planes_plain(
                sa, sb, n_bits, log2_radix) + 7),
                f"B1 out= accumulation wrong at M={m} K={k} N={n}")
    print(f"phase 2a: B1 == plain (bit for bit) on {checked} ragged "
          f"cases, levels {LEVELS}, configs {RAGGED_CONFIGS}", flush=True)

    rows = []
    for sh in main_path_shapes():
        m, k, n, acc_mode = sh["m"], sh["k"], sh["n"], sh["accumulate"]
        a, b = operands(m, k, n, 8)
        sa, sb = stack_planes_lhs(a), stack_planes_rhs(b)
        for lv in (None, 3):
            got = kernel.l2r_gemm_stacked_planes(sa, sb, levels=lv)
            ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, levels=lv)
            require(torch.equal(got, ref),
                    f"B1 != plain at {sh['name']} M={m} K={k} N={n} "
                    f"levels={lv}")
        err = (got.to(torch.int64) - ref.to(torch.int64)).abs().max().item()
        out = torch.zeros((m, n), dtype=torch.int32, device=dev) \
            if acc_mode else None
        ms = time_ms(lambda: kernel.l2r_gemm_stacked_planes(sa, sb, out=out))
        plain_ms = time_ms(
            lambda: kernel.l2r_gemm_stacked_planes_plain(sa, sb, out=out),
            iters=3, warmup=1)
        # the yardstick: one int8 GEMM on the unstacked operands, zero-
        # padded to torch._int_mm's shape limits (M > 16, K and N
        # multiples of 8; zero padding is exact)
        mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-n // 8) * 8
        ap = torch.zeros((mp, kp), dtype=torch.int8, device=dev)
        bp = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
        ap[:m, :k], bp[:k, :n] = a, b
        lib = torch._int_mm(ap, bp)
        require(torch.equal(lib[:m, :n], kernel.l2r_gemm_stacked_planes(sa, sb)),
                f"torch._int_mm disagrees with B1 at {sh['name']}")
        library_ms = time_ms(lambda: torch._int_mm(ap, bp))
        d = 4  # planes of the main path's config (n=8, radix 4)
        ops = 2 * m * n * k * d * d
        nbytes = m * d * k + d * k * n + m * n * 4 * (2 if acc_mode else 1)
        t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {**sh, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "max_abs_err": err, "int_mm_padded": (mp, kp, np_) != (m, k, n)}
        rows.append(row)
        print("phase 2b: " + json.dumps(row), flush=True)
    print(f"phase 2b: B1 == plain (bit for bit) at all {len(rows)} VGG-16 "
          f"shapes, levels None and 3", flush=True)
    return rows


def profile_forward(fn) -> dict:
    """Device time of one forward by kernel (torch.profiler, CUDA
    activity): B1's share, the other kernels, and the idle share of the
    forward's wall time.  Zero device time is reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    if not busy:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    b1 = sum(v for k, v in by_name.items() if "l2r_stacked_gemm" in k)
    top = sorted(((v, k) for k, v in by_name.items()
                  if "l2r_stacked_gemm" not in k), reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_ms": busy, "b1_ms": b1,
            "other_ms": busy - b1, "idle_share": max(0.0, 1 - busy / wall_ms),
            "top_other": [[k[:80], v] for v, k in top]}


def phase_vgg(dev) -> dict:
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.l2r_gemm import kernel
    from repro_torch.models.cnn import (vgg16_apply, vgg16_build,
                                        vgg16_quantize_weights)

    cfg = QuantConfig()
    params = vgg16_build(1000, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    t0 = time.perf_counter()
    weights_q = vgg16_quantize_weights(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gi = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randn((BATCH, 224, 224, 3), generator=gi, device=dev)
               for _ in range(3)]

    kernel.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [vgg16_apply(params, x, l2r=cfg, weights_q=weights_q, device=dev)
              for x in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.LAUNCHES
    require(launches == 120 * len(batches),
            f"{launches} B1 launches for {len(batches)} forwards, "
            f"expected {120 * len(batches)}")
    for lg in logits:
        require(lg.shape == (BATCH, 1000) and bool(torch.isfinite(lg).all()),
                "non-finite or misshapen logits")

    timed = []
    for x in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vgg16_apply(params, x, l2r=cfg, weights_q=weights_q, device=dev)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)

    prof = profile_forward(lambda: vgg16_apply(
        params, batches[0], l2r=cfg, weights_q=weights_q, device=dev))

    fast = kernel.l2r_gemm_stacked_planes
    kernel.l2r_gemm_stacked_planes = kernel.l2r_gemm_stacked_planes_plain
    try:
        plain = vgg16_apply(params, batches[0], l2r=cfg, weights_q=weights_q,
                            device=dev)
    finally:
        kernel.l2r_gemm_stacked_planes = fast
    require(torch.equal(plain, logits[0]),
            "L2R logits differ from the plain-GEMM forward on the card")
    flt = torch.cat([vgg16_apply(params, x, device=dev) for x in batches])
    top1 = (flt.argmax(-1) == torch.cat(logits).argmax(-1)).float().mean()
    out = {"launches": launches, "first_3_forwards_s": wall,
           "forward_s": timed, "images_per_s": BATCH / statistics.median(timed),
           "quantize_weights_s": quant_s, "top1_agreement_vs_float":
           top1.item(), "plain_gemm_forward_bit_identical": True,
           "profile": prof}
    print("phase 3: " + json.dumps(out), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = card()
    print(f"phase 1: card: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"phase 1: ptxas: {line.strip()}", flush=True)

    rows = phase_kernel(dev)
    vgg = phase_vgg(dev)

    per_fwd = lambda key: sum(r[key] * r["count"] for r in rows)  # noqa: E731
    bound_ops = sum(r["bound_ms"] * r["count"] for r in rows
                    if r["bound_by"] == "operations")
    entry = {
        "name": "l2r_stacked_gemm", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "replaces_function": "_l2r_stacked_kernel",
        "checked": True, "launches": vgg["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_ms"),
        "bound_by": "operations" if bound_ops >= per_fwd("bound_ms") / 2
        else "bytes",
        "library_ms": per_fwd("library_ms"),
        "per": f"one VGG-16 forward at batch {BATCH} (sum over its 120 "
               f"launches of the per-shape medians)",
        "images_per_s": vgg["images_per_s"],
        "shapes": rows,
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
