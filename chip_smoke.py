#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card (nvidia-smi name and power limit) and the kernel build:
     every ``csrc/*.cu`` of ``repro_torch`` compiled with nvcc into
     ``build/repro_torch/``, one nvcc per source, all at once;
  2. each kernel against its plain version on the card, bit for bit:
     ragged shapes (K=3 and M<=16 included) at every listed ``levels``,
     then every distinct GEMM shape of a VGG-16 forward at batch 8, each
     timed (CUDA events) beside its plain version, its bound and
     ``torch._int_mm`` on the unstacked operands.  2a/2b kernel B1 (the
     level-stacked GEMM), 2c/2d kernel B2 (the per-level snapshot stream;
     also ``level_count`` and ``out=``), 2e/2f kernel B3 (the pair loop);
  3. VGG-16 at its published width (224x224, 1000 classes, seeded
     He-normal weights) serving 3 batches of 8 images through
     ``vgg16_apply(..., l2r=QuantConfig())``: 120 B1 launches per
     forward, finite logits equal bit for bit to the same forward with
     the plain GEMM, and top-1 agreement with the float forward (TF32 off);
  4. the same 3 batches through ``vgg16_classify_progressive`` with
     ``early_exit`` False (119 B1 + 1 B2 launches per forward) and True
     (119 B1 + at most 7 B1 level launches): classes equal
     ``argmax(vgg16_apply)``, scan logits bit-identical to it, classes
     and exit levels identical between the two control flows, and the
     early-exit logits bit-identical to the scan's prefix after the
     levels the loop ran;
  5. the pair-loop path: the FC head (fc6-fc8) through
     ``l2r_matmul_f(..., schedule="pairs")``, 3 B3 launches per forward,
     bit-identical to the stacked schedule;
  6. a decisive-margin prototype head (k=4096, 1000 classes, 256 rows)
     through ``streaming_argmax``, scan against while;
  7. ``l2r_conv2d_progressive`` on full-width conv1_2 and conv4_2 at
     batch 8: plane l equals the conv at ``levels=l+1``, and each plane
     lies within its tail bound of the last.
Then one JSON line per kernel, the card again, and the result line.
Each path's launch counts are reset to 0 just before it and read just
after; launches made to compare a kernel with its plain version are not
counted.

Imports neither jax nor the JAX package; exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM data sheet, dense: int8 tensor-core rate and HBM3 bandwidth
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
BATCH = 8
RAGGED = [(5, 3, 7), (130, 19, 67), (16, 64, 1000), (17, 48, 33),
          (300, 128, 96)]
RAGGED_CONFIGS = [(8, 2), (8, 1), (8, 4), (4, 2)]
LEVELS = [None, 0, 1, 3, 7]
CSRC = "src/repro_torch/kernels/l2r_gemm/csrc"
PALLAS = "src/repro/kernels/l2r_gemm/kernel.py"
KERNELS = {  # library -> (id, Pallas body it replaces)
    "l2r_stacked_gemm": ("B1", f"{PALLAS}:180"),
    "l2r_streaming_gemm": ("B2", f"{PALLAS}:317"),
    "l2r_pairs_gemm": ("B3", f"{PALLAS}:79"),
}
N_LEVELS = 7  # 2D-1 for the main path's config (n=8, radix 4)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def reset_counts() -> None:
    from repro_torch.kernels.l2r_gemm import kernel

    for name in kernel.LAUNCHES:
        kernel.LAUNCHES[name] = 0


def counts() -> dict[str, int]:
    from repro_torch.kernels.l2r_gemm import kernel

    return dict(kernel.LAUNCHES)


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


def host_ms(fn) -> float:
    """Host clock around one call that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time on this card: int8 operations over the peak rate or
    bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def operands(g, dev, m, k, n, n_bits):
    hi = 1 << (n_bits - 1)
    a = torch.randint(-hi, hi, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-hi, hi, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    return a, b


def int_mm(a, b):
    """The yardstick: one int8 GEMM on the unstacked operands, zero-
    padded to torch._int_mm's shape limits (M > 16, K and N multiples
    of 8; zero padding is exact).  Returns (result (M, N), timed fn,
    padded?)."""
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-n // 8) * 8
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
    bp = torch.zeros((kp, np_), dtype=torch.int8, device=a.device)
    ap[:m, :k], bp[:k, :n] = a, b
    return (torch._int_mm(ap, bp)[:m, :n], lambda: torch._int_mm(ap, bp),
            (mp, kp, np_) != (m, k, n))


def max_err(got, ref) -> int:
    return int((got.to(torch.int64) - ref.to(torch.int64)).abs().max().item()
               ) if got.numel() else 0


def phase_kernel(dev) -> list[dict]:
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(0)
    checked = 0
    for (m, k, n) in RAGGED:
        for n_bits, log2_radix in RAGGED_CONFIGS:
            a, b = operands(g, dev, m, k, n, n_bits)
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
        a, b = operands(g, dev, m, k, n, 8)
        sa, sb = stack_planes_lhs(a), stack_planes_rhs(b)
        for lv in (None, 3):
            got = kernel.l2r_gemm_stacked_planes(sa, sb, levels=lv)
            ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, levels=lv)
            require(torch.equal(got, ref),
                    f"B1 != plain at {sh['name']} M={m} K={k} N={n} "
                    f"levels={lv}")
        err = max_err(got, ref)
        out = torch.zeros((m, n), dtype=torch.int32, device=dev) \
            if acc_mode else None
        ms = time_ms(lambda: kernel.l2r_gemm_stacked_planes(sa, sb, out=out))
        plain_ms = time_ms(
            lambda: kernel.l2r_gemm_stacked_planes_plain(sa, sb, out=out),
            iters=3, warmup=1)
        lib, lib_fn, padded = int_mm(a, b)
        require(torch.equal(lib, kernel.l2r_gemm_stacked_planes(sa, sb)),
                f"torch._int_mm disagrees with B1 at {sh['name']}")
        d = 4  # planes of the main path's config (n=8, radix 4)
        # at full depth the function is aq @ bq (mod 2^32): 2*M*N*K int8
        # operations, however many plane products the kernel runs
        bound_ms, by = bound(
            2 * m * n * k,
            m * d * k + d * k * n + m * n * 4 * (2 if acc_mode else 1))
        row = {**sh, "ms": ms, "plain_ms": plain_ms,
               "library_ms": time_ms(lib_fn), "bound_ms": bound_ms,
               "bound_by": by, "max_abs_err": err, "int_mm_padded": padded}
        rows.append(row)
        print("phase 2b: " + json.dumps(row), flush=True)
    print(f"phase 2b: B1 == plain (bit for bit) at all {len(rows)} VGG-16 "
          f"shapes, levels None and 3", flush=True)
    return rows


def phase_streaming(dev) -> list[dict]:
    """Kernel B2 against its plain version: every plane, the dynamic
    level count (planes below it equal the full run), out= accumulation;
    then every VGG-16 GEMM shape, timed."""
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(2)
    checked = 0
    for (m, k, n) in RAGGED + [(8, 4096, 1000)]:
        for n_bits, log2_radix in RAGGED_CONFIGS:
            n_lv = 2 * (n_bits // log2_radix) - 1
            a, b = operands(g, dev, m, k, n, n_bits)
            sa = stack_planes_lhs(a, n_bits, log2_radix)
            sb = stack_planes_rhs(b, n_bits, log2_radix)
            for lv in LEVELS:
                got = kernel.l2r_gemm_streaming_planes(sa, sb, n_bits,
                                                       log2_radix, lv)
                ref = kernel.l2r_gemm_streaming_planes_plain(
                    sa, sb, n_bits, log2_radix, lv)
                require(torch.equal(got, ref),
                        f"B2 != plain at M={m} K={k} N={n} n_bits={n_bits} "
                        f"log2_radix={log2_radix} levels={lv}")
                checked += 1
            full = kernel.l2r_gemm_streaming_planes_plain(sa, sb, n_bits,
                                                          log2_radix)
            for cnt in (1, 3, n_lv):
                got = kernel.l2r_gemm_streaming_planes(
                    sa, sb, n_bits, log2_radix, level_count=torch.full(
                        (1,), cnt, dtype=torch.int32, device=dev))
                require(torch.equal(got[:cnt], full[:cnt]),
                        f"B2 level_count={cnt} wrong at M={m} K={k} N={n}")
                checked += 1
            acc = torch.full(full.shape, -5, dtype=torch.int32, device=dev)
            kernel.l2r_gemm_streaming_planes(sa, sb, n_bits, log2_radix,
                                             out=acc)
            require(torch.equal(acc, full - 5),
                    f"B2 out= accumulation wrong at M={m} K={k} N={n}")
    print(f"phase 2c: B2 == plain (bit for bit) on {checked} ragged cases, "
          f"levels {LEVELS}, level_count 1/3/L, out=, configs "
          f"{RAGGED_CONFIGS}", flush=True)

    rows = []
    for sh in main_path_shapes():
        m, k, n, acc_mode = sh["m"], sh["k"], sh["n"], sh["accumulate"]
        a, b = operands(g, dev, m, k, n, 8)
        sa, sb = stack_planes_lhs(a), stack_planes_rhs(b)
        got = kernel.l2r_gemm_streaming_planes(sa, sb)
        ref = kernel.l2r_gemm_streaming_planes_plain(sa, sb)
        require(torch.equal(got, ref),
                f"B2 != plain at {sh['name']} M={m} K={k} N={n}")
        err = max_err(got, ref)
        del got, ref
        out = torch.zeros((N_LEVELS, m, n), dtype=torch.int32, device=dev) \
            if acc_mode else None
        ms = time_ms(lambda: kernel.l2r_gemm_streaming_planes(sa, sb,
                                                              out=out))
        plain_ms = time_ms(
            lambda: kernel.l2r_gemm_streaming_planes_plain(sa, sb, out=out),
            iters=3, warmup=1)
        lib, lib_fn, padded = int_mm(a, b)
        require(torch.equal(lib, kernel.l2r_gemm_stacked_planes(sa, sb)),
                f"torch._int_mm disagrees with the final plane at "
                f"{sh['name']}")
        d = 4
        # each plane is a different sum of pair products: the D^2 of
        # them, 2*M*N*K int8 operations each
        bound_ms, by = bound(
            2 * m * n * k * d * d,
            m * d * k + d * k * n
            + N_LEVELS * m * n * 4 * (2 if acc_mode else 1))
        row = {**sh, "ms": ms, "plain_ms": plain_ms,
               "library_ms": time_ms(lib_fn), "bound_ms": bound_ms,
               "bound_by": by, "max_abs_err": err, "int_mm_padded": padded}
        rows.append(row)
        print("phase 2d: " + json.dumps(row), flush=True)
        del out
    print(f"phase 2d: B2 == plain (bit for bit, all {N_LEVELS} planes) at "
          f"all {len(rows)} VGG-16 shapes; library_ms is torch._int_mm on "
          f"the unstacked operands, the yardstick of the final plane only",
          flush=True)
    return rows


def phase_pairs(dev) -> list[dict]:
    """Kernel B3 against its plain version: ragged shapes and levels, then
    every VGG-16 GEMM shape, timed."""
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(3)
    checked = 0
    for (m, k, n) in RAGGED:
        for n_bits, log2_radix in RAGGED_CONFIGS:
            a, b = operands(g, dev, m, k, n, n_bits)
            for lv in LEVELS:
                got = kernel.l2r_gemm_pairs(a, b, n_bits, log2_radix, lv)
                ref = kernel.l2r_gemm_pairs_plain(a, b, n_bits, log2_radix,
                                                  lv)
                require(torch.equal(got, ref),
                        f"B3 != plain at M={m} K={k} N={n} n_bits={n_bits} "
                        f"log2_radix={log2_radix} levels={lv}")
                checked += 1
    print(f"phase 2e: B3 == plain (bit for bit) on {checked} ragged cases, "
          f"levels {LEVELS}, configs {RAGGED_CONFIGS}", flush=True)

    rows = []
    for sh in main_path_shapes():
        m, k, n = sh["m"], sh["k"], sh["n"]
        a, b = operands(g, dev, m, k, n, 8)
        for lv in (None, 3):
            got = kernel.l2r_gemm_pairs(a, b, levels=lv)
            ref = kernel.l2r_gemm_pairs_plain(a, b, levels=lv)
            require(torch.equal(got, ref),
                    f"B3 != plain at {sh['name']} M={m} K={k} N={n} "
                    f"levels={lv}")
        err = max_err(got, ref)
        ms = time_ms(lambda: kernel.l2r_gemm_pairs(a, b))
        plain_ms = time_ms(lambda: kernel.l2r_gemm_pairs_plain(a, b),
                           iters=3, warmup=1)
        lib, lib_fn, padded = int_mm(a, b)
        require(torch.equal(lib, kernel.l2r_gemm_pairs(a, b)),
                f"torch._int_mm disagrees with B3 at {sh['name']}")
        # the timed call runs every pair: the function is aq @ bq (mod
        # 2^32), so it needs 2*M*N*K int8 operations, not the D^2 pair
        # products the kernel runs
        bound_ms, by = bound(2 * m * n * k, m * k + k * n + m * n * 4)
        row = {**sh, "accumulate": False, "ms": ms, "plain_ms": plain_ms,
               "library_ms": time_ms(lib_fn), "bound_ms": bound_ms,
               "bound_by": by, "max_abs_err": err, "int_mm_padded": padded}
        rows.append(row)
        print("phase 2f: " + json.dumps(row), flush=True)
    print(f"phase 2f: B3 == plain (bit for bit) at all {len(rows)} VGG-16 "
          f"shapes, levels None and 3", flush=True)
    return rows


_WALK = (re.compile(r"walk_kernel<\d+, ?\d+, ?\d+, ?(?:true|false), ?(\d)>"),
         re.compile(r"walk_kernelILi\d+ELi\d+ELi\d+ELb[01]ELi(\d)E"))


def kernel_id(name: str) -> str | None:
    """B1/B2/B3 for a profiler kernel name of the level-walk template
    (mode 0/1/2), None for any other kernel."""
    for pat in _WALK:
        hit = pat.search(name)
        if hit:
            return ("B1", "B2", "B3")[int(hit.group(1))]
    return None


def profile_forward(fn) -> dict:
    """Device time of one forward by kernel (torch.profiler, CUDA
    activity): each hand-written kernel's share, the other kernels, and
    the idle share of the forward's wall time.  Zero device time is
    reported as not measured."""
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
    ours: dict[str, float] = {}
    for k, v in by_name.items():
        kid = kernel_id(k)
        if kid:
            ours[f"{kid}_ms"] = ours.get(f"{kid}_ms", 0.0) + v
    top = sorted(((v, k) for k, v in by_name.items() if not kernel_id(k)),
                 reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_ms": busy, **ours,
            "other_ms": busy - sum(ours.values()),
            "idle_share": max(0.0, 1 - busy / wall_ms),
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

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [vgg16_apply(params, x, l2r=cfg, weights_q=weights_q, device=dev)
              for x in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    require(launches == {"l2r_stacked_gemm": 120 * len(batches),
                         "l2r_streaming_gemm": 0, "l2r_pairs_gemm": 0},
            f"launches {launches} for {len(batches)} forwards, expected "
            f"{120 * len(batches)} of B1 and no other")
    for lg in logits:
        require(lg.shape == (BATCH, 1000) and bool(torch.isfinite(lg).all()),
                "non-finite or misshapen logits")

    timed = [host_ms(lambda: vgg16_apply(params, x, l2r=cfg,
                                         weights_q=weights_q, device=dev))
             / 1e3 for x in batches]
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
    out = {"launches": launches["l2r_stacked_gemm"],
           "first_3_forwards_s": wall, "forward_s": timed,
           "images_per_s": BATCH / statistics.median(timed),
           "quantize_weights_s": quant_s, "top1_agreement_vs_float":
           top1.item(), "plain_gemm_forward_bit_identical": True,
           "profile": prof}
    print("phase 3: " + json.dumps(out), flush=True)
    return {**out, "params": params, "weights_q": weights_q,
            "batches": batches, "logits": logits, "cfg": cfg}


def idle_sync_ms(dev, iters: int = 50) -> float:
    """Median host time of ``bool()`` of a 0-d bool tensor just written
    by a kernel, with nothing else queued: the floor of one done-flag
    read.  In the forward a read also waits for all the work queued
    before it."""
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        flag = ~flag
        t0 = time.perf_counter()
        bool(flag)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def head_scan_logits(params, x, cfg, weights_q, levels: int):
    """The fc8 head's logits after ``levels`` levels of the scan, on the
    same trunk as ``vgg16_classify_progressive``."""
    from repro_torch.core.progressive import streaming_argmax
    from repro_torch.core.quant import quantize
    from repro_torch.device import no_tf32
    from repro_torch.kernels.l2r_gemm.ops import CUDA_WALK
    from repro_torch.models.cnn import _vgg16_trunk

    with torch.no_grad(), no_tf32():
        f, _ = _vgg16_trunk(params, x, cfg, None, weights_q)
        xq, xs = quantize(f, cfg, axis=0 if cfg.per_channel else None)
        w_q = weights_q["fc8"]
        logits, _, _ = streaming_argmax(
            xq, w_q.q, xs, w_q.scale, cfg.n_bits, cfg.log2_radix, levels,
            bias=params["fc8"]["b"], out_dtype=f.dtype, cuda_walk=CUDA_WALK)
    return logits


def phase_progressive(dev, vgg: dict) -> dict:
    """vgg16_classify_progressive at full width, scan and early exit."""
    from repro_torch.models.cnn import vgg16_classify_progressive

    params, weights_q, cfg = vgg["params"], vgg["weights_q"], vgg["cfg"]
    batches, ref_logits = vgg["batches"], vgg["logits"]
    run = {}
    for early_exit in (False, True):
        reset_counts()
        outs = [vgg16_classify_progressive(params, x, cfg, weights_q,
                                           early_exit=early_exit, device=dev)
                for x in batches]
        torch.cuda.synchronize()
        run[early_exit] = (outs, counts())
    (scan, n_scan), (early, n_early) = run[False], run[True]
    b = len(batches)
    require(n_scan == {"l2r_stacked_gemm": 119 * b, "l2r_streaming_gemm": b,
                       "l2r_pairs_gemm": 0},
            f"scan launches {n_scan}, expected 119 B1 + 1 B2 per forward")
    levels_run = [int(lv.max()) + 1 for _, lv, _ in scan]
    require(n_early == {"l2r_stacked_gemm": 119 * b + sum(levels_run),
                        "l2r_streaming_gemm": 0, "l2r_pairs_gemm": 0},
            f"early-exit launches {n_early}, expected 119 B1 per forward "
            f"plus one per level run {levels_run}")
    for (p_s, lv_s, lg_s), (p_e, lv_e, lg_e), ref in zip(scan, early,
                                                         ref_logits):
        require(torch.equal(p_s, ref.argmax(-1).to(torch.int32)),
                "progressive class != argmax(vgg16_apply)")
        require(torch.equal(lg_s, ref),
                "scan logits differ from vgg16_apply's")
        require(torch.equal(p_s, p_e) and torch.equal(lv_s, lv_e),
                "classes or exit levels differ between scan and while")
        require(bool(torch.isfinite(lg_e).all()), "non-finite logits")
    for x, (_, lv_e, lg_e), (_, _, lg_s) in zip(batches, early, scan):
        # the while loop's logits are the dequantized prefix after the
        # levels it ran: the scan's at full depth, else a scan truncated
        # there
        lr = int(lv_e.max()) + 1
        want = lg_s if lr == N_LEVELS else head_scan_logits(
            params, x, cfg, weights_q, lr)
        require(torch.equal(lg_e, want),
                f"early-exit logits differ from the scan's prefix after "
                f"{lr} levels")
    lv_all = torch.cat([lv for _, lv, _ in scan]).cpu()
    hist = torch.bincount(lv_all.to(torch.int64), minlength=N_LEVELS).tolist()
    out = {"launches_scan": n_scan, "launches_early_exit": n_early,
           "levels_run_early_exit": levels_run, "exit_level_hist": hist,
           "mean_exit_level": lv_all.double().mean().item(),
           "pred_equals_argmax_vgg16_apply": True,
           "scan_logits_bit_identical_to_vgg16_apply": True,
           "early_exit_logits_bit_identical_to_scan_prefix": True}
    for early_exit, key in ((False, "scan"), (True, "early_exit")):
        timed = [host_ms(lambda: vgg16_classify_progressive(
            params, x, cfg, weights_q, early_exit=early_exit, device=dev))
            for x in batches]
        out[f"{key}_forward_ms"] = timed
        out[f"{key}_images_per_s"] = BATCH / statistics.median(timed) * 1e3
        out[f"{key}_profile"] = profile_forward(
            lambda: vgg16_classify_progressive(
                params, batches[0], cfg, weights_q, early_exit=early_exit,
                device=dev))
    # the loop reads the flag before each level and stops on the first
    # True read: derived from the levels run, not counted
    out["done_polls_per_forward_derived"] = [
        lr + 1 if lr < N_LEVELS else N_LEVELS for lr in levels_run]
    out["idle_queue_sync_ms"] = idle_sync_ms(dev)
    print("phase 4: " + json.dumps(out), flush=True)
    return out


def phase_pairs_path(dev, vgg: dict) -> dict:
    """The FC head (fc6-fc8) through l2r_matmul_f(schedule="pairs"): 3 B3
    launches per forward, bit-identical to the stacked schedule."""
    from repro_torch.kernels.l2r_gemm.ops import l2r_matmul_f

    params, weights_q, cfg = vgg["params"], vgg["weights_q"], vgg["cfg"]
    gi = torch.Generator(device=dev).manual_seed(4)
    feats = [torch.relu(torch.randn((BATCH, 25088), generator=gi,
                                    device=dev)) for _ in range(3)]

    def head(x, schedule):
        for name in ("fc6", "fc7", "fc8"):
            x = l2r_matmul_f(x, None, cfg, w_q=weights_q[name],
                             schedule=schedule) + params[name]["b"]
            x = torch.relu(x) if name != "fc8" else x
        return x

    reset_counts()
    got = [head(x, "pairs") for x in feats]
    torch.cuda.synchronize()
    n = counts()
    require(n == {"l2r_stacked_gemm": 0, "l2r_streaming_gemm": 0,
                  "l2r_pairs_gemm": 3 * len(feats)},
            f"pairs-path launches {n}, expected 3 B3 per forward")
    for x, lg in zip(feats, got):
        require(torch.equal(lg, head(x, "stacked")),
                "pairs-schedule head != stacked-schedule head")
        require(bool(torch.isfinite(lg).all()), "non-finite head logits")
    out = {"launches": n, "head_ms_pairs": statistics.median(
               host_ms(lambda: head(x, "pairs")) for x in feats),
           "head_ms_stacked": statistics.median(
               host_ms(lambda: head(x, "stacked")) for x in feats),
           "bit_identical_to_stacked": True}
    print("phase 5: " + json.dumps(out), flush=True)
    return out


def phase_protohead(dev) -> dict:
    from repro_torch.core.progressive import streaming_argmax
    from repro_torch.kernels.l2r_gemm.ops import CUDA_WALK
    from repro_torch.models.protohead import prototype_head

    xq, xs, w_q, labels = prototype_head(np.random.default_rng(44), k=4096,
                                         classes=1000, rows=256, device=dev)
    res = {}
    for early_exit in (False, True):
        reset_counts()
        res[early_exit] = (streaming_argmax(xq, w_q.q, xs, w_q.scale,
                                            early_exit=early_exit,
                                            cuda_walk=CUDA_WALK), counts())
    (lg_s, tok_s, lv_s), n_s = res[False]
    (_, tok_e, lv_e), n_e = res[True]
    require(torch.equal(tok_s, tok_e) and torch.equal(lv_s, lv_e),
            "prototype head: scan and while disagree")
    require(torch.equal(tok_s, lg_s.argmax(-1).to(torch.int32)),
            "prototype head: committed class != argmax of the logits")
    out = {"launches_scan": n_s, "launches_early_exit": n_e,
           "levels_run": int(lv_e.max()) + 1,
           "mean_exit_level": lv_s.double().mean().item(),
           "exit_level_hist": torch.bincount(
               lv_s.cpu().to(torch.int64), minlength=N_LEVELS).tolist(),
           "accuracy_vs_labels": (tok_s.cpu().numpy() == labels).mean()
           .item(),
           "scan_ms": time_ms(lambda: streaming_argmax(
               xq, w_q.q, xs, w_q.scale, cuda_walk=CUDA_WALK), iters=5),
           "early_exit_ms": time_ms(lambda: streaming_argmax(
               xq, w_q.q, xs, w_q.scale, early_exit=True,
               cuda_walk=CUDA_WALK), iters=5)}
    print("phase 6: " + json.dumps(out), flush=True)
    return out


def phase_conv_progressive(dev, vgg: dict) -> dict:
    from repro_torch.core.progressive import level_bounds
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.l2r_gemm import ops

    cfg, weights_q = vgg["cfg"], vgg["weights_q"]
    gi = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, hw, cin in (("conv1_2", 224, 64), ("conv4_2", 28, 512)):
        x = torch.relu(torch.randn((BATCH, hw, hw, cin), generator=gi,
                                   device=dev))
        w_q = weights_q[name]
        reset_counts()
        res, scale = ops.l2r_conv2d_progressive(x, w_q=w_q, cfg=cfg)
        torch.cuda.synchronize()
        n = counts()
        require(n == {"l2r_stacked_gemm": 0, "l2r_streaming_gemm": 9,
                      "l2r_pairs_gemm": 0},
                f"{name}: progressive conv launches {n}, expected 9 B2")
        xq, _ = quantize(x, cfg, axis=0)
        w_in = ops._conv_w_in(w_q, cfg)
        last = res.partial[-1].to(torch.int64)
        exact = level_bounds(cfg.planes, cfg.log2_radix, 9 * cin).exact
        for lv in range(N_LEVELS):
            ref = ops._l2r_conv2d_int(xq, w_in, cfg.n_bits, cfg.log2_radix,
                                      lv + 1)
            require(torch.equal(res.partial[lv], ref),
                    f"{name}: plane {lv} != conv at levels={lv + 1}")
            gap = (res.partial[lv].to(torch.int64) - last).abs().max().item()
            require(gap <= exact[lv],
                    f"{name}: plane {lv} is {gap} from the last, tail "
                    f"bound {exact[lv]}")
        del last, ref
        ms = host_ms(lambda: ops.l2r_conv2d_progressive(x, w_q=w_q, cfg=cfg))
        out[name] = {"launches": n, "planes_match_levels": True,
                     "tail_bounds_hold": True, "ms": ms,
                     "shape": list(res.partial.shape)}
        del res, scale
        torch.cuda.empty_cache()
    print("phase 7: " + json.dumps(out), flush=True)
    return out


def kernel_entry(lib: str, rows: list[dict], launches: int, per: str,
                 weight=lambda r: r["count"], **extra) -> dict:
    """The JSON record of one kernel: times per run of its main path (the
    per-shape medians weighted by the launches per run)."""
    kid, replaces = KERNELS[lib]
    tot = lambda key: sum(r[key] * weight(r) for r in rows)  # noqa: E731
    ops_ms = sum(r["bound_ms"] * weight(r) for r in rows
                 if r["bound_by"] == "operations")
    return {"name": lib, "id": kid, "route": "cuda",
            "source": f"{CSRC}/{lib}.cu", "replaces": replaces,
            "checked": True, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if ops_ms >= tot("bound_ms") / 2
            else "bytes",
            "library_ms": tot("library_ms"), "per": per, **extra,
            "shapes": rows}


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
                    print(f"phase 1: ptxas {lib.stem}: {line.strip()}",
                          flush=True)

    b1_rows = phase_kernel(dev)
    b2_rows = phase_streaming(dev)
    b3_rows = phase_pairs(dev)
    vgg = phase_vgg(dev)
    prog = phase_progressive(dev, vgg)
    pairs = phase_pairs_path(dev, vgg)
    phase_protohead(dev)
    phase_conv_progressive(dev, vgg)

    fc8 = lambda r: 1 if r["name"] == "fc8" else 0  # noqa: E731
    fc = lambda r: 1 if r["name"] in ("fc6", "fc7", "fc8") else 0  # noqa
    print(json.dumps({"kernels": [
        kernel_entry("l2r_stacked_gemm", b1_rows, vgg["launches"],
                     f"one vgg16_apply forward at batch {BATCH} (sum over "
                     f"its 120 launches of the per-shape medians); launches "
                     f"over the 3 forwards of phase 3",
                     images_per_s=vgg["images_per_s"]),
        kernel_entry("l2r_streaming_gemm", b2_rows,
                     prog["launches_scan"]["l2r_streaming_gemm"],
                     f"one vgg16_classify_progressive scan forward at batch "
                     f"{BATCH} (its one launch, the fc8 head); launches over "
                     f"the 3 forwards of phase 4", weight=fc8,
                     images_per_s=prog["scan_images_per_s"]),
        kernel_entry("l2r_pairs_gemm", b3_rows,
                     pairs["launches"]["l2r_pairs_gemm"],
                     f"one pair-schedule FC head (fc6-fc8) at batch {BATCH} "
                     f"(its 3 launches); launches over the 3 heads of "
                     f"phase 5", weight=fc),
    ]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
