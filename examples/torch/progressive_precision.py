"""Progressive precision end to end on the PyTorch port: the streaming
early-exit subsystem.

    python examples/torch/progressive_precision.py [--device cuda|cpu]

The hardware's MSDF property means the most significant digits of every
output arrive first; any consumer whose decision depends on an argmax can
commit as soon as the top-1 margin exceeds the hard bound on the unseen
digit tail.  This demo walks the consumers the streaming emitter
(core/progressive.py; kernel B2 on the card) feeds:

  1. a classifier head reading the raw logit stream,
  2. the fused conv emitting per-level feature-map prefixes with a
     shrinking error envelope (l2r_conv2d_progressive),
  3. greedy LM decoding that commits each token at its earliest sound
     level (progressive serving): tokens bit-identical to the full
     evaluation, levels saved for free,
  4. the early-exit walk: the same level walk that STOPS once every row
     has decided (one host read of the done flag a level), so the saved
     levels are measured on the wall clock.

Runs on the card unless ``--device cpu``.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.progressive import (earliest_decision_level,  # noqa
                                          progressive_matmul,
                                          streaming_argmax)
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.l2r_gemm.ops import (CUDA_WALK,  # noqa: E402
                                              l2r_conv2d_progressive)
from repro_torch.models.common import materialize  # noqa: E402
from repro_torch.models.protohead import prototype_head  # noqa: E402
from repro_torch.models.transformer import lm_build  # noqa: E402
from repro_torch.serve.batching import ContinuousBatcher, Request  # noqa
from repro_torch.serve.engine import greedy_generate  # noqa: E402


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    print("== classifier head on the raw MSDF stream ==")
    for (rows, k, classes) in [(512, 64, 16), (256, 256, 100)]:
        a = rng.integers(-128, 128, (rows, k), dtype=np.int8)
        b = rng.integers(-128, 128, (k, classes), dtype=np.int8)
        res = progressive_matmul(torch.from_numpy(a).to(dev),
                                 torch.from_numpy(b).to(dev),
                                 cuda_walk=CUDA_WALK)
        lv = earliest_decision_level(res).cpu().numpy()
        full = res.partial.shape[0]
        early = lv < full - 1
        print(f"K={k:4d} classes={classes:4d}: mean exit level "
              f"{lv.mean() + 1:.2f}/{full} | {early.mean() * 100:4.0f}% exit "
              f"early | histogram {np.bincount(lv, minlength=full).tolist()}")

    print("\n== fused conv: per-level prefix stream + error envelope ==")
    cfg = QuantConfig()
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 8))
                         .astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((3, 3, 8, 16)) * 0.2)
                         .astype(np.float32)).to(dev)
    res, _ = l2r_conv2d_progressive(x, w, cfg)
    exact = res.partial[-1].cpu().numpy().astype(np.int64)
    for t in range(res.partial.shape[0]):
        err = np.abs(res.partial[t].cpu().numpy().astype(np.int64)
                     - exact).max()
        bound = float(res.tail_bound[t])
        print(f"  level {t + 1}/{res.partial.shape[0]}: max |tail| = "
              f"{err:>8d}  (hard bound {bound:>12.0f})")
        assert err <= bound
    print("  each level is bit-identical to l2r_conv2d(levels=t+1); a"
          " downstream online consumer may start on the MS digits "
          "immediately")

    print("\n== progressive greedy decode (streamed LM head) ==")
    lm_cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    params = materialize(lm_build(lm_cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = [rng.integers(0, lm_cfg.vocab, (6,)).astype(np.int32)
               for _ in range(3)]
    eng = ContinuousBatcher(lm_cfg, params, n_slots=2, max_len=32,
                            progressive=True, device=dev)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=100)
    stats = eng.stats()
    print(f"  decoded {stats['tokens']} tokens | mean exit level "
          f"{stats['mean_exit_level']:.2f}/{stats['n_levels'] - 1} | "
          f"mean levels saved {stats['mean_levels_saved']:.2f}")
    print(f"  exit-level histogram: {stats['exit_level_hist']}")
    ref = greedy_generate(lm_cfg, params,
                          torch.from_numpy(prompts[0][None]).to(dev),
                          steps=5, max_len=32)[0].tolist()
    print(f"  request 0 tokens {reqs[0].output} == full-precision greedy "
          f"{ref}: {reqs[0].output == ref}")
    assert reqs[0].output == ref
    print(f"  prefill exit levels (streamed LAST-prompt-token head): "
          f"{[r.prefill_exit_level for r in reqs]}")
    print("  (the early exits change how many levels were computed, never "
          "the tokens)")

    print("\n== early-exit walk: saved levels as saved wall-clock ==")
    qc = QuantConfig()
    xq, xs, w_q, _ = prototype_head(rng, k=2048, classes=64, rows=256,
                                    cfg=qc, device=dev)

    def scan():
        return streaming_argmax(xq, w_q.q, xs, w_q.scale,
                                cuda_walk=CUDA_WALK)[1:]

    def walk():
        return streaming_argmax(xq, w_q.q, xs, w_q.scale, early_exit=True,
                                cuda_walk=CUDA_WALK)[1:]

    def bench(f, n=20):
        f()  # warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        _sync(dev)
        return (time.perf_counter() - t0) / n * 1e6

    tok_s, lv_s = scan()
    tok_w, lv_w = walk()
    assert torch.equal(tok_s, tok_w) and torch.equal(lv_s, lv_w)
    us_scan, us_walk = bench(scan), bench(walk)
    n_lv = 2 * qc.planes - 1
    print(f"  batch exit level {int(lv_w.max())}/{n_lv - 1} "
          f"(mean {float(lv_w.float().mean()):.2f})")
    print(f"  fixed scan {us_scan:8.1f} us | early-exit walk "
          f"{us_walk:8.1f} us | saved {100 * (1 - us_walk / us_scan):.0f}%")
    print("  (tokens and exit levels bit-identical: only the control flow "
          "changed)")


if __name__ == "__main__":
    main()
