"""Per-request precision classes on the PyTorch port: one mixed batch,
three SLAs.

    python examples/torch/precision_policies.py [--device cuda|cpu]

The policy layer (core/policy.py) makes the streaming walks' early-exit
decision a PER-ROW one: each request carries a `PrecisionClass`:

  * ``exact``        run the full digit stream (reference quality);
  * ``budget(L)``    clamp at level L (latency SLA; tokens identical to
                     a ``levels=L`` truncated run);
  * ``bounded(eps)`` early-exit once the argmax margin beats the scaled
                     tail bound by eps (``bounded(0)`` is the plain
                     early-exit walk, bit for bit);

packed into a `LevelPolicy` and folded inside ONE level walk.  This demo
shows:

  1. the raw head walk serving a mixed batch, each row committing at its
     own class's level;
  2. a mixed-class batch through the `ContinuousBatcher` (precision on
     `Request`), with per-class exit-level histograms in `stats()`;
  3. the offline calibration loop: the port's `stats()` fed unchanged to
     tools/calibrate_levels.py (numpy only, loaded by path), which fits a
     `budget(L)` from the bounded class's observed exit histogram.

Runs on the card unless ``--device cpu``.
"""

import argparse
import dataclasses
import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.policy import LevelPolicy, PrecisionClass  # noqa
from repro_torch.core.progressive import streaming_argmax  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.l2r_gemm.ops import CUDA_WALK  # noqa: E402
from repro_torch.models.common import materialize  # noqa: E402
from repro_torch.models.protohead import prototype_head  # noqa: E402
from repro_torch.models.transformer import lm_build  # noqa: E402
from repro_torch.serve.batching import ContinuousBatcher, Request  # noqa
from repro_torch.serve.engine import prepare_params  # noqa: E402

CALIBRATE = os.path.join(os.path.dirname(__file__), "..", "..", "tools",
                         "calibrate_levels.py")


def calibrator():
    """tools/calibrate_levels.py, loaded by path (numpy only)."""
    spec = importlib.util.spec_from_file_location("calibrate_levels",
                                                  CALIBRATE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    qc = QuantConfig()
    n_levels = 2 * qc.planes - 1

    print("== one level walk, three precision classes ==")
    xq, xs, w_q, _ = prototype_head(rng, 256, 32, 9, cfg=qc, device=dev)
    classes = [PrecisionClass.exact(), PrecisionClass.budget(3),
               PrecisionClass.bounded()] * 3
    pol = LevelPolicy.from_classes(classes, device=dev)
    _, tok, lv = streaming_argmax(xq, w_q.q, xs, w_q.scale, qc.n_bits,
                                  qc.log2_radix, early_exit=True, policy=pol,
                                  cuda_walk=CUDA_WALK)
    _, tok_full, _ = streaming_argmax(xq, w_q.q, xs, w_q.scale, qc.n_bits,
                                      qc.log2_radix, cuda_walk=CUDA_WALK)
    tok, tok_full, lv = tok.cpu().numpy(), tok_full.cpu().numpy(), \
        lv.cpu().numpy()
    for c in classes[:3]:
        rows = [j for j in range(len(classes))
                if classes[j].label() == c.label()]
        agree = np.mean(tok[rows] == tok_full[rows])
        print(f"  {c.label():<12} exit levels {lv[rows].tolist()}  "
              f"agreement vs exact {agree:.2f}")
    print(f"  (full depth = level {n_levels - 1}; budget(3) caps at 2; "
          f"bounded rows stop at their own margin)")

    print("\n== mixed-class batch through ContinuousBatcher ==")
    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    desc = lm_build(cfg)
    params = prepare_params(cfg, materialize(
        desc, torch.Generator(device=dev).manual_seed(0), device=dev), desc)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 7, 6)]
    eng = ContinuousBatcher(cfg, params, n_slots=3, max_len=48,
                            progressive=True, early_exit=True, device=dev)
    for i, (p, c) in enumerate(zip(prompts, [PrecisionClass.exact(),
                                             PrecisionClass.budget(3),
                                             PrecisionClass.bounded()])):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=8, precision=c))
    eng.run(max_steps=200)
    st = eng.stats()
    print(f"  served {st['tokens']} tokens over {st['n_levels']} levels, "
          f"mean exit level {st['mean_exit_level']:.2f}")
    for label, hist in st["exit_level_hist_by_class"].items():
        h = np.asarray(hist, np.float64)
        mean = (h * np.arange(h.size)).sum() / max(h.sum(), 1)
        print(f"  {label:<12} hist {np.asarray(hist).tolist()}  "
              f"mean exit {mean:.2f}")

    print("\n== calibration: bounded histogram -> fitted budget(L) ==")
    fits = calibrator().fit_class_budgets(st["exit_level_hist_by_class"],
                                          coverage=0.99)
    print(f"  fitted budgets @99% coverage: {fits}")
    bounded_fit = fits.get("bounded(0)", n_levels)
    print(f"  -> redeploy the bounded class as "
          f"PrecisionClass.budget({bounded_fit}): a static clamp that "
          f"reproduces 99% of its observed commits")
    return st


if __name__ == "__main__":
    main()
