"""Margin-bounded progressive decode attention on the PyTorch port, end
to end.

    python examples/torch/progressive_attention.py [--device cuda|cpu]

QK^T runs digit-serial over the incrementally plane-stacked KV cache, and
the per-row score walk can STOP as soon as every row's running max and
softmax normalizer are decided within a scaled tail bound
(``attn_early_exit`` / ``attn_exit_tol`` on ModelConfig).  This demo
shows:

  1. how the exit level responds to score sharpness and tolerance:
     peaked score rows decide after a few significance levels, flat rows
     need the whole walk;
  2. per-layer exit-level histograms from a smoke-sized LM, collected
     with ``attn_exit_tap()`` during a decode step (the port runs
     eagerly: every call records);
  3. greedy decode token parity: early exit changes how many levels the
     walk runs, never the committed tokens.

The prefill's digit-serial attention runs kernel B4 on the card where it
fits.  Runs on the card unless ``--device cpu``.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.attention import (attn_exit_tap,  # noqa: E402
                                          decode_attention, init_kv_cache,
                                          update_kv_cache)
from repro_torch.models.common import materialize  # noqa: E402
from repro_torch.models.transformer import (init_lm_state,  # noqa: E402
                                            lm_build, lm_forward)
from repro_torch.serve.engine import greedy_generate  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    qc = QuantConfig()
    n_levels = 2 * qc.planes - 1

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    print("== exit level vs score sharpness (decode_attention) ==")
    b, length, kvh, g, dh = 4, 64, 2, 2, 64
    cache = init_kv_cache(b, length, kvh, dh, torch.float32, quant=qc,
                          device=dev)
    ks = t(rng.standard_normal((b, length, kvh, dh)))
    vs = t(rng.standard_normal((b, length, kvh, dh)))
    pos = torch.from_numpy(np.tile(np.arange(length), (b, 1))
                           .astype(np.int32)).to(dev)
    cache = update_kv_cache(cache, ks, vs, pos, quant=qc)
    qpos = torch.full((b,), length - 1, dtype=torch.int32, device=dev)
    for sharp, name in [(0.2, "flat scores "), (1.0, "typical     "),
                        (4.0, "peaked      ")]:
        q = t(rng.standard_normal((b, 1, kvh * g, dh)) * sharp)
        for tol in (1e-4, 1e-2):
            with attn_exit_tap() as rec:
                out = decode_attention(q, cache.k, cache.v, cache.positions,
                                       qpos, l2r=qc, k_planes=cache.k_planes,
                                       k_scale=cache.k_scale,
                                       early_exit=True, exit_tol=tol)
            full = decode_attention(q, cache.k, cache.v, cache.positions,
                                    qpos, l2r=qc, k_planes=cache.k_planes,
                                    k_scale=cache.k_scale)
            lv = np.asarray(rec[0]["exit_levels"]).ravel()
            err = float((out - full).abs().max())
            print(f"  {name} tol={tol:.0e}: walk ran "
                  f"{rec[0]['levels_run']}/{n_levels} levels | per-row exit "
                  f"histogram {np.bincount(lv, minlength=n_levels).tolist()}"
                  f" | max |out - full| {err:.2e}")

    print("\n== per-layer exit levels, smoke LM decode step ==")
    cfg = dataclasses.replace(get_smoke("smollm-135m"), attn_l2r=qc,
                              attn_early_exit=True, attn_exit_tol=1e-3)
    params = materialize(lm_build(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8))
                              .astype(np.int32)).to(dev)
    with torch.no_grad():
        state = init_lm_state(cfg, 2, max_len=16, dtype=torch.float32,
                              device=dev)
        _, state, _ = lm_forward(cfg, params, tokens=prompt, mode="prefill",
                                 state=state)
        with attn_exit_tap() as rec:  # no disable_jit: the port is eager
            _, state, _ = lm_forward(cfg, params, tokens=prompt[:, -1:],
                                     mode="decode", state=state)
    print(f"  {len(rec)} attention calls recorded (one per attention layer)")
    assert len(rec) == cfg.n_layers
    for i, r in enumerate(rec):
        lv = np.asarray(r["exit_levels"]).ravel()
        print(f"  layer {i}: walk ran {r['levels_run']}/{n_levels} levels | "
              f"exit histogram "
              f"{np.bincount(lv, minlength=n_levels).tolist()}")

    print("\n== greedy token parity: early exit never changes tokens ==")
    cfg_q = dataclasses.replace(cfg, attn_early_exit=False)
    with torch.no_grad():
        out_q = greedy_generate(cfg_q, params, prompt, steps=6).tolist()
        out_e = greedy_generate(cfg, params, prompt, steps=6).tolist()
    print(f"  full-depth quantized tokens: {out_q}")
    print(f"  early-exit tokens:           {out_e}")
    print(f"  bit-identical: {out_q == out_e}")
    assert out_q == out_e


if __name__ == "__main__":
    main()
