"""Serving launcher: batched greedy decoding, optionally on the L2R path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--batch 4] [--prompt-len 16] [--steps 12] \
        [--l2r | --l2r-levels 5] [--device cuda|cpu]

The port of ``repro/launch/serve.py``'s static-batch loop.  ``--l2r``
serves every matmul through the L2R digit-plane GEMM at full depth (kernel
B1 on the card) against the load-time weight cache; ``--l2r-levels L``
truncates the MSDF stream after L levels.  Weights are random, drawn
from seed 0; prompts from numpy seed 0.  ``--device`` defaults to
``cuda`` and raises on a host without it.  Times are host clock around
work that ends in a ``torch.cuda.synchronize()`` on the card.
``--gateway`` and ``--wq`` (the request-queue gateway and the int8
checkpoint record) are ROADMAP A11 and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.quant import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import materialize
from repro_torch.models.transformer import lm_build
from repro_torch.serve.engine import (make_decode_step, make_prefill_step,
                                      prepare_params)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--l2r", action="store_true",
                    help="L2R digit-plane arithmetic at full depth")
    ap.add_argument("--l2r-levels", type=int, default=None,
                    help="progressive-precision MSDF levels (implies --l2r)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--wq", action="store_true", help="int8 weight storage")
    ap.add_argument("--gateway", action="store_true",
                    help="serve through the request-queue gateway")
    args = ap.parse_args(argv)
    if args.gateway or args.wq:
        raise NotImplementedError(
            "--gateway and --wq (the request-queue gateway and the int8 "
            "checkpoint record) are not in the port yet (ROADMAP A11)")

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise NotImplementedError("encoder-decoder serving is not in the "
                                  "port yet (ROADMAP A10)")
    if args.l2r or args.l2r_levels is not None:
        cfg = dataclasses.replace(cfg, l2r=QuantConfig(),
                                  l2r_levels=args.l2r_levels)
    desc = lm_build(cfg)
    params = materialize(desc, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    # the L2R weight cache: quantized once at load (identity without l2r)
    params = prepare_params(cfg, params, desc)

    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.steps
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
        .astype(np.int32)).to(dev)
    prefill = make_prefill_step(cfg, max_len, cache_dtype=torch.float32)
    decode = make_decode_step(cfg)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        state, logits = prefill(params, {"tokens": prompt})
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.steps - 1):
            state, tok, _ = decode(params, state, tok)
            out.append(tok)
        _sync(dev)
        t_decode = (time.perf_counter() - t0) / max(args.steps - 1, 1)
    seqs = torch.cat(out, dim=1).cpu().numpy()
    print(f"{cfg.name} on {dev}: prefill {args.batch}x{args.prompt_len}: "
          f"{t_prefill * 1e3:.1f} ms (first call); decode: "
          f"{t_decode * 1e3:.2f} ms/token, "
          f"{args.batch / t_decode:.1f} tokens/s")
    for i, row in enumerate(seqs):
        print(f"seq{i}: {row.tolist()}")
    return seqs


if __name__ == "__main__":
    main()
