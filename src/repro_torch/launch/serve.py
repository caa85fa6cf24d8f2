"""Serving launcher: batched greedy decoding, optionally on the L2R path,
with int8 weights, or through the request-queue gateway.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--batch 4] [--prompt-len 16] [--steps 12] \
        [--l2r | --l2r-levels 5] [--wq] [--gateway] [--device cuda|cpu]

The port of ``repro/launch/serve.py``.  ``--l2r`` serves every matmul
through the L2R digit-plane GEMM at full depth (kernel B1 on the card)
against the load-time weight cache; ``--l2r-levels L`` truncates the
MSDF stream after L levels.  ``--wq`` (without an L2R config) stores the
matmul weights as int8 ``{"q", "scale"}`` records and serves them W8A8
(the same GEMM at full depth).  ``--gateway`` serves the prompts through
`serve.gateway.ServingGateway` (bucketed packed prefill, warmup, async
emit) instead of the static-batch loop: the ``--batch`` prompts become
queued requests, ``--batch`` also sizes the slot array, and with an L2R
config the gateway serves progressively with early exit (kernel B2 under
every streamed head scan).  Weights are random, drawn from seed 0;
prompts from numpy seed 0.  ``--device`` defaults to ``cuda`` and
raises on a host without it.  Times are host clock around work that
ends in a ``torch.cuda.synchronize()`` on the card.  LM families only, as
the reference: encoder-decoder serving goes through
``serve.engine``'s step factories with ``{"tokens", "frames"}`` batches.
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
from repro_torch.models.common import materialize, quantize_params
from repro_torch.models.transformer import lm_build
from repro_torch.serve.engine import (make_decode_step, make_prefill_step,
                                      prepare_params)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gateway(cfg, params, prompt: np.ndarray, steps: int, max_len: int,
             dev: torch.device) -> np.ndarray:
    from repro_torch.serve import Request, ServingGateway

    progressive = cfg.l2r is not None
    batch = prompt.shape[0]
    gw = ServingGateway(cfg, params, n_slots=batch, max_len=max_len,
                        progressive=progressive, early_exit=progressive,
                        prefill_group=min(batch, 4), device=dev)
    reqs = [Request(uid=i, prompt=prompt[i], max_new_tokens=steps)
            for i in range(batch)]
    gw.run(reqs)
    gw.close()
    st = gw.stats()
    print(f"gateway on {dev}: {st['tokens']} tokens in {st['steps']} decode "
          f"dispatches + {st['prefills']} prefill dispatches (buckets "
          f"{st['buckets']}); {st['tokens_per_s']:.1f} tok/s, ttft_p50 "
          f"{st['ttft_p50_s'] * 1e3:.1f} ms, tpot_p50 "
          f"{st['tpot_p50_s'] * 1e3:.1f} ms")
    seqs = np.asarray([r.output for r in reqs])
    for i, row in enumerate(seqs):
        print(f"seq{i}: {row.tolist()}")
    return seqs


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
                    help="serve through the request-queue gateway "
                         "(bucketed packed prefill, warmup, async emit) "
                         "instead of the static-batch loop")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    assert cfg.family not in ("encdec",), "use examples for enc-dec serving"
    if args.l2r or args.l2r_levels is not None:
        cfg = dataclasses.replace(cfg, l2r=QuantConfig(),
                                  l2r_levels=args.l2r_levels)
    desc = lm_build(cfg)
    params = materialize(desc, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    if cfg.l2r is not None:
        # the L2R weight cache: quantized once at load
        params = prepare_params(cfg, params, desc)
    elif args.wq:
        params = quantize_params(desc, params)

    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.steps
    prompt_np = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)) \
        .astype(np.int32)
    if args.gateway:
        return _gateway(cfg, params, prompt_np, args.steps, max_len, dev)
    prompt = torch.from_numpy(prompt_np).to(dev)
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
