"""The serving gateway on the PyTorch port: bucketed packed prefill,
in-place decode, async emit.

    python examples/torch/serve_gateway.py [--device cuda|cpu]

A mixed-length request trace is served twice: through the plain
`ContinuousBatcher` and through `ServingGateway` (one prefill shape per
power-of-2 length bucket, packed multi-prompt prefill, the decode state
written in place, tokens drained by an async emit thread).  Output
streams are bit-identical; the gateway also reports throughput and
p50/p99 TTFT / per-token latency, and a second pass replays a Poisson
arrival trace in real time.  With the L2R config the streamed heads run
on kernel B2 and the level slabs of the early exit on B1 on the card.
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
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.common import materialize  # noqa: E402
from repro_torch.models.transformer import lm_build  # noqa: E402
from repro_torch.serve import (ContinuousBatcher, Request,  # noqa: E402
                               ServingGateway)
from repro_torch.serve.engine import prepare_params  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    params = prepare_params(cfg, materialize(
        lm_build(cfg), torch.Generator(device=dev).manual_seed(0),
        device=dev))
    rng = np.random.default_rng(0)
    lengths = [3, 5, 8, 11, 17, 23, 9, 14]  # spans the 8/16/32 buckets
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lengths]

    def make_requests():
        return [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    print("--- plain ContinuousBatcher (reference) ---")
    ref = make_requests()
    eng = ContinuousBatcher(cfg, params, n_slots=4, max_len=32,
                            progressive=True, early_exit=True, device=dev)
    for r in ref:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run(max_steps=1000)
    print(f"batcher: {eng.steps} decode steps, "
          f"{time.perf_counter() - t0:.2f}s wall")

    print("--- ServingGateway (offline drain) ---")
    served = make_requests()
    gw = ServingGateway(cfg, params, n_slots=4, max_len=32, prefill_group=4,
                        progressive=True, early_exit=True, device=dev)
    gw.run(served)
    gw.close()
    st = gw.stats()
    for a, b in zip(ref, served):
        assert a.output == b.output, (a.uid, a.output, b.output)
        assert a.exit_levels == b.exit_levels
    print(f"gateway: {st['tokens']} tokens in {st['steps']} decode "
          f"dispatches + {st['prefills']} packed prefills (buckets "
          f"{st['buckets']})")
    print(f"  {st['tokens_per_s']:.1f} tok/s | ttft p50/p99 "
          f"{st['ttft_p50_s'] * 1e3:.1f}/{st['ttft_p99_s'] * 1e3:.1f} ms | "
          f"tpot p50/p99 {st['tpot_p50_s'] * 1e3:.1f}/"
          f"{st['tpot_p99_s'] * 1e3:.1f} ms")
    print(f"  mean exit level {st['mean_exit_level']:.2f}/"
          f"{st['n_levels'] - 1} (saved {st['mean_levels_saved']:.2f} "
          f"levels/token)")
    print("  output streams bit-identical to the plain batcher")

    print("--- ServingGateway (real-time Poisson arrivals) ---")
    online = make_requests()
    gw2 = ServingGateway(cfg, params, n_slots=4, max_len=32,
                         prefill_group=4, progressive=True, early_exit=True,
                         device=dev)
    arrival = time.perf_counter() + 0.01
    for r in online:
        arrival += float(rng.exponential(0.03))
        r.t_arrival = arrival
        gw2.submit(r)
    gw2.run(realtime=True)
    gw2.close()
    st2 = gw2.stats()
    for a, b in zip(ref, online):
        assert a.output == b.output
    print(f"online: {st2['tokens_per_s']:.1f} tok/s | ttft p50 "
          f"{st2['ttft_p50_s'] * 1e3:.1f} ms (includes queueing) | "
          f"tokens still bit-identical")


if __name__ == "__main__":
    main()
