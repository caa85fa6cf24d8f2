"""Batched serving with the L2R W8A8 weight format on the PyTorch port.

    python examples/torch/serve_decode.py [--device cuda|cpu]

Runs the same prompts through (a) f32 weights, (b) int8-stored weights
(the L2R serving format: exactly the integer arithmetic the composite
IPU streams MSDF; kernel B1 on the card) and (c) the digit-plane
progressive mode, comparing outputs; then serves progressively on a
2 x 2 mesh of four ranks (launch/mesh.py:spawn_local, gloo; on the card
the ranks share it) with tokens and stats equal to one process's.  Runs
on the card unless ``--device cpu``.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch.serve import main as serve_main  # noqa: E402

SMOKE = ["--arch", "smollm-135m", "--smoke", "--batch", "2",
         "--prompt-len", "12", "--steps", "8"]


def serve(device: str, mesh_shape) -> dict:
    """Progressive serving of three prompts through the batcher on
    ``device``, with ``mesh_shape`` (data, model) installed (this process
    one rank of it) or none: its stats.  Importable by path, so the ranks
    of spawn_local run it."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.mesh import install_local_mesh
    from repro_torch.models.common import materialize, tree_map
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.engine import prepare_params
    from repro_torch.sharding import ctx

    dev = torch.device(device)
    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    raw = tree_map(lambda t: t.to(dev), materialize(
        lm_build(cfg), torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (6,)).astype(np.int32)
               for _ in range(3)]
    ctx.set_mesh(None)
    try:
        if mesh_shape:
            install_local_mesh(*mesh_shape)
        eng = ContinuousBatcher(cfg, prepare_params(cfg, raw), n_slots=2,
                                max_len=24, progressive=True,
                                early_exit=True, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
        eng.run(max_steps=50)
        return eng.stats()
    finally:
        ctx.set_mesh(None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = ["--device", args.device]

    print("--- float weights ---")
    a = serve_main(SMOKE + dev)
    print("--- int8 (L2R W8A8) weights ---")
    b = serve_main(SMOKE + dev + ["--wq"])
    print("--- progressive MSDF (5/7 levels) ---")
    c = serve_main(SMOKE + dev + ["--l2r-levels", "5"])
    agree_q = (a == b).mean()
    agree_p = (a == c).mean()
    print(f"\ntoken agreement: int8 vs float {agree_q * 100:.0f}% | "
          f"progressive vs float {agree_p * 100:.0f}%")
    print("(random untrained weights -> near-uniform logits, so argmax is "
          "maximally quantization-sensitive)")

    # --- sharded serving: the same progressive engine on a mesh ---
    # Installing a mesh routes the stack onto its split paths: the LM
    # head's plane stack is split over "model" by vocabulary at load
    # (prepare_params) and the head streams as the consensus walk, whose
    # early exit stops at the slowest row: tokens, exit levels and stats
    # equal the one-process engine's.
    from repro_torch.launch.mesh import spawn_local

    print("--- sharded progressive serving (2 x 2 mesh, four gloo ranks) ---")
    single = serve(args.device, None)
    ranks = spawn_local(4, serve, args.device, (2, 2), deadline_s=600,
                        threads=1)
    for st in ranks:
        assert st == single, (st, single)
    print(f"sharded(2x2) == single process: tokens={single['tokens']} "
          f"mean_exit={single['mean_exit_level']:.2f}/"
          f"{single['n_levels'] - 1} stats identical on every rank")


if __name__ == "__main__":
    main()
