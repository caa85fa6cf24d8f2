"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --global-batch 8 --seq-len 128 --smoke \
        [--ckpt-dir DIR] [--ef-compression] [--microbatch N] \
        [--device cuda|cpu]

The port of ``repro/launch/train.py``, one process on one device: the
config registry, the sharded data pipeline (one shard), the train step
(remat, optional int8 EF gradient compression, microbatching), AdamW,
async checkpointing with auto-resume and the fault-tolerance supervisor
(straggler policy + checkpoint/restart).  Weights are random, drawn from
seed 0.  ``--device`` defaults to ``cuda`` and raises on a host without
it; on the card every attention the kernel fits runs kernel B5.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig, ShardedPipeline
from repro_torch.device import resolve_device
from repro_torch.models.common import materialize
from repro_torch.models.encdec import encdec_build
from repro_torch.models.transformer import lm_build
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compression import ef_init
from repro_torch.runtime.fault import FaultTolerantLoop, StragglerPolicy
from repro_torch.train.step import TrainConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ef-compression", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    build = encdec_build if cfg.family == "encdec" else lm_build
    desc = build(cfg)
    params = materialize(desc, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt = adamw_init(params)
    efs = ef_init(params) if args.ef_compression else None

    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)
    tcfg = TrainConfig(remat=True, seq_shard=False,
                       xent_chunk=min(args.seq_len, 512),
                       microbatch=args.microbatch,
                       ef_compression=args.ef_compression)
    step_fn = make_train_step(cfg, ocfg, tcfg)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    pipe = ShardedPipeline(dcfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None:
        got = mgr.restore_latest({"params": params, "opt": opt}, dev)
        if got[0] is not None:
            start_step, trees = got
            params, opt = trees["params"], trees["opt"]
            pipe.load_state_dict(mgr.manifest(start_step)["data"])
            print(f"[resume] restored step {start_step}")

    st = {"params": params, "opt": opt, "ef": efs}

    def wrapped_step(state, batch):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if cfg.family == "encdec":
            b["frames"] = torch.zeros(
                (b["tokens"].shape[0], cfg.encoder_seq, cfg.d_model),
                dtype=torch.float32, device=dev)
        if cfg.embeds_input and "tokens" in b and cfg.family != "encdec":
            rng = np.random.default_rng(0)
            b["embeds"] = torch.from_numpy(rng.standard_normal(
                (b["tokens"].shape[0], b["tokens"].shape[1], cfg.d_model))
                .astype(np.float32)).to(dev)
            del b["tokens"]
        if tcfg.ef_compression:
            p2, o2, e2, m = step_fn(state["params"], state["opt"], b,
                                    state["ef"])
            return {"params": p2, "opt": o2, "ef": e2}, m
        p2, o2, m = step_fn(state["params"], state["opt"], b)
        return {"params": p2, "opt": o2, "ef": None}, m

    def save_fn(step, state):
        if mgr is not None:
            mgr.save(step, {"params": state["params"], "opt": state["opt"]},
                     extra={"data": pipe.state_dict()})

    def restore_fn():
        if mgr is None:
            return None, None
        got = mgr.restore_latest({"params": params, "opt": opt}, dev)
        if got[0] is None:
            return None, None
        return got[0], {"params": got[1]["params"], "opt": got[1]["opt"],
                        "ef": efs}

    loop = FaultTolerantLoop(wrapped_step, save_fn, restore_fn, pipe,
                             ckpt_every=args.ckpt_every,
                             straggler=StragglerPolicy())

    t0 = time.time()
    losses = []

    orig_step = loop.step_fn

    def logging_step(state, batch):
        state, m = orig_step(state, batch)
        losses.append(float(m["loss"]))
        n = len(losses)
        if n % args.log_every == 0:
            dt = (time.time() - t0) / n
            print(f"step {n + start_step}: loss={losses[-1]:.4f} "
                  f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                  f"{dt*1e3:.0f} ms/step")
        return state, m

    loop.step_fn = logging_step
    st, history = loop.run(st, args.steps, start_step=start_step)
    if mgr is not None:
        save_fn(args.steps, st)
        mgr.wait()
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
          f"({len(losses)} steps, {time.time()-t0:.1f}s)")
    return losses


if __name__ == "__main__":
    main()
