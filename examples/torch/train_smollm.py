"""End-to-end training on the PyTorch port: train SmolLM-135M on
the structured synthetic stream.

    python examples/torch/train_smollm.py [--device cuda|cpu] [--full] [--steps 300] [--ckpt-dir DIR]

The default is the width-reduced config, so the loop runs quickly; --full
trains the real 135M-parameter configuration (the card's job).  Exercises
the real stack: data pipeline, remat train step (kernel B5 under every
attention forward on the card), AdamW, checkpointing with auto-resume,
the fault supervisor (launch/train.py).  Runs on the card unless
``--device cpu``.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the real 135M config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the checkpoints go (default: a new "
                         "temporary directory)")
    args = ap.parse_args(argv)

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="smollm_ckpt_")
    argv = ["--arch", "smollm-135m", "--steps", str(args.steps),
            "--global-batch", "8", "--seq-len", str(args.seq_len),
            "--ckpt-dir", ckpt, "--ckpt-every", "100",
            "--lr", "3e-3", "--log-every", "20", "--device", args.device]
    if not args.full:
        argv.append("--smoke")
    losses = train_main(argv)
    assert losses[-1] < losses[0], "training must reduce the loss"
    print(f"checkpoints in {ckpt}")
    return losses


if __name__ == "__main__":
    main()
