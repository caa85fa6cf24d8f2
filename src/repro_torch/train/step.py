"""Training step factory: loss, grads, AdamW, remat, microbatch
accumulation, optional int8 error-feedback grad compression.

The port of ``repro/train/step.py`` without a mesh.  The step is eager
and functional: it returns new params and optimizer state and leaves
its inputs untouched.  Memory discipline as in the reference:

  * with ``remat`` each stacked block runs under
    ``torch.utils.checkpoint`` (one block's activations live);
  * cross-entropy is computed in sequence chunks, each under
    ``torch.utils.checkpoint``: the (tokens, vocab) logits are never
    materialized whole.

The whole step, forward and backward, runs with TF32 off
(``device.no_tf32``): true f32 products as the reference's CPU and TPU
f32 dots, and autograd's backward products and convolutions included.
Kernel B5 (B4 with ``attn_l2r``) runs every attention forward it fits on
the card, and the attention backward is the plain loop's gradient
(models/attention.py); everything else is plain torch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import no_tf32
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import encdec_forward
from repro_torch.models.transformer import lm_forward
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import ef_compress_grads

__all__ = ["TrainConfig", "make_loss_fn", "make_train_step", "chunked_xent",
           "value_and_grad"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: bool = True
    seq_shard: bool = True  # no mesh here: accepted and without effect
    xent_chunk: int = 512
    microbatch: int = 1  # gradient-accumulation splits of the global batch
    ef_compression: bool = False  # int8 error-feedback gradient compression
    z_loss: float = 1e-4  # logit normalizer regularizer (stability)


def _xent_chunk(h, w_out, labels, z_loss: float):
    logits = torch.einsum("bcd,dv->bcv", h.to(torch.float32),
                          w_out.to(torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (lse - gold).sum()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).sum()
    # argmax takes the first index of a tie, as jnp.argmax does
    correct = (logits.argmax(-1) == labels).sum(dtype=torch.int32)
    return loss, correct


def chunked_xent(hidden: torch.Tensor, w_out: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512, z_loss: float = 0.0):
    """Mean token cross-entropy without materializing full logits.

    hidden: (B, S, d); w_out: (d, V); labels: (B, S) int32.  Chunks of
    S in order, each chunk's f32 logits recomputed in the backward
    (``torch.utils.checkpoint``), so peak memory ~ (B, chunk, V).
    Returns (mean loss, accuracy), f32 scalars.
    """
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, s, chunk):
        loss, corr = checkpoint(_xent_chunk, hidden[:, c0:c0 + chunk], w_out,
                                labels[:, c0:c0 + chunk], z_loss,
                                use_reentrant=False)
        total = total + loss
        correct = correct + corr
    n = b * s
    return total / n, correct.to(torch.float32) / n


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (loss, metrics). Handles all families."""

    def loss_fn(params, batch):
        if cfg.family == "encdec":
            hidden, _, aux = encdec_forward(
                cfg, params, tokens=batch["tokens"], frames=batch["frames"],
                mode="train", remat=tcfg.remat)
            w_out = params["embed"].T
        else:
            hidden, _, aux = lm_forward(
                cfg, params, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"),
                rope_positions=batch.get("rope_positions"),
                mode="train", remat=tcfg.remat)
            w_out = params["embed"].T if cfg.tie_embeddings \
                else params["head"]
        xent, acc = chunked_xent(hidden, w_out, batch["labels"],
                                 tcfg.xent_chunk, tcfg.z_loss)
        loss = xent + aux
        return loss, {"loss": xent, "aux": aux, "accuracy": acc}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` on a tree of tensors:
    (loss, metrics, grads), detached, grads a tree like params with zeros
    where a leaf does not reach the loss (as ``jax.grad`` gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    tcfg: TrainConfig = TrainConfig(), mesh=None) -> Callable:
    """(params, opt_state, batch[, ef_state]) -> (params, opt_state[, ef],
    metrics).

    Microbatching: the global batch is split on the leading axis and
    grads are accumulated in f32 from zeros, in microbatch order, before
    one optimizer step.  ``mesh`` must be None: the sharded step is
    ROADMAP A13b.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): the sharded train step (sequence "
            "sharding, ZeRO-1) is not ported; it is ROADMAP A13b, the "
            "rest of the multi-device slice")
    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(params, opt_state, batch, ef_state=None):
        with no_tf32():
            if tcfg.microbatch > 1:
                n = tcfg.microbatch
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                         for p in tree_leaves(params)]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=grads[0].device)
                for i in range(n):
                    mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                          for k, v in batch.items()}
                    mloss, _, g = value_and_grad(loss_fn, params, mb)
                    grads = [a + b.to(torch.float32)
                             for a, b in zip(grads, tree_leaves(g))]
                    loss = loss + mloss
                grads = tree_unflatten(params, [g / n for g in grads])
                loss = loss / n
                zero = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
                metrics = {"loss": loss, "aux": zero, "accuracy": zero}
            else:
                _, metrics, grads = value_and_grad(loss_fn, params, batch)

            if tcfg.ef_compression:
                assert ef_state is not None
                grads, ef_state = ef_compress_grads(grads, ef_state)

            params, opt_state, om = adamw_update(ocfg, grads, params,
                                                 opt_state)
        metrics = {**metrics, **om}
        if tcfg.ef_compression:
            return params, opt_state, ef_state, metrics
        return params, opt_state, metrics

    return train_step
