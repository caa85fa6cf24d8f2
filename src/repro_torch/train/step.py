"""Training step factory: loss, grads, AdamW, remat, microbatch
accumulation, optional int8 error-feedback grad compression.

The port of ``repro/train/step.py``.  The step is eager and functional:
it returns new params and optimizer state and leaves its inputs
untouched.  Memory discipline as in the reference:

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

**Data parallel** (``mesh=``).  Every rank calls the step with the same
params, state and global batch and gets the same results.  A rank
computes the loss on its rows of the batch (``batch_spec``) with the
global token count as the divisor, the gradients are summed over the
data group (the leaves of a ``moe_dp_local`` layer, which each rank
computes for its own token group, over the whole mesh) as one flat
bucket a dtype, and the optimizer state is ZeRO-1 (optim/adamw.py:Zero1,
the EF residual too).  Ranks of one model group compute the same rows,
so the backbone and its gradients are replicated over ``model``: a
deviation from the reference, whose ``param_specs`` split the params
over ``model`` (ROADMAP A13c, with the sequence sharding that
``_resid_shard_fn`` only checks here).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import no_tf32
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import encdec_build, encdec_forward
from repro_torch.models.transformer import lm_build, lm_forward
from repro_torch.optim.adamw import (AdamWConfig, OptState, Zero1,
                                     adamw_update)
from repro_torch.optim.compression import EFState, ef_compress_grads
from repro_torch.sharding import ctx
from repro_torch.sharding.axes import (P, batch_rows, batch_spec,
                                       param_specs, zero1_specs)
from repro_torch.sharding.collectives import all_reduce, all_reduce_many

__all__ = ["TrainConfig", "make_loss_fn", "make_train_step", "chunked_xent",
           "value_and_grad", "make_grad_fn", "train_step_shardings",
           "zero1_layout"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: bool = True
    seq_shard: bool = True  # checked under a mesh; sharding is A13c
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
                 labels: torch.Tensor, chunk: int = 512, z_loss: float = 0.0,
                 n_tokens: int | None = None):
    """Mean token cross-entropy without materializing full logits.

    hidden: (B, S, d); w_out: (d, V); labels: (B, S) int32.  Chunks of
    S in order, each chunk's f32 logits recomputed in the backward
    (``torch.utils.checkpoint``), so peak memory ~ (B, chunk, V).
    Returns (mean loss, accuracy), f32 scalars: sums over these tokens
    divided by ``n_tokens`` (default B * S; a data rank passes the
    global count).
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
    n = b * s if n_tokens is None else n_tokens
    return total / n, correct.to(torch.float32) / n


def _batch_size(batch: dict) -> int:
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]) \
        .shape[0]


def _resid_shard_fn(mesh, tcfg: TrainConfig, batch_size: int):
    """The reference's residual-stream constraint (sequence over
    "model", batch per ``batch_spec``): here it checks the operand's rank
    against that spec and returns it (sharding/ctx.py:constrain); the
    sequence sharding itself is ROADMAP A13c."""
    if mesh is None or not tcfg.seq_shard or "model" not in mesh.axis_names:
        return lambda x: x
    bspec = batch_spec(mesh, batch_size)[0]
    return lambda x: ctx.constrain(x, mesh, bspec, "model", None)


def _rows(mesh, batch: dict):
    """(rows axes, this rank's rows of ``batch``): the batch dim split
    over ``batch_spec``'s axes (sharding/axes.py:batch_rows;
    ``rope_positions``'s dim 1); (None, batch) where it is not split."""
    axes, r0, n = batch_rows(mesh, _batch_size(batch))
    if axes is None:
        return None, batch
    return axes, {k: v.narrow(1 if k == "rope_positions" else 0, r0, n)
                  for k, v in batch.items()}


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """loss_fn(params, batch) -> (loss, metrics). Handles all families.

    With ``mesh`` the loss is this rank's part (its rows' cross-entropy
    over the global token count, plus the global aux loss): the sum of
    its gradients over the data group is the global gradient.  The
    metrics are global (summed over the data group)."""

    def loss_fn(params, batch):
        bsz = _batch_size(batch)
        resid = _resid_shard_fn(mesh, tcfg, bsz)
        n_tokens = bsz * batch["labels"].shape[1]
        rows, scope = None, contextlib.nullcontext()
        if mesh is not None:
            rows, batch = _rows(mesh, batch)
            scope = ctx.row_shard(mesh, rows)
        with scope:
            if cfg.family == "encdec":
                hidden, _, aux = encdec_forward(
                    cfg, params, tokens=batch["tokens"],
                    frames=batch["frames"], mode="train", remat=tcfg.remat)
                w_out = params["embed"].T
            else:
                hidden, _, aux = lm_forward(
                    cfg, params, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"),
                    rope_positions=batch.get("rope_positions"),
                    mode="train", remat=tcfg.remat)
                w_out = params["embed"].T if cfg.tie_embeddings \
                    else params["head"]
        xent, acc = chunked_xent(resid(hidden), w_out, batch["labels"],
                                 tcfg.xent_chunk, tcfg.z_loss, n_tokens)
        loss = xent + aux
        metrics = {"loss": xent, "aux": aux, "accuracy": acc}
        if rows is not None:
            tot = all_reduce(torch.stack([xent, acc]).detach(), "sum",
                             mesh.group(rows))
            metrics.update(loss=tot[0], accuracy=tot[1])
        return loss, metrics

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


def _moe_leaves(tree, inside: bool = False):
    """A tree like ``tree`` whose leaves say whether they belong to a MoE
    layer (a dict holding a ``router``)."""
    if isinstance(tree, dict):
        inside = inside or "router" in tree
        return {k: _moe_leaves(v, inside) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_moe_leaves(v, inside) for v in tree)
    return inside


def _reduce_grads(cfg: ModelConfig, mesh, grads: list, params, batch: dict):
    """The gradients (leaves) summed over the ranks that split the work:
    the data group that splits the rows; the whole mesh for the leaves of
    a ``moe_dp_local`` layer routed in per-rank groups (each rank then
    holds its own group's part); one flat bucket a dtype per group."""
    rows = _rows(mesh, batch)[0]
    tokens = batch["tokens"] if "tokens" in batch else batch["embeds"]
    dp_local = cfg.moe_dp_local and cfg.n_experts and mesh.size > 1 \
        and (tokens.shape[0] * tokens.shape[1]) % mesh.size == 0
    moe = tree_leaves(_moe_leaves(params)) if dp_local \
        else [False] * len(grads)
    out = list(grads)
    for flag, axes in ((False, rows), (True, mesh.axis_names)):
        idx = [i for i, m in enumerate(moe) if m == flag]
        if idx and axes is not None:
            for i, g in zip(idx, all_reduce_many([grads[i] for i in idx],
                                                 "sum", mesh.group(axes))):
                out[i] = g
    return out


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig, mesh=None) -> Callable:
    """(params, batch) -> (loss, metrics, grads): the step's loss and
    metrics and the gradients the optimizer takes (microbatches
    accumulated in f32 and averaged; with ``mesh`` summed over the
    ranks, whole and the same on every rank)."""
    loss_fn = make_loss_fn(cfg, tcfg, mesh)

    def one(params, batch):
        loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        if mesh is not None:
            loss = metrics["loss"] + metrics["aux"]
        return loss, metrics, tree_leaves(grads)

    def grad_fn(params, batch):
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
                    mloss, _, g = one(params, mb)
                    grads = [a + b.to(torch.float32)
                             for a, b in zip(grads, g)]
                    loss = loss + mloss
                if mesh is not None:
                    grads = _reduce_grads(cfg, mesh, grads, params, mb)
                grads = [g / n for g in grads]
                loss = loss / n
                zero = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
                metrics = {"loss": loss, "aux": zero, "accuracy": zero}
            else:
                loss, metrics, grads = one(params, batch)
                if mesh is not None:
                    grads = _reduce_grads(cfg, mesh, grads, params, batch)
        return loss, metrics, tree_unflatten(params, grads)

    return grad_fn


def _check_mesh(mesh) -> None:
    if not hasattr(mesh, "axis_names") or "data" not in mesh.axis_names:
        raise ValueError(f"make_train_step(mesh={mesh!r}): a mesh with a "
                         f"'data' axis (launch/mesh.py:make_local_mesh)")
    if getattr(mesh, "rank", None) is None:
        raise ValueError(f"make_train_step(mesh={mesh!r}): a mesh of shapes "
                         f"only has no ranks to train on; build it on a "
                         f"process group (launch/mesh.py:make_local_mesh)")


def zero1_layout(cfg: ModelConfig, mesh) -> Zero1:
    """The ZeRO-1 layout of ``cfg``'s params over ``mesh``: what
    ``adamw_init(params, zero)`` and ``ef_init(params, zero)`` take for a
    mesh step."""
    return Zero1.build(encdec_build(cfg) if cfg.family == "encdec"
                       else lm_build(cfg), mesh)


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    tcfg: TrainConfig = TrainConfig(), mesh=None) -> Callable:
    """(params, opt_state, batch[, ef_state]) -> (params, opt_state[, ef],
    metrics).

    Microbatching: the global batch is split on the leading axis and
    grads are accumulated in f32 from zeros, in microbatch order, before
    one optimizer step.  With ``mesh`` (a mesh on a process group, every
    rank calling with the same arguments) the step is data parallel: the
    optimizer state and the EF residual are ZeRO-1 slices
    (:func:`zero1_layout`; ``adamw_init(params, zero)``), the params whole
    on every rank.
    """
    zero = None
    if mesh is not None:
        _check_mesh(mesh)
        zero = zero1_layout(cfg, mesh)
    grad_fn = make_grad_fn(cfg, tcfg, mesh)

    def train_step(params, opt_state, batch, ef_state=None):
        _, metrics, grads = grad_fn(params, batch)
        with no_tf32():
            if tcfg.ef_compression:
                assert ef_state is not None
                grads, ef_state = ef_compress_grads(grads, ef_state, zero)
            params, opt_state, om = adamw_update(ocfg, grads, params,
                                                 opt_state, zero)
        metrics = {**metrics, **om}
        if tcfg.ef_compression:
            return params, opt_state, ef_state, metrics
        return params, opt_state, metrics

    return train_step


def train_step_shardings(cfg: ModelConfig, mesh, desc_tree,
                         batch_shapes: dict, ef: bool = False):
    """The reference's (in, out) spec trees of the sharded step
    (sharding/axes.py:P leaves where the reference wraps them in
    NamedShardings): params per ``param_specs``, the optimizer state
    (and EF residual) per ``zero1_specs``, the batch per ``batch_spec``,
    metrics replicated."""
    pspecs = param_specs(desc_tree, mesh)
    ospecs = OptState(step=P(), m=zero1_specs(desc_tree, mesh),
                      v=zero1_specs(desc_tree, mesh))
    bsz = next(iter(batch_shapes.values())).shape[0]
    bspec = {}
    for k, v in batch_shapes.items():
        if k == "rope_positions":  # (3, B, S)
            bspec[k] = P(None, batch_spec(mesh, v.shape[1])[0], None)
        else:
            bspec[k] = P(*batch_spec(mesh, bsz),
                         *([None] * (len(v.shape) - 2)))
    metrics_spec = {k: P() for k in
                    ("loss", "aux", "accuracy", "grad_norm", "lr")}
    ins = (pspecs, ospecs, bspec)
    outs = (pspecs, ospecs, metrics_spec)
    if ef:
        efspec = EFState(residual=zero1_specs(desc_tree, mesh))
        ins = ins + (efspec,)
        outs = (pspecs, ospecs, efspec, metrics_spec)
    return ins, outs
