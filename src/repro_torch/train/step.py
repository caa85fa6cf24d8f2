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

**On a mesh** (``mesh=``).  Every rank calls the step with the same
arguments and gets the global results.  A rank computes the loss on its
rows of the batch (``batch_spec``) with the global token count as the
divisor, and the optimizer state is ZeRO-1 (optim/adamw.py:Zero1, the EF
residual too).  The params are held as sharding/axes.py:held_layouts
says (``param_specs`` but for Mamba-2's head-aligned projection and the
RG-LRU's whole gate weights; sharding/axes.py:shard_params) and the
backbone is tensor-parallel over ``model`` (a ``ctx.model_shard``
scope: models/transformer.py, models/encdec.py), with the sequence of
the (decoder's) residual stream split over ``model`` between blocks
where it divides (``_resid_shard_fn``), and the cross-entropy
vocab-parallel over a split head.  The gradients are summed over the
data group, one flat bucket a dtype and group; a leaf replicated over
``model`` is also summed over the model group where each model rank
computed part of its gradient: the norms under sequence parallelism (the
decoder's, not the encoder's, whose stream is whole), the router and the
expert stacks of a ``moe_dp_local`` layer (each rank routes its own
token group). The leaves a split mixer holds whole and uses for its own
part (Mamba-2's B and C columns and per-head vectors, the RG-LRU's gate
weights) have their gradient summed over the model group in the backward
itself (sharding/collectives.py:copy_in, copy_in_columns).
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
                                       param_specs, params_split,
                                       splits_anything, zero1_specs)
from repro_torch.sharding.collectives import (all_reduce, all_reduce_many,
                                              copy_in, sum_forward)

__all__ = ["TrainConfig", "make_loss_fn", "make_train_step", "chunked_xent",
           "value_and_grad", "make_grad_fn", "train_step_shardings",
           "zero1_layout"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: bool = True
    seq_shard: bool = True  # the residual's sequence over "model" (mesh)
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


def _xent_chunk_split(h, w_out, labels, z_loss: float, group, index: int,
                      vocab: int):
    """:func:`_xent_chunk` over a vocab-split head: ``w_out`` this rank's
    ``V / m`` columns.  The row max is a MAX all-reduce; the sum of the
    exps and the gold logit (from its owner, zeros elsewhere) one summed
    pair (their gradient passes through: every rank takes the same loss
    on); argmax is (the max, the lowest index reaching it), a MIN
    all-reduce of the indices; ``h``'s gradient is summed over the model
    group (each rank's columns reach their part of it)."""
    h = copy_in(h, group)
    logits = torch.einsum("bcd,dv->bcv", h.to(torch.float32),
                          w_out.to(torch.float32))
    v_l = logits.shape[-1]
    off = index * v_l
    lmax, lidx = logits.detach().max(-1)
    gmax = all_reduce(lmax, "max", group)
    lab = labels.long()
    own = (lab >= off) & (lab < off + v_l)
    gold = torch.gather(logits, -1, torch.where(own, lab - off, 0)[..., None]
                        )[..., 0] * own
    sums = sum_forward(torch.stack([
        torch.exp(logits - gmax[..., None]).sum(-1), gold]), group)
    lse = gmax + torch.log(sums[0])
    loss = (lse - sums[1]).sum()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).sum()
    idx = torch.where(lmax == gmax, lidx + off, torch.full_like(lidx, vocab))
    arg = all_reduce(idx, "min", group)
    return loss, (arg == lab).sum(dtype=torch.int32)


def chunked_xent(hidden: torch.Tensor, w_out: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512, z_loss: float = 0.0,
                 n_tokens: int | None = None, vocab: int | None = None):
    """Mean token cross-entropy without materializing full logits.

    hidden: (B, S, d); w_out: (d, V); labels: (B, S) int32.  Chunks of
    S in order, each chunk's f32 logits recomputed in the backward
    (``torch.utils.checkpoint``), so peak memory ~ (B, chunk, V).
    Returns (mean loss, accuracy), f32 scalars: sums over these tokens
    divided by ``n_tokens`` (default B * S; a data rank passes the
    global count).  In a ``ctx.model_shard`` scope a ``w_out`` of fewer
    than ``vocab`` columns is this rank's vocabulary slice and the
    cross-entropy is vocab-parallel (:func:`_xent_chunk_split`).
    """
    split = ctx.model_split()
    if split is not None and vocab is not None and w_out.shape[-1] < vocab:
        fn = lambda h, w, lab, z: _xent_chunk_split(  # noqa: E731
            h, w, lab, z, split.group, split.index, vocab)
    else:
        fn = _xent_chunk
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, s, chunk):
        loss, corr = checkpoint(fn, hidden[:, c0:c0 + chunk], w_out,
                                labels[:, c0:c0 + chunk], z_loss,
                                use_reentrant=False)
        total = total + loss
        correct = correct + corr
    n = b * s if n_tokens is None else n_tokens
    return total / n, correct.to(torch.float32) / n


def _batch_size(batch: dict) -> int:
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]) \
        .shape[0]


def _resid_shard_fn(mesh, tcfg: TrainConfig, batch_size: int,
                    seq_len: int):
    """The reference's residual-stream constraint (sequence over
    "model", batch per ``batch_spec``): ``(check, seq)``, ``check`` the
    rank check of that spec (sharding/ctx.py:constrain) and ``seq``
    whether the sequence splits over "model" between blocks: where the
    model axis divides it (safe_axes's rule: else the sequence stays
    whole, as the reference's constraint then replicates it)."""
    if mesh is None or not tcfg.seq_shard or "model" not in mesh.axis_names:
        return (lambda x: x), False
    bspec = batch_spec(mesh, batch_size)[0]
    seq = ctx.safe_axes(mesh, (batch_size, seq_len), (bspec, "model"))[1]
    return (lambda x: ctx.constrain(x, mesh, bspec, "model", None)), \
        seq is not None and mesh.shape["model"] > 1


def _rows(mesh, batch: dict):
    """(rows axes, this rank's rows of ``batch``): the batch dim split
    over ``batch_spec``'s axes (sharding/axes.py:batch_rows;
    ``rope_positions``'s dim 1); (None, batch) where it is not split."""
    axes, r0, n = batch_rows(mesh, _batch_size(batch))
    if axes is None:
        return None, batch
    return axes, {k: v.narrow(1 if k == "rope_positions" else 0, r0, n)
                  for k, v in batch.items()}


def _tp(cfg: ModelConfig, mesh) -> bool:
    """Is ``cfg``'s backbone split over ``mesh``'s model axis?"""
    return splits_anything(cfg, mesh)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """loss_fn(params, batch) -> (loss, metrics). Handles all families.

    With ``mesh`` the loss is this rank's part (its rows' cross-entropy
    over the global token count, plus the global aux loss): the sum of
    its gradients over the data group is the global gradient.  The
    metrics are global (summed over the data group).  The attention
    families' params are this rank's ``param_specs`` slices, run in a
    ``ctx.model_shard`` scope (with ``seq`` per ``_resid_shard_fn``)."""

    def loss_fn(params, batch):
        bsz = _batch_size(batch)
        resid, seq = _resid_shard_fn(mesh, tcfg, bsz,
                                     batch["labels"].shape[1])
        n_tokens = bsz * batch["labels"].shape[1]
        rows, scope = None, contextlib.ExitStack()
        if mesh is not None:
            rows, batch = _rows(mesh, batch)
            scope.enter_context(ctx.row_shard(mesh, rows))
            if _tp(cfg, mesh):
                scope.enter_context(ctx.model_shard(mesh, seq))
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
                                     tcfg.xent_chunk, tcfg.z_loss, n_tokens,
                                     cfg.vocab)
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


def _leaf_flags(tree, pred, inside: bool = False):
    """A tree like ``tree`` whose leaves say whether they lie under a dict
    key for which ``pred(key, value)`` holds."""
    if isinstance(tree, dict):
        return {k: _leaf_flags(v, pred, inside or pred(k, v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaf_flags(v, pred, inside) for v in tree)
    return inside


def _reduce_grads(cfg: ModelConfig, mesh, grads: list, params, batch: dict,
                  seq: bool):
    """The gradients (leaves, held as the params are) summed over the
    ranks that computed parts of them, one flat bucket a dtype and group:
    the data group that splits the rows, and the model group too for a
    leaf the model ranks hold alike but computed apart: the norms under
    sequence parallelism (each rank normed its part of the sequence) and
    the leaves of a ``moe_dp_local`` layer held whole (each rank routed
    its own token group; an expert stack split over ``model`` is each
    rank's own)."""
    rows = _rows(mesh, batch)[0] or ()
    tokens = batch["tokens"] if "tokens" in batch else batch["embeds"]
    dp_local = cfg.moe_dp_local and cfg.n_experts and mesh.size > 1 \
        and (tokens.shape[0] * tokens.shape[1]) % mesh.size == 0
    moe = tree_leaves(_leaf_flags(params, lambda k, v: isinstance(v, dict)
                                  and "router" in v))
    norm = tree_leaves(_leaf_flags(params, lambda k, v: k.endswith("norm")))
    encoder = tree_leaves(_leaf_flags(params, lambda k, v: k.startswith(
        "enc_")))  # the encoder's stream is whole on every model rank
    desc = tree_leaves(encdec_build(cfg) if cfg.family == "encdec"
                       else lm_build(cfg))
    groups: dict = {}
    for i, (g, d) in enumerate(zip(grads, desc)):
        whole = tuple(g.shape) == tuple(d.shape)
        axes = set(rows)
        if whole and ((seq and norm[i] and not encoder[i])
                      or (dp_local and moe[i])):
            axes.add("model")
        groups.setdefault(tuple(a for a in mesh.axis_names if a in axes),
                          []).append(i)
    out = list(grads)
    for axes, idx in groups.items():
        if axes:
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

    def seq(batch) -> bool:
        return _tp(cfg, mesh) and _resid_shard_fn(
            mesh, tcfg, _batch_size(batch), batch["labels"].shape[1])[1]

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
                    grads = _reduce_grads(cfg, mesh, grads, params, mb,
                                          seq(mb))
                grads = [g / n for g in grads]
                loss = loss / n
                zero = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
                metrics = {"loss": loss, "aux": zero, "accuracy": zero}
            else:
                loss, metrics, grads = one(params, batch)
                if mesh is not None:
                    grads = _reduce_grads(cfg, mesh, grads, params, batch,
                                          seq(batch))
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
    mesh step (the params held as sharding/axes.py:held_layouts says where
    the layout splits anything, else whole)."""
    return Zero1.build(cfg, mesh, split=_tp(cfg, mesh))


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    tcfg: TrainConfig = TrainConfig(), mesh=None) -> Callable:
    """(params, opt_state, batch[, ef_state]) -> (params, opt_state[, ef],
    metrics).

    Microbatching: the global batch is split on the leading axis and
    grads are accumulated in f32 from zeros, in microbatch order, before
    one optimizer step.  With ``mesh`` (a mesh on a process group, every
    rank calling with the same arguments) the step runs on the mesh: the
    optimizer state and the EF residual are ZeRO-1 slices
    (:func:`zero1_layout`; ``adamw_init(params, zero)``); the params are
    this rank's slices (sharding/axes.py:shard_params) in and out where
    the layout splits anything over the model axis, else whole.
    """
    zero = None
    if mesh is not None:
        _check_mesh(mesh)
        zero = zero1_layout(cfg, mesh)
    grad_fn = make_grad_fn(cfg, tcfg, mesh)

    def train_step(params, opt_state, batch, ef_state=None):
        if mesh is not None and _tp(cfg, mesh) != params_split(cfg, params):
            raise ValueError(
                "make_train_step(mesh=): the params train split as "
                "sharding/axes.py:shard_params cuts them where the layout "
                "splits anything over the model axis, else whole")
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
