"""Serving engine: load-time weight preparation, the prefill and decode
step factories, bucketed prefill, the progressive LM head, batched
greedy decoding.

The port of ``repro/serve/engine.py``: LM families, and the
encoder-decoder family (``cfg.family == "encdec"``, whisper) whose
prefill batches hold ``{"tokens", "frames"}`` and whose decode steps
read the cross-attention K/V cached at prefill.  PyTorch runs eagerly,
so the factories return plain functions where the
reference returns functions to ``jax.jit``, and the serving state is
updated in place where the reference donates it: a decode step writes
the caches and ``pos`` into the tensors it was given and returns them.

Under a mesh (``mesh=``, else the installed one, sharding/ctx.py) every
rank runs the same steps on the whole batch with the backbone replicated,
and the progressive head streams as the consensus walk over the vocab
shard ``prepare_params(mesh=)`` keeps (core/progressive.py).  Given
params split over ``model`` (sharding/axes.py:shard_params, after
``prepare_params`` where the family serves prepared params) the steps run
the tensor-parallel backbone in a ``ctx.model_shard`` scope, and the
state they allocate is the rank's part (the reference's ``"specs"``
layout, :func:`state_specs` with ``kv_shard="heads"``, but where
:func:`local_state` says).  Called
within a ``ctx.row_shard`` scope (sharding/ctx.py; the rows
``sharding/axes.py:batch_rows`` gives) a step takes this rank's rows of
the global batch instead, and its state holds only those rows (the
reference's ``"batch"`` layout); the head's outputs are global all the
same.  :func:`state_specs` gives the reference's cache layouts.

``progressive=True`` streams the LM head most-significant level first
(:func:`progressive_logits_from_hidden`): on the card the scan is one
launch of kernel B2 over the load-time head cache, and ``early_exit``
one launch of kernel B1 per level walked.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.core.policy import LevelPolicy
from repro_torch.core.progressive import streaming_argmax
from repro_torch.core.quant import (QuantConfig, QuantizedWeights, quantize,
                                    quantize_weights)
from repro_torch.kernels.l2r_gemm.ops import CUDA_WALK
from repro_torch.models.attention import KVCache
from repro_torch.models.common import quantize_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import (EncDecState, encdec_forward,
                                       init_encdec_state)
from repro_torch.models.common import leading, out_width
from repro_torch.models.transformer import (LMState, init_lm_state,
                                            layer_slice, lm_build,
                                            lm_forward, logits_from_hidden)
from repro_torch.sharding import ctx
from repro_torch.sharding.axes import P, dp_axes, params_split
from repro_torch.sharding.collectives import all_gather

__all__ = ["prepare_params", "make_prefill_step", "make_decode_step",
           "make_bucket_prefill_step", "prefill_buckets", "bucket_for",
           "supports_bucketed_prefill", "progressive_logits_from_hidden",
           "state_specs", "greedy_generate", "split_scope",
           "split_collectives", "local_state", "abstract_state"]


# ------------------------------------------------------- weight preparation
def prepare_params(cfg: ModelConfig, params, desc=None, mesh=None):
    """Load-time serving weights: build the L2R weight cache ONCE.

    When ``cfg.l2r`` is set, every eligible matmul weight becomes a
    :class:`~repro_torch.core.quant.QuantizedWeights` record (int8 + per-
    out-channel scale) here, so the prefill and decode steps stream
    activations through the level-stacked digit-plane GEMM (kernel B1 on
    the card) with no per-step weight quantization.  Without an L2R
    config this is the identity.

    Every record also caches its reversed RHS plane stack in B1's
    operand format (pre-shifted, K-major:
    models/common.py:quantize_tree), so no step extracts, shifts or
    transposes a weight plane.  The LM head (the tied embedding's
    transpose, excluded from quantize_tree so lookups keep the float
    table) gets its own cache ``head_q``, window-padded as the
    reference's (2D-1 plane blocks): the stacked schedule and kernel B2
    (the progressive head) read its first D blocks in place, a view
    whose output-channel stride is (2D-1)·K.  Costs D x (the head 2D-1
    x) the int8 weight bytes.

    ``desc`` is the Param descriptor tree (for eligibility); defaults to
    ``lm_build(cfg)`` for LM families, and encdec callers pass
    ``encdec_build(cfg)``.  Eligibility is the reference's: every 2-D
    normal-init leaf, so the conv weights of ``ssd`` and ``rec`` mixers
    and whisper's position tables become records too, and the forward
    then fails on them, in both packages (ROADMAP, "Caveats on the
    reference"); those families serve raw params, each ``dense``
    quantizing its weight per call.

    ``mesh`` (default: the installed mesh, sharding/ctx.py) splits the
    head cache over the ``model`` axis by vocabulary: this rank keeps its
    contiguous K-major slice of the int8 head, its scales and its plane
    stack (core/quant.py:quantize_weights ``shard=``), the layout the
    consensus head walk reads.  The backbone's records stay whole here;
    sharding/axes.py:shard_params cuts them for a split backbone.
    """
    if cfg.l2r is None:
        return params
    if mesh is None:
        mesh = ctx.get_mesh()
    if desc is None:
        assert cfg.family != "encdec", "pass the encdec desc tree explicitly"
        desc = lm_build(cfg)
    out = quantize_tree(desc, params, cfg.l2r, prestack=True)
    head = out["embed"].T if cfg.tie_embeddings else out.get("head")
    if head is not None and not isinstance(head, QuantizedWeights):
        out = {**out, "head_q": quantize_weights(
            head, cfg.l2r, prestack=True, window_pad=True,
            plane_shifted=True, k_major=True,
            shard=(None, "model") if mesh is not None else None,
            mesh=mesh)}
    return out


# ------------------------------------------------------------- shardings
def _model_axis_for_cache(cfg: ModelConfig, mesh) -> tuple:
    """(kv_heads_axis, head_dim_axis) for KV caches."""
    m = mesh.shape.get("model", 1)
    if cfg.n_kv % m == 0:
        return ("model", None)
    if cfg.head_dim % m == 0:
        return (None, "model")
    return (None, None)


def _bspec(mesh, batch: int):
    axes = dp_axes(mesh)
    size = ctx.mesh_axis_size(mesh, axes)
    if batch % size == 0 and size > 1:
        return axes
    if batch % mesh.shape.get("data", 1) == 0:
        return "data"
    return None


def _add_layer(spec):
    """A unit layer's spec tree with the stacked (repeats,) axis first."""
    if isinstance(spec, P):
        return P(None, *spec)
    if isinstance(spec, dict):
        return {k: _add_layer(v) for k, v in spec.items()}
    return type(spec)(*(None if v is None else _add_layer(v) for v in spec))


def state_specs(cfg: ModelConfig, mesh, batch: int, max_len: int,
                kv_shard: str = "heads"):
    """The reference's spec tree of ``init_lm_state`` /
    ``init_encdec_state`` (sharding/axes.py:P leaves): batch over the DP
    axes when it divides; the model axis on kv-heads (or head_dim) with
    ``kv_shard="heads"``, on the cache's sequence dim with ``"seq"``; SSM
    and RG-LRU states on their channel dim."""
    b = _bspec(mesh, batch)
    kvh, hd = _model_axis_for_cache(cfg, mesh)
    m = mesh.shape.get("model", 1)

    def kv_spec():
        # the plane-stacked key cache's axis (2D-1)*dh is never sharded
        planes = cfg.attn_l2r is not None
        if kv_shard == "seq":
            return KVCache(
                k=P(b, "model", None, None), v=P(b, "model", None, None),
                positions=P(b, "model"),
                k_planes=P(b, "model", None, None) if planes else None,
                k_scale=P(b, "model", None) if planes else None)
        return KVCache(
            k=P(b, None, kvh, hd), v=P(b, None, kvh, hd),
            positions=P(b, None),
            k_planes=P(b, None, kvh, None) if planes else None,
            k_scale=P(b, None, kvh) if planes else None)

    def mixer_spec(kind: str):
        if kind in ("global", "local"):
            return kv_spec()
        if kind == "ssd":
            d_inner = cfg.ssm_expand * cfg.d_model
            conv_dim = d_inner + 2 * cfg.ssm_state
            heads = d_inner // cfg.ssm_head_dim
            return {
                "ssd": P(b, "model" if heads % m == 0 else None, None, None),
                "conv": P(b, None, "model" if conv_dim % m == 0 else None),
            }
        if kind == "rec":
            w = cfg.lru_width or cfg.d_model
            wa = "model" if w % m == 0 else None
            return {"h": P(b, wa), "conv": P(b, None, wa)}
        raise ValueError(kind)

    if cfg.family == "encdec":
        c = kv_spec()
        return EncDecState(
            self_cache=KVCache(k=P(None, *c.k), v=P(None, *c.v),
                               positions=P(None, *c.positions)),
            cross_k=P(None, b, None, kvh, hd),
            cross_v=P(None, b, None, kvh, hd),
            pos=P(b),
        )
    prefix, repeats, unit, suffix = cfg.block_grouping()
    return LMState(
        prefix=[mixer_spec(kk[0]) for kk in prefix],
        stack=([_add_layer(mixer_spec(kk[0])) for kk in unit]
               if repeats else None),
        suffix=[mixer_spec(kk[0]) for kk in suffix],
        pos=P(b),
    )


def abstract_state(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16):
    """The whole serving state on the ``meta`` device (shapes and
    dtypes, nothing allocated): the dry run's input, as the reference's
    ``jax.eval_shape`` of the state."""
    init = init_encdec_state if cfg.family == "encdec" else init_lm_state
    return init(cfg, batch, max_len, dtype, device="meta")


def local_state(cfg: ModelConfig, mesh, state):
    """This rank's part of a whole serving state (``init_lm_state`` /
    ``init_encdec_state``'s tree, one process's) as the ``"specs"`` layout
    holds it: its rows (sharding/axes.py:batch_rows) and, over "model",
    :func:`state_specs`' blocks but where the split mixers hold their
    state otherwise: in the head_dim layout the float keys stay whole
    (models/transformer.py:kv_layout), a Mamba-2 conv state is held as
    its conv weights are (models/ssm.py:held_columns),
    and an encoder-decoder's cross caches are whole where the model axis
    does not divide the kv heads.  Views; the tests and phase 21 hold a
    rank's state to it."""
    from repro_torch.models.rglru import rglru_channels
    from repro_torch.models.ssm import held_columns, ssm_heads
    from repro_torch.models.transformer import kv_layout
    from repro_torch.sharding.axes import batch_rows

    _, r0, n = batch_rows(mesh, state.pos.shape[0])
    rows = slice(r0, r0 + n)
    with ctx.model_shard(mesh):
        kv, kd, vd = kv_layout(cfg)
        split = ctx.model_split()
        j = split.index if split is not None else 0

        def kv_cache(c: KVCache, lead: int) -> KVCache:
            pre = (slice(None),) * lead + (rows,)
            heads = slice(j * kv, (j + 1) * kv) if kv < cfg.n_kv \
                else slice(None)
            val = slice(j * vd, (j + 1) * vd) if vd < kd else slice(None)
            return KVCache(
                k=c.k[pre + (slice(None), heads)],
                v=c.v[pre + (slice(None), heads, val)],
                positions=c.positions[pre],
                k_planes=None if c.k_planes is None
                else c.k_planes[pre + (slice(None), heads)],
                k_scale=None if c.k_scale is None
                else c.k_scale[pre + (slice(None), heads)])

        def mixer(c, kind: str, lead: int):
            pre = (slice(None),) * lead + (rows,)
            if kind in ("global", "local"):
                return kv_cache(c, lead)
            if kind == "ssd":
                h0, h1 = ssm_heads(cfg)
                conv = c["conv"][pre]
                held = split and held_columns(cfg, "conv", split.size)
                if held:
                    conv = conv[..., held[0](j).to(conv.device)]
                return {"ssd": c["ssd"][pre + (slice(h0, h1),)],
                        "conv": conv}
            c0, c1 = rglru_channels(cfg)
            return {"h": c["h"][pre + (slice(c0, c1),)],
                    "conv": c["conv"][pre + (slice(None), slice(c0, c1))]}

        if cfg.family == "encdec":
            cross = slice(j * kv, (j + 1) * kv) if kv < cfg.n_kv \
                and vd == kd else slice(None)
            return EncDecState(
                self_cache=kv_cache(state.self_cache, 1),
                cross_k=state.cross_k[:, rows, :, cross],
                cross_v=state.cross_v[:, rows, :, cross],
                pos=state.pos[rows])
        prefix, repeats, unit, suffix = cfg.block_grouping()
        return LMState(
            prefix=[mixer(c, kk[0], 0) for c, kk in zip(state.prefix,
                                                         prefix)],
            stack=[mixer(c, kk[0], 1) for c, kk in zip(state.stack, unit)]
            if repeats else None,
            suffix=[mixer(c, kk[0], 0) for c, kk in zip(state.suffix,
                                                         suffix)],
            pos=state.pos[rows])


# ------------------------------------------------------------ step factories
def split_scope(cfg: ModelConfig, params, mesh=None):
    """The scope a step runs ``params`` in: ``ctx.model_shard`` over
    ``mesh`` (else the installed one) when they are
    :func:`~repro_torch.sharding.axes.shard_params` slices, else none."""
    mesh = mesh if mesh is not None else ctx.get_mesh()
    if (mesh is not None and mesh.shape.get("model", 1) > 1
            and params_split(cfg, params)):
        return ctx.model_shard(mesh)
    return contextlib.nullcontext()


def _row_product(cfg: ModelConfig, w) -> int:
    """All-reduces of a row-parallel product (models/common.py:dense):
    with ``cfg.l2r`` the row's amax, a raw weight's column amax and the
    integer partials; without, the float sum."""
    if cfg.l2r is None:
        return 1
    return 2 if isinstance(w, QuantizedWeights) else 3


def _attn_collectives(cfg: ModelConfig, p: dict, mode: str,
                      names: str = "qkv") -> tuple[int, int]:
    """(all-reduces, all-gathers) of a split attention layer
    (models/transformer.py:attn_qkv, attn_out): on a rank's heads its
    ``wo``; else one all-gather a split projection of ``names``, one for
    decode's value slices in the head_dim layout, and ``wo``'s where its
    rows are split."""
    whole = cfg.n_heads * cfg.head_dim
    if out_width(p["wq"]) == whole:
        return 0, 0
    m = whole // out_width(p["wq"])
    per = _row_product(cfg, p["wo"])
    if cfg.n_kv % m == 0:
        return per, 0
    widths = {"q": whole, "k": cfg.n_kv * cfg.head_dim,
              "v": cfg.n_kv * cfg.head_dim}
    gather = sum(out_width(p["w" + n]) != widths[n] for n in names)
    if mode == "decode" and cfg.head_dim % m == 0 and "k" in names:
        gather += 1
    return (per if leading(p["wo"]) != whole else 0), gather


def _ffn_collectives(cfg: ModelConfig, p: dict, kind: str
                     ) -> tuple[int, int]:
    if kind == "moe":
        reduce = gather = 0
        if "shared_wo" in p and leading(p["shared_wo"]) != \
                (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts:
            reduce = _row_product(cfg, p["shared_wo"])
        if p["wo"].shape[0] != cfg.n_experts:
            gather = 1
        return reduce, gather
    d_ff = cfg.dense_d_ff if cfg.n_experts and cfg.dense_d_ff else cfg.d_ff
    return (_row_product(cfg, p["wo"]) if leading(p["wo"]) != d_ff
            else 0), 0


def _mixer_collectives(cfg: ModelConfig, p: dict, kind: str, mode: str
                       ) -> tuple[int, int]:
    if kind in ("global", "local"):
        return _attn_collectives(cfg, p, mode)
    width = cfg.ssm_expand * cfg.d_model if kind == "ssd" \
        else cfg.lru_width or cfg.d_model
    if leading(p["out_proj"]) == width:  # the mixer runs whole
        return 0, 0
    # out_proj row-parallel, and one all-gather: the gated norm's
    # partials (ssd) or the gates' input channels (rec)
    return _row_product(cfg, p["out_proj"]), 1


def split_collectives(cfg: ModelConfig, params, mode: str = "prefill"
                      ) -> dict[str, int]:
    """The collectives one forward (a prefill, or with ``mode="decode"``
    a decode step) of the split backbone makes beyond the head and its
    walk, the rows' split and the digit-serial decode walk's done flags,
    on ``params`` from sharding/axes.py:shard_params, read from the
    leaves' shapes: every row-parallel product (attention's ``wo``, the
    MLPs', the SSD's and RG-LRU's ``out_proj``) two all-reduces with
    ``cfg.l2r`` on a prepared weight (the row's amax and the integer
    partials, models/common.py:dense), three on a raw one (its columns'
    amax) and one without; an all-gather for a vocab-split embedding, one
    a MoE layer (its experts split), one a split SSD (the gated norm's
    partials) or RG-LRU (the gates' channels), and, where attention runs
    on whole heads, one a split projection (and a decode step's value
    slices in the head_dim layout).  A block that runs whole adds none;
    the encoder runs at the prefill only."""
    reduce = gather = 0

    def add(rg):
        nonlocal reduce, gather
        reduce, gather = reduce + rg[0], gather + rg[1]

    if cfg.family == "encdec":
        if mode != "decode":
            for i in range(cfg.encoder_layers):
                lp = layer_slice(params["enc_stack"], i)
                add(_attn_collectives(cfg, lp["attn"], mode))
                add(_ffn_collectives(cfg, lp["ffn"], "mlp"))
        for i in range(cfg.n_layers):
            lp = layer_slice(params["dec_stack"], i)
            add(_attn_collectives(cfg, lp["self"], mode))
            add(_attn_collectives(cfg, lp["cross"], mode,
                                  "q" if mode == "decode" else "qkv"))
            add(_ffn_collectives(cfg, lp["ffn"], "mlp"))
    else:
        prefix, repeats, unit, suffix = cfg.block_grouping()
        layers = [(params["prefix"][i], kk) for i, kk in enumerate(prefix)]
        layers += [(layer_slice(params["stack"][u], 0), kk)
                   for u, kk in enumerate(unit) for _ in range(repeats)]
        layers += [(params["suffix"][i], kk) for i, kk in enumerate(suffix)]
        for lp, (mixer, ffn) in layers:
            add(_mixer_collectives(cfg, lp["mixer"], mixer, mode))
            if ffn != "none":
                add(_ffn_collectives(cfg, lp["ffn"], ffn))
    if params["embed"].shape[0] != cfg.vocab:
        gather += 1
    return {"all_reduce": reduce, "all_gather": gather, "all_to_all": 0}


def _check_step_flags(progressive: bool, early_exit: bool,
                      policy: LevelPolicy | None = None) -> None:
    """Reject contradictory step-factory flag combinations: ``early_exit``
    and ``policy`` steer the streamed head's level walk, which exists
    only on the progressive path."""
    if early_exit and not progressive:
        raise ValueError(
            "contradictory arguments: early_exit=True requires "
            "progressive=True — early_exit stops the streamed head's "
            "level loop, which only exists on the progressive path "
            "(got progressive=False, early_exit=True)")
    if policy is not None and not progressive:
        raise ValueError(
            "contradictory arguments: policy requires progressive=True — "
            "LevelPolicy rows steer the streamed head's level walk, which "
            "only exists on the progressive path "
            "(got progressive=False with policy set)")


def _check_progressive(cfg: ModelConfig, progressive: bool) -> None:
    if progressive:
        assert cfg.family != "encdec", "progressive serving: LM families only"
        assert cfg.l2r is not None, \
            "progressive serving streams the quantized head: set cfg.l2r"


def _head(cfg: ModelConfig, params, hidden, progressive: bool,
          early_exit: bool, policy: LevelPolicy | None, mesh):
    """The LM head on ``hidden`` (B, 1, d): ``logits`` one-shot, or
    ``(logits, tok (B, 1) int32, exit_level (B, 1) int32)`` streamed;
    global rows when ``hidden`` holds this rank's (``ctx.row_axes()``)."""
    if not progressive:
        logits = logits_from_hidden(cfg, params, hidden)
        if ctx.row_axes():
            logits = all_gather(logits, ctx.get_mesh().group(ctx.row_axes()),
                                dim=0)
        return logits
    logits, tok, lv = progressive_logits_from_hidden(
        cfg, params, hidden, early_exit=early_exit, mesh=mesh,
        policy=policy)
    return logits, tok.to(torch.int32), lv


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      progressive: bool = False,
                      early_exit: bool = False,
                      mesh=None,
                      policy: LevelPolicy | None = None) -> Callable:
    """(params, batch[, policy]) -> (state, last_token_logits (B, 1, V)).

    ``batch`` holds ``tokens`` (B, S) int (or ``embeds``) and optionally
    ``rope_positions``; for the encdec family ``tokens`` and ``frames``
    (B, encoder_seq, d).  The state's caches are allocated on the batch's
    device, ``max_len`` long, in ``cache_dtype``.  The head runs on the
    last prompt position only.

    ``progressive=True`` (requires ``cfg.l2r``) streams that head
    (:func:`progressive_logits_from_hidden`) and returns ``(state,
    logits, first_tok (B, 1) int32, exit_level (B, 1) int32)``;
    ``first_tok`` always equals the one-shot prefill's argmax.
    ``early_exit`` stops the level loop once every row has decided.
    ``policy`` (the factory default, overridable per call as the
    trailing argument) gives each batch row its precision class.
    ``mesh`` overrides the installed mesh for the head's walk; the
    backbone runs whole on every rank, or split when ``params`` are
    :func:`~repro_torch.sharding.axes.shard_params` slices
    (:func:`split_scope`).
    """
    _check_step_flags(progressive, early_exit, policy)
    _check_progressive(cfg, progressive)
    default_policy = policy

    def prefill(params, batch, policy=None):
        with split_scope(cfg, params, mesh):
            return run(params, batch, policy)

    def run(params, batch, policy):
        if cfg.family == "encdec":
            tokens = batch["tokens"]
            state = init_encdec_state(cfg, tokens.shape[0], max_len,
                                      cache_dtype, device=tokens.device)
            hidden, state, _ = encdec_forward(
                cfg, params, tokens=tokens, frames=batch["frames"],
                mode="prefill", state=state)
        else:
            tokens = batch.get("tokens")
            embeds = batch.get("embeds")
            src = tokens if tokens is not None else embeds
            state = init_lm_state(cfg, src.shape[0], max_len, cache_dtype,
                                  device=src.device)
            hidden, state, _ = lm_forward(
                cfg, params, tokens=tokens, embeds=embeds,
                rope_positions=batch.get("rope_positions"), mode="prefill",
                state=state)
        head = _head(cfg, params, hidden[:, -1:], progressive, early_exit,
                     policy if policy is not None else default_policy, mesh)
        return (state, *head) if progressive else (state, head)

    return prefill


# ------------------------------------------------------- bucketed prefill
def prefill_buckets(max_len: int, min_bucket: int = 8) -> tuple[int, ...]:
    """Power-of-2 prompt-length buckets, capped at ``max_len``.

    Prompts pad to the smallest covering bucket, so the prefill shapes
    (kernel builds, allocator pools, warmup runs) exist per BUCKET
    instead of per unique prompt length.  The last bucket is ``max_len``
    itself (the cache bound), whether or not it is a power of two.
    """
    assert max_len >= 1
    out: list[int] = []
    b = min(min_bucket, max_len)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket covering ``length`` (buckets ascending)."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket "
                     f"{buckets[-1]} (the cache bound)")


def supports_bucketed_prefill(cfg: ModelConfig) -> bool:
    """Bucketed (right-padded) prefill is exact only for attention
    mixers: causal masking makes pad positions invisible to every real
    position, and the pad cache entries can be marked empty afterwards.
    Recurrent mixers carry the state at the LAST position, so those
    families keep the exact-length prefill path."""
    return cfg.family != "encdec" and all(
        k in ("global", "local") for k, _ in cfg.layer_kinds())


def _mask_bucket_state(state: LMState, true_len: torch.Tensor) -> LMState:
    """Post-prefill fixup for a right-padded prompt, in place: every
    KV-cache entry written by a pad position is marked empty (-1), so
    decode attention never sees pad keys, and ``pos`` becomes the TRUE
    length, so the first decoded token lands at position ``true_len``,
    overwriting the stale pad slots as decoding proceeds.  Bit-exact:
    masked entries contribute exact zeros to the softmax, and the cache
    at slots < true_len is untouched."""
    tl = true_len.to(torch.int32).reshape(-1, 1)  # (B, 1): broadcasts
    #   against (B, L) and stacked (layers, B, L) position leaves alike
    caches = [*state.prefix, *(state.stack or []), *state.suffix]
    for c in caches:
        if isinstance(c, KVCache):
            c.positions.masked_fill_(c.positions >= tl, -1)
    state.pos = true_len.to(torch.int32, copy=True)
    return state


def make_bucket_prefill_step(cfg: ModelConfig, max_len: int,
                             cache_dtype: torch.dtype = torch.bfloat16,
                             progressive: bool = False,
                             early_exit: bool = False,
                             mesh=None,
                             policy: LevelPolicy | None = None) -> Callable:
    """(params, tokens (B, Lb), true_len (B,)[, policy]) ->
    make_prefill_step's returns.

    The bucketed form of :func:`make_prefill_step`: ``tokens`` is a
    whole BUCKET of right-padded prompts and ``true_len`` (on the tokens'
    device) carries each row's real prompt length.  The head reads the
    hidden state at ``true_len - 1`` per row (not the pad tail), the
    returned state's ``pos`` is the true length, and pad-written cache
    entries are marked empty: decode from this state is bit-identical to
    an unpadded prefill of the same prompt.

    Rows are independent, so several queued prompts PACK into one call:
    pad the batch with dummy rows (``true_len = 1``) and ignore their
    outputs.  Attention families only (:func:`supports_bucketed_prefill`);
    local (ring) windows require the bucket to fit the window, asserted
    per call.  ``policy`` and ``mesh`` work as in
    :func:`make_prefill_step`.
    """
    _check_step_flags(progressive, early_exit, policy)
    assert supports_bucketed_prefill(cfg), \
        "bucketed prefill: attention-mixer LM families only"
    _check_progressive(cfg, progressive)
    default_policy = policy
    local = any(k == "local" for k, _ in cfg.layer_kinds())

    def prefill(params, tokens, true_len, policy=None):
        with split_scope(cfg, params, mesh):
            return run(params, tokens, true_len, policy)

    def run(params, tokens, true_len, policy):
        bsz, lb = tokens.shape
        if local:
            assert lb <= cfg.window, (
                f"bucket {lb} exceeds the local attention window "
                f"{cfg.window}: the ring cache would wrap over real "
                f"prompt entries")
        state = init_lm_state(cfg, bsz, max_len, cache_dtype,
                              device=tokens.device)
        hidden, state, _ = lm_forward(cfg, params, tokens=tokens,
                                      mode="prefill", state=state)
        rows = torch.arange(bsz, device=hidden.device)
        h_last = hidden[rows, true_len.long() - 1][:, None]  # (B, 1, d)
        state = _mask_bucket_state(state, true_len)
        head = _head(cfg, params, h_last, progressive, early_exit,
                     policy if policy is not None else default_policy, mesh)
        return (state, *head) if progressive else (state, head)

    return prefill


def progressive_logits_from_hidden(cfg: ModelConfig, params, hidden,
                                   early_exit: bool = False, mesh=None,
                                   policy: LevelPolicy | None = None):
    """Stream the LM head level by level, committing each row's token at
    its earliest sound MSDF level.

    The quantization recipe is exactly ``logits_from_hidden``'s L2R path
    (dense -> l2r_matmul_f), so the logits are bit-identical to the full
    head and the committed tokens ALWAYS equal its argmax; rows that
    never reach a sound early margin consume the whole stream.
    ``early_exit=True`` runs the while loop that STOPS once every row
    has decided: tokens and exit levels stay bit-identical, the logits
    are then the dequantized prefix at the exit level
    (core/progressive.py:streaming_argmax).  ``policy`` gives each
    FLATTENED lead row of ``hidden`` (decode: one per batch slot) its
    precision class.  Returns ``(logits (..., V), tok (...,) int32,
    exit_level (...,) int32)``.

    The ``head_q`` cache of :func:`prepare_params` is used when its
    stack matches the config: on the card kernel B2 (the scan) and B1's
    level slabs (early exit) read its pre-shifted, K-major planes in
    place, with no per-step operand preparation.

    Under a mesh (``mesh=``, else the installed one) the head streams as
    the consensus walk (rows over the data axes, the vocabulary over
    ``model``, a ``prepare_params(mesh=)`` cache holding this rank's
    slice), with the single-device results on every rank.  Within a
    ``ctx.row_shard`` scope the rows of ``hidden`` are this rank's of the
    global batch (core/progressive.py:streaming_argmax); the results and
    ``policy`` cover the global rows.
    """
    qcfg = cfg.l2r or QuantConfig()
    if "head_q" in params:  # the prepare_params load-time head cache
        head_q = params["head_q"]
        wq, ws = head_q.stream_operand(qcfg.n_bits, qcfg.log2_radix), \
            head_q.scale
    else:
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        wq, ws = quantize(w.to(hidden.dtype), qcfg, axis=-1)
    lead = hidden.shape[:-1]
    x2 = hidden.reshape(-1, hidden.shape[-1])
    xq, xs = quantize(x2, qcfg, axis=0 if qcfg.per_channel else None)
    n = ctx.mesh_axis_size(ctx.get_mesh(), ctx.row_axes())
    lead = (lead[0] * n, *lead[1:])  # the global rows come back
    if policy is not None:
        policy = policy.reshape((x2.shape[0] * n,))
    logits, tok, lv = streaming_argmax(
        xq, wq, xs, ws, qcfg.n_bits, qcfg.log2_radix, levels=cfg.l2r_levels,
        out_dtype=hidden.dtype, early_exit=early_exit, policy=policy,
        cuda_walk=CUDA_WALK, mesh=mesh)
    return logits.reshape(*lead, -1), tok.reshape(lead), lv.reshape(lead)


def make_decode_step(cfg: ModelConfig, progressive: bool = False,
                     early_exit: bool = False,
                     mesh=None,
                     policy: LevelPolicy | None = None) -> Callable:
    """(params, state, tokens (B, 1)[, rope_positions, policy]) ->
    (state, next_tokens (B, 1) int32, logits (B, 1, V)).

    The state is updated IN PLACE: the caches and ``pos`` are written
    into the tensors of the state passed in, and the returned state holds
    those same tensors (the reference donates its state to the same
    end).  ``progressive=True`` (requires ``cfg.l2r``) streams the head
    and also returns the per-row exit levels: ``(state, next_tokens,
    logits, exit_level (B, 1))``, tokens bit-identical to the one-shot
    step.  ``early_exit=True`` stops the head's level loop once every
    row has decided (the logits are then the exit-level prefix).
    ``policy`` (the factory default, overridable per call as the trailing
    argument) streams the head under per-slot precision classes.
    ``mesh`` and split params work as in :func:`make_prefill_step`.
    """
    _check_step_flags(progressive, early_exit, policy)
    _check_progressive(cfg, progressive)
    default_policy = policy

    def decode(params, state, tokens, rope_positions=None, policy=None):
        with split_scope(cfg, params, mesh):
            return run(params, state, tokens, rope_positions, policy)

    def run(params, state, tokens, rope_positions, policy):
        if cfg.family == "encdec":
            hidden, new, _ = encdec_forward(cfg, params, tokens=tokens,
                                            mode="decode", state=state)
        else:
            hidden, new, _ = lm_forward(
                cfg, params, tokens=tokens, rope_positions=rope_positions,
                mode="decode", state=state)
        state.pos.copy_(new.pos)  # the caches are already written in place
        new.pos = state.pos
        head = _head(cfg, params, hidden, progressive, early_exit,
                     policy if policy is not None else default_policy, mesh)
        if progressive:
            logits, tok, lv = head
            return new, tok, logits, lv
        return new, torch.argmax(head, dim=-1).to(torch.int32), head

    return decode


def greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                    steps: int, max_len: int | None = None,
                    cache_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Batched greedy decoding (host-driven): the prefill's token, then
    ``steps - 1`` decode steps -> (B, steps) int32 on the prompt's
    device."""
    b, s = prompt.shape
    max_len = max_len or (s + steps)
    prefill = make_prefill_step(cfg, max_len, cache_dtype)
    decode = make_decode_step(cfg)
    state, logits = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(steps - 1):
        state, tok, _ = decode(params, state, tok)
        out.append(tok)
    return torch.cat(out, dim=1)
