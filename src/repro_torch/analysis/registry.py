"""Registry of claimed-exact entry points.

The port of ``repro/analysis/registry.py``.  The exactness audit
(analysis/exactness.py) is only as good as its coverage: a schedule that
never declares itself is never audited.  Every walk that claims the
repo's bit-exactness contract registers an :class:`ExactEntry` binding

* a **build** callable ``build(device=..., mesh=...) -> (fn, args)``:
  the entry point and small operands (numpy, seeds 0-3, the reference's
  shapes) on that device (the audit runs them once, so small shapes
  audit the graph the production shapes run),
* an :class:`~repro_torch.analysis.exactness.ExactnessContract`
  describing what the entry promises.

The reference's backends become devices: ``jnp`` is ``cpu`` (the plain
versions), ``pallas-interpret`` / ``pallas-tpu`` are ``cuda`` (the
kernel as one node, ``kernel-int`` mode: kernel B1 for ``stacked``, and
for ``streaming`` the per-level stream's final prefix through kernel B2,
``kernels/l2r_gemm/ops.py:l2r_gemm_progressive``).  On a host without
CUDA the ``cuda`` entries carry ``skip``.  The reference registers its
``pairs`` schedule on ``jnp`` only; so does the port.  Entries without a
backend in their name (attention, head) run on the CPU.

Split entries also declare a
:class:`~repro_torch.analysis.sharding.ShardingContract` and run on a
2 x 2 (data x model) mesh of four ranks, each rank calling the same
entry; without such a mesh they carry ``skip``.  ``contract=None`` marks
a sharding-only entry (the weight cache, the whole decode step).

Out-of-tree schedules register with::

    from repro_torch.analysis import registry
    registry.register(registry.ExactEntry(
        name="gemm/my-schedule/cpu",
        build=lambda device=None, mesh=None: (my_walk_fn, (aq, bq)),
        contract=ExactnessContract(n_bits=8, log2_radix=2, k=K),
    ))
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis.exactness import ExactnessContract
from repro_torch.sharding.collectives import (TAG_CONSENSUS, TAG_GATHER,
                                              TAG_MAX, TAG_MIN)

__all__ = ["ExactEntry", "register", "iter_entries", "default_entries",
           "BACKEND_DEVICES", "MESH_SHAPE", "consensus_contract"]

#: the reference's backends and the port's devices
BACKEND_DEVICES = {"jnp": "cpu", "pallas-interpret": "cuda",
                   "pallas-tpu": "cuda"}

#: the (data, model) mesh of the split entries
MESH_SHAPE = (2, 2)


@dataclasses.dataclass(frozen=True)
class ExactEntry:
    name: str
    build: Callable[..., tuple]  # (device=, mesh=) -> (fn, args)
    contract: ExactnessContract | None = None  # None: sharding-only entry
    tags: tuple = ()
    skip: str | None = None  # present but unavailable here
    sharding: object | None = None  # ShardingContract of a split entry
    device: str | None = None  # "cpu" / "cuda"; None: the pass's device


_EXTRA: list[ExactEntry] = []


def register(entry: ExactEntry) -> ExactEntry:
    """Declare an additional claimed-exact entry point (idempotent per
    name: re-registration replaces)."""
    _EXTRA[:] = [e for e in _EXTRA if e.name != entry.name]
    _EXTRA.append(entry)
    return entry


# ------------------------------------------------------------- operands
def _gemm_operands(m=4, k=24, n=16, seed=0):
    rng = np.random.default_rng(seed)
    aq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    bq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return aq, bq


def _attn_operands(b=1, q=2, kv=1, g=2, dh=8, s=5, seed=1):
    rng = np.random.default_rng(seed)
    qq = rng.integers(-128, 128, (b, q, kv, g, dh)).astype(np.int8)
    kq = rng.integers(-128, 128, (b, s, kv, dh)).astype(np.int8)
    return qq, kq


def _head_operands(m=4, k=16, n=12, seed=2):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    xs = np.abs(rng.standard_normal((m, 1))).astype(np.float32) + 0.1
    ws = np.abs(rng.standard_normal((1, n))).astype(np.float32) + 0.1
    return xq, wq, xs, ws


def _on(device, *arrays) -> tuple:
    dev = torch.device(device or "cpu")
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def _cuda_skip() -> str | None:
    return None if torch.cuda.is_available() else \
        "needs a CUDA card (the kernel as one node)"


def _walk_for(device):
    """The kernels' level walk on a CUDA device, None on the CPU."""
    if torch.device(device or "cpu").type != "cuda":
        return None
    from repro_torch.kernels.l2r_gemm.ops import CUDA_WALK
    return CUDA_WALK


# ------------------------------------------------------------- builders
def _gemm_entry(schedule: str, backend: str, early_exit: bool = False,
                levels: int | None = None, mode: str = "taint"):
    device = BACKEND_DEVICES[backend]
    name = f"gemm/{schedule}{'-while' if early_exit else ''}/{device}"
    if levels is not None:
        name += f"/levels-{levels}"

    def build(device=device, mesh=None):
        from repro_torch.kernels.l2r_gemm.ops import (l2r_gemm,
                                                      l2r_gemm_progressive)
        aq, bq = _on(device, *_gemm_operands())
        if device == "cuda" and schedule == "streaming":
            # kernel B2's per-level stream, its final prefix
            def fn(a, b):
                return l2r_gemm_progressive(a, b, 8, 2, levels).partial[-1]
        else:
            fn = functools.partial(l2r_gemm, n_bits=8, log2_radix=2,
                                   levels=levels, schedule=schedule,
                                   early_exit=early_exit)
        return fn, (aq, bq)

    return ExactEntry(
        name=name, build=build, tags=("gemm", device), device=device,
        skip=_cuda_skip() if device == "cuda" else None,
        contract=ExactnessContract(n_bits=8, log2_radix=2, k=24,
                                   levels=levels, mode=mode))


def _attn_entry(kind: str):
    def build(device="cpu", mesh=None):
        from repro_torch.core import l2r_attention as la
        fn = {"stacked": la.attn_scores_stacked,
              "streaming-scan": la.attn_scores_streaming_scan,
              "streaming-while": la.attn_scores_streaming_while}[kind]
        return fn, _on(device, *_attn_operands())

    return ExactEntry(
        name=f"attn/{kind}", build=build, tags=("attention",), device="cpu",
        contract=ExactnessContract(n_bits=8, log2_radix=2, k=8))


def _head_entry(early_exit: bool):
    def build(device="cpu", mesh=None):
        from repro_torch.core.progressive import streaming_argmax
        fn = functools.partial(streaming_argmax, early_exit=early_exit,
                               cuda_walk=_walk_for(device))
        return fn, _on(device, *_head_operands())

    return ExactEntry(
        name=f"head/streaming-{'while' if early_exit else 'scan'}",
        build=build, tags=("head",), device="cpu",
        contract=ExactnessContract(n_bits=8, log2_radix=2, k=16))


def _mesh_skip(mesh) -> str | None:
    if mesh is not None and tuple(mesh.shape.values()) == MESH_SHAPE:
        return None
    return (f"needs a {MESH_SHAPE[0]} x {MESH_SHAPE[1]} (data x model) mesh "
            f"of {MESH_SHAPE[0] * MESH_SHAPE[1]} ranks")


def consensus_contract(data: int, model: int, early_exit: bool,
                       rows_sharded: bool = True):
    """The port's consensus walk (core/policy.py:head_walk_machinery,
    columns split over ``model``, with ``rows_sharded`` rows over
    ``data``): a level, two MAX (the row maxima; the owner's lower and
    the runner-up's upper bound) and one MIN (the first index) over
    ``model``, and with early exit on split rows one int32 SUM of the
    rows decided over ``data``; a walk, the finalize's MAX and MIN, and
    the gathers of the logits over ``model`` and of the logits and the
    (token, level) pairs over ``data``.  So a walk of L levels makes
    ``sharded_walk_collectives(L, ...)``'s count.  The walk's config is
    the entries' and the main path's (n_bits 8, radix 4: 7 levels)."""
    from repro_torch.analysis.sharding import ReductionSpec, ShardingContract

    per_level = (ReductionSpec("pmax", 2, TAG_MAX),
                 ReductionSpec("pmin", 1, TAG_MIN))
    if early_exit and rows_sharded:
        per_level += (ReductionSpec("psum", 1, TAG_CONSENSUS),)
    return ShardingContract(
        mesh_axes=(("data", data), ("model", model)),
        per_level=per_level,
        per_walk=(ReductionSpec("pmax", 1, TAG_MAX),
                  ReductionSpec("pmin", 1, TAG_MIN),
                  ReductionSpec("all_gather", 1 + 2 * rows_sharded,
                                TAG_GATHER)),
        n_levels=7, early_exit=early_exit)


def _sharded_entry(mesh, early_exit: bool = False):
    data, model = MESH_SHAPE

    def build(device=None, mesh=mesh):
        from repro_torch.core.progressive import streaming_argmax
        fn = functools.partial(streaming_argmax, mesh=mesh,
                               early_exit=early_exit,
                               cuda_walk=_walk_for(device))
        return fn, _on(device, *_head_operands(m=data * 2, n=model * 3))

    return ExactEntry(
        name="head/sharded-consensus" + ("-while" if early_exit else ""),
        build=build, tags=("head", "sharded"), skip=_mesh_skip(mesh),
        contract=ExactnessContract(n_bits=8, log2_radix=2, k=16),
        sharding=consensus_contract(data, model, early_exit))


def _sharded_cache_entry(mesh):
    """The vocab-split quantized-weight cache: building a rank's slice
    of the plane stack is slicing, never communication — its budget is 0
    collectives."""
    from repro_torch.analysis.sharding import ShardingContract
    data, model = MESH_SHAPE

    def build(device=None, mesh=mesh):
        from repro_torch.core.quant import QuantConfig, quantize_weights
        cfg = QuantConfig(n_bits=8, log2_radix=2)

        def cache(w):
            qw = quantize_weights(w, cfg, prestack=True, window_pad=True,
                                  shard=(None, "model"), mesh=mesh)
            return qw.q, qw.scale, qw.planes.stack

        rng = np.random.default_rng(3)
        w = rng.standard_normal((16, model * 3)).astype(np.float32)
        return cache, _on(device, w)

    return ExactEntry(
        name="cache/sharded-weights", build=build,
        tags=("cache", "sharded"), skip=_mesh_skip(mesh),
        # sharding-only: the quantizer consumes a FLOAT weight (taint
        # starts at its int8 output)
        contract=None,
        sharding=ShardingContract(
            mesh_axes=(("data", data), ("model", model)), n_levels=1,
            max_collectives=0))


def _sharded_decode_entry(mesh):
    """The whole smoke LM decode step on a replicated backbone with the
    head cache split by vocabulary: its collectives are exactly the head
    consensus walk's.  Sharding-only (``contract=None``): the backbone is
    not itself a claimed-exact walk."""
    data, model = MESH_SHAPE

    def build(device=None, mesh=mesh):
        from repro_torch.configs import get_smoke
        from repro_torch.core.quant import QuantConfig
        from repro_torch.models.common import materialize
        from repro_torch.models.transformer import init_lm_state, lm_build
        from repro_torch.serve.engine import make_decode_step, prepare_params

        dev = torch.device(device or "cpu")
        cfg = dataclasses.replace(get_smoke("smollm-135m"),
                                  l2r=QuantConfig())
        gen = torch.Generator(device=dev).manual_seed(0)
        params = prepare_params(cfg, materialize(lm_build(cfg), gen,
                                                 device=dev), mesh=mesh)
        step = make_decode_step(cfg, progressive=True, mesh=mesh)
        batch = data * 2
        state = init_lm_state(cfg, batch, 32, device=dev)
        toks = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        return step, (params, state, toks)

    return ExactEntry(
        name="serve/sharded-decode-backbone", build=build,
        tags=("serve", "sharded"), skip=_mesh_skip(mesh), contract=None,
        sharding=consensus_contract(data, model, early_exit=False))


def default_entries(mesh=None) -> list[ExactEntry]:
    """The in-tree claimed-exact walks: head + attention, all three
    schedules, on both devices; the split ones on ``mesh`` (a 2 x 2
    mesh whose ranks each run them), else skipped."""
    return [
        _gemm_entry("stacked", "jnp"),
        _gemm_entry("pairs", "jnp"),
        _gemm_entry("streaming", "jnp"),
        _gemm_entry("streaming", "jnp", early_exit=True),
        _gemm_entry("stacked", "jnp", levels=3),
        _gemm_entry("stacked", "pallas-interpret", mode="kernel-int"),
        _gemm_entry("streaming", "pallas-interpret", mode="kernel-int"),
        _attn_entry("stacked"),
        _attn_entry("streaming-scan"),
        _attn_entry("streaming-while"),
        _head_entry(early_exit=False),
        _head_entry(early_exit=True),
        _sharded_entry(mesh),
        _sharded_entry(mesh, early_exit=True),
        _sharded_cache_entry(mesh),
        _sharded_decode_entry(mesh),
    ]


def iter_entries(tags: tuple | None = None, mesh=None) -> list[ExactEntry]:
    out = default_entries(mesh) + list(_EXTRA)
    if tags:
        out = [e for e in out if set(tags) & set(e.tags)]
    return out
