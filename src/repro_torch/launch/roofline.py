"""Roofline accounting for the port on an NVIDIA H100, and the card's
data-sheet constants.

The port of ``repro/launch/roofline.py``.  This module is the one home
of the card's peak rates: the kernel bounds of ``chip_smoke.py``, the
collective pricing of ``analysis/collective_cost.py`` and the dry run
(``launch/dryrun.py``) read them from here.  They come from NVIDIA's
H100 SXM data sheet (dense tensor-core rates, no sparsity) for the card
the port is measured on, which ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives as "NVIDIA H100 80GB HBM3, 700.00 W".  A
card set below 700 W runs slower under load than these figures.  They
are a model of the card, not a measurement.

Per cell, three terms in seconds, for one rank (one card):

  compute    = FLOPs / peak      (bf16, or int8 where the products run
                                  on kernel B1: ``--l2r`` / ``--wq``)
  memory     = bytes / HBM_BYTES_PER_S
  collective = ring-model bytes on the wire / NVLINK_BYTES_PER_S

The wire bytes follow the ring models of
``analysis/collective_cost.py:ring_wire_bytes`` per recorded collective.
NVLink 4 gives a GPU 900 GB/s in both directions together, so 450 GB/s
each way; a ring sends and receives at once, so its wire time is the
bytes one way over 450 GB/s.

:func:`parse_collectives` is the reference's fold over the collective
records of a compiled module; here the module is a step's captured ATen
graph (launch/graph_analysis.py), whose collectives are nodes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["PEAK_INT8_OPS", "PEAK_BF16_FLOPS", "PEAK_TF32_FLOPS",
           "PEAK_F32_FLOPS", "PEAK_F64_FLOPS", "PEAK_INT32_OPS",
           "PEAK_POPC_OPS", "HBM_BYTES_PER_S", "NVLINK_BYTES_PER_S",
           "PEAKS", "OP_PEAKS", "CARD", "Roofline", "roofline_terms",
           "compute_seconds", "parse_collectives",
           "attn_decode_step_bytes", "model_flops"]

#: the card these constants describe, as nvidia-smi names it with its
#: power limit (--query-gpu=name,power.limit --format=csv,noheader)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: H100 SXM data sheet, dense int8 tensor cores: 1,979 TOP/s
#: (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_INT8_OPS = 1979e12
#: H100 SXM data sheet, dense bf16 tensor cores: 989 TFLOP/s
#: (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_BF16_FLOPS = 989e12
#: H100 SXM data sheet, dense TF32 tensor cores: 495 TFLOP/s
#: (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_TF32_FLOPS = 495e12
#: H100 SXM data sheet, f32 on the CUDA cores: 67 TFLOP/s
#: (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_F32_FLOPS = 67e12
#: H100 SXM data sheet, HBM3: 3.35 TB/s (NVIDIA H100 80GB HBM3, 700.00 W)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM data sheet, NVLink 4: 900 GB/s a GPU both ways, 450 GB/s
#: each way (NVIDIA H100 80GB HBM3, 700.00 W)
NVLINK_BYTES_PER_S = 450e9

#: H100 SXM data sheet, FP64 tensor cores: 67 TFLOP/s
#: (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_F64_FLOPS = 67e12
#: int32 operations on the CUDA cores: 64 a clock per SM (Hopper's
#: throughput table), 132 SMs at the data sheet's 1,980 MHz boost
#: (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_INT32_OPS = 64 * 132 * 1.98e9
#: popc: 16 a clock per SM on the same 132 SMs at 1,980 MHz
#: (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_POPC_OPS = 16 * 132 * 1.98e9

#: the compute peaks by name, as the dry run's artifacts name them
PEAKS = {"int8": PEAK_INT8_OPS, "bf16": PEAK_BF16_FLOPS,
         "tf32": PEAK_TF32_FLOPS, "f32": PEAK_F32_FLOPS}
#: every class of operation the graph analysis counts
#: (launch/graph_analysis.py: ``flops_by_peak``) at its peak; ``tf32x3``
#: is f32 as three TF32 products (kernel B5's f32 route)
OP_PEAKS = {**PEAKS, "tf32x3": PEAK_TF32_FLOPS / 3, "f64": PEAK_F64_FLOPS,
            "int32": PEAK_INT32_OPS, "popc": PEAK_POPC_OPS}


def compute_seconds(flops_by_peak: dict) -> float:
    """The least time of operations counted by the peak they run at
    (:data:`OP_PEAKS`): the classes' times add, except popc, which runs
    on its own pipe beside the int32 operations (their times overlap)."""
    t = {k: v / OP_PEAKS[k] for k, v in flops_by_peak.items()}
    overlap = max(t.pop("int32", 0.0), t.pop("popc", 0.0))
    return sum(t.values()) + overlap


def parse_collectives(records: list[dict]) -> dict[str, Any]:
    """Ring-model wire bytes and counts per collective kind of a captured
    graph's records (launch/graph_analysis.py:to_records): the reference's
    thin fold over ``collective_records``, one record a collective node
    (a loop's body once)."""
    from repro_torch.launch import graph_analysis

    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0}
    counts = {k: 0 for k in out}
    for rec in graph_analysis.collective_records(records):
        out[rec["kind"]] += rec["wire_bytes"]
        counts[rec["kind"]] += 1
    return {"wire_bytes": out, "counts": counts,
            "total_wire_bytes": sum(out.values())}


@dataclasses.dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_hbm: float
    wire_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def asdict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant,
                "bound_s": self.bound_s}


def roofline_terms(flops: float, bytes_hbm: float, wire_bytes: float,
                   chips: int, peak: str = "bf16",
                   flops_by_peak: dict | None = None) -> Roofline:
    """The three terms of one rank: ``flops``, ``bytes_hbm`` and
    ``wire_bytes`` are that rank's; ``peak`` names the compute rate
    (:data:`PEAKS`), or ``flops_by_peak`` prices each class at its own
    (:func:`compute_seconds`)."""
    return Roofline(
        compute_s=(compute_seconds(flops_by_peak) if flops_by_peak
                   is not None else flops / PEAKS[peak]),
        memory_s=bytes_hbm / HBM_BYTES_PER_S,
        collective_s=wire_bytes / NVLINK_BYTES_PER_S,
        flops=flops, bytes_hbm=bytes_hbm, wire_bytes=wire_bytes, chips=chips,
    )


def attn_decode_step_bytes(batch: int, cache_len: int, kv_heads: int,
                           head_dim: int, *, n_bits: int = 8,
                           log2_radix: int = 2, kv_dtype_bytes: int = 2,
                           levels: int | None = None) -> dict[str, Any]:
    """HBM bytes one decode step's attention moves per layer, per mode.

    Decode attention is memory-bound (the single-query GEMV does
    2*L*dh FLOPs a head against an L-slot cache read), so bytes a step
    are its roofline cost.  Four modes, as
    ``models/attention.py:decode_attention`` runs them:

      float            read K + V from the float cache;
      quant_reextract  digit-serial scores WITHOUT the plane cache: the
                       float K cache is read every step and re-quantized
                       (the same bytes as float; the waste is compute);
      plane_cache      the plane-stacked cache: (2D-1) blocks of
                       head_dim int8 a slot plus one f32 scale a slot,
                       and V for PV;
      plane_cache_truncated
                       a ``levels``-deep walk touches only the union of
                       its sliding level windows: min(D + levels - 1,
                       2D - 1) of the 2D-1 blocks.

    Returns per-mode ``{k_bytes, v_bytes, scale_bytes, total_bytes,
    memory_s}`` plus the config echo; ``memory_s`` is at
    :data:`HBM_BYTES_PER_S`.
    """
    d = n_bits // log2_radix
    n_blocks = 2 * d - 1
    slots = batch * cache_len * kv_heads
    v_bytes = slots * head_dim * kv_dtype_bytes
    k_float = slots * head_dim * kv_dtype_bytes
    k_planes_full = slots * n_blocks * head_dim  # int8
    scale_bytes = slots * 4  # f32 per-slot scale
    lv = n_blocks if levels is None else max(0, min(levels, n_blocks))
    touched = 0 if lv == 0 else min(d + lv - 1, n_blocks)
    k_planes_trunc = slots * touched * head_dim

    def mode(k_bytes: float, sc: float = 0.0) -> dict[str, float]:
        total = k_bytes + v_bytes + sc
        return {"k_bytes": k_bytes, "v_bytes": v_bytes, "scale_bytes": sc,
                "total_bytes": total, "memory_s": total / HBM_BYTES_PER_S}

    modes = {
        "float": mode(k_float),
        "quant_reextract": mode(k_float),
        "plane_cache": mode(k_planes_full, scale_bytes),
        "plane_cache_truncated": mode(k_planes_trunc, scale_bytes),
    }
    return {
        "batch": batch, "cache_len": cache_len, "kv_heads": kv_heads,
        "head_dim": head_dim, "n_bits": n_bits, "log2_radix": log2_radix,
        "kv_dtype_bytes": kv_dtype_bytes, "levels": lv,
        "plane_blocks_touched": touched,
        "modes": modes,
        "plane_cache_vs_float":
            modes["plane_cache"]["total_bytes"] / modes["float"]["total_bytes"],
        "truncated_vs_plane_cache":
            (modes["plane_cache_truncated"]["total_bytes"]
             / modes["plane_cache"]["total_bytes"]),
    }


def _param_paths(tree, path: tuple = ()) -> list:
    """``(path, Param)`` of every leaf of a descriptor tree."""
    from repro_torch.models.common import Param

    if isinstance(tree, Param):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _param_paths(tree[k], path + (k,))]
    return [x for i, t in enumerate(tree)
            for x in _param_paths(t, path + (i,))]


def model_flops(cfg, desc_tree, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params
    (routed experts scaled by k/E), embedding lookup excluded, logit
    matmul included: the reference's formula over the port's Param tree
    (models/common.py)."""
    total = 0.0
    routed = 0.0
    embed = 0.0
    for path, p in _param_paths(desc_tree):
        n = math.prod(p.shape)
        if "experts" in p.axes:
            routed += n
        if path and path[-1] == "embed" and "vocab" in p.axes:
            embed += n
        total += n
    active = total - routed
    if cfg.n_experts:
        active += routed * cfg.experts_per_token / cfg.n_experts
    # a tied embedding is the logits' matmul: kept; an untied one is a
    # lookup table only ('head' is counted already)
    if not getattr(cfg, "tie_embeddings", True):
        active -= embed
    factor = 6.0 if kind == "train" else 2.0
    return factor * active * n_tokens
