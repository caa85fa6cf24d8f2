"""Cycle-exact performance model of the L2R-CIPU accelerator (paper §II-B).

Implements the paper's cycle formula

  Cycle_P = (n^2 + delta_Mult) * (k*k + ceil(N/T_n))
            * ceil(R*C / (T_r*T_c)) * ceil(M/T_m)

for the proposed design, and the corresponding count for the conventional
right-to-left bit-serial baseline (computation pattern of Loom [3]): both
operands bit-serial -> n_a * n_w cycles per multiplication, and — the
bottleneck the paper attacks — **no digit-level overlap** between the
multiplier, the reduction tree and the accumulator, which serializes the
4 pipeline stages into delta_IP(baseline) = 4 * n^2 = (2n)^2 cycles per
SOP wave (this reproduces the paper's printed 14.40 GOPS baseline peak
exactly; see DESIGN.md §7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

__all__ = [
    "ConvLayer",
    "AcceleratorConfig",
    "VGG16_CONV_LAYERS",
    "sop_latency_l2r",
    "sop_latency_baseline",
    "layer_cycles",
    "network_cycles",
    "peak_gops",
    "effective_gops",
    "inference_seconds",
]


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    R: int  # output rows
    C: int  # output cols
    N: int  # input channels
    M: int  # output channels
    k: int = 3  # kernel size

    @property
    def macs(self) -> int:
        return self.R * self.C * self.M * self.N * self.k * self.k

    @property
    def ops(self) -> int:
        return 2 * self.macs


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Paper's configuration: 8x8 PE array, T_n=8 channels, T_m=1."""

    n_bits: int = 8
    delta_mult: int = 11  # online delay of mult + reduction pipe (calibrated, DESIGN.md §7)
    T_n: int = 8
    T_r: int = 8
    T_c: int = 8
    T_m: int = 1
    k: int = 3
    freq_hz: float = 400e6

    @property
    def macs_per_pe(self) -> int:
        return self.k * self.k * self.T_n  # 72

    @property
    def pes(self) -> int:
        return self.T_r * self.T_c  # 64


# VGG-16 convolutional body (224x224 ImageNet input), layer = post-conv map.
VGG16_CONV_LAYERS: List[ConvLayer] = [
    ConvLayer("conv1_1", 224, 224, 3, 64),
    ConvLayer("conv1_2", 224, 224, 64, 64),
    ConvLayer("conv2_1", 112, 112, 64, 128),
    ConvLayer("conv2_2", 112, 112, 128, 128),
    ConvLayer("conv3_1", 56, 56, 128, 256),
    ConvLayer("conv3_2", 56, 56, 256, 256),
    ConvLayer("conv3_3", 56, 56, 256, 256),
    ConvLayer("conv4_1", 28, 28, 256, 512),
    ConvLayer("conv4_2", 28, 28, 512, 512),
    ConvLayer("conv4_3", 28, 28, 512, 512),
    ConvLayer("conv5_1", 14, 14, 512, 512),
    ConvLayer("conv5_2", 14, 14, 512, 512),
    ConvLayer("conv5_3", 14, 14, 512, 512),
]


def sop_latency_l2r(cfg: AcceleratorConfig) -> int:
    """delta_IP of the composite unit: n^2 partial-product cycles plus the
    online delay of the multiplier/compressor pipeline."""
    return cfg.n_bits**2 + cfg.delta_mult


def sop_latency_baseline(cfg: AcceleratorConfig) -> int:
    """Loom-pattern [3] right-to-left bit-serial SOP latency: n_a*n_w
    bit-pair cycles with the four datapath stages (multiply, tree,
    accumulate, writeback) fully serialized — no online overlap."""
    return 4 * cfg.n_bits**2


def layer_cycles(layer: ConvLayer, cfg: AcceleratorConfig, l2r: bool = True) -> int:
    """Paper's Cycle_P for one conv layer."""
    delta_ip = sop_latency_l2r(cfg) if l2r else sop_latency_baseline(cfg)
    reduction_and_channels = cfg.k * cfg.k + math.ceil(layer.N / cfg.T_n)
    spatial_tiles = math.ceil((layer.R * layer.C) / (cfg.T_r * cfg.T_c))
    output_tiles = math.ceil(layer.M / cfg.T_m)
    return delta_ip * reduction_and_channels * spatial_tiles * output_tiles


def network_cycles(
    layers: List[ConvLayer] | None = None,
    cfg: AcceleratorConfig = AcceleratorConfig(),
    l2r: bool = True,
) -> int:
    layers = VGG16_CONV_LAYERS if layers is None else layers
    return sum(layer_cycles(l, cfg, l2r) for l in layers)


def peak_gops(cfg: AcceleratorConfig = AcceleratorConfig(), l2r: bool = True) -> float:
    """Peak throughput: all PEs streaming SOPs back-to-back.

    GOPS = PEs * (2 * MACs per SOP) / delta_IP * f.
    L2R (delta_mult=11): 49.15 GOPS (paper prints 48.97, Δ0.4%);
    baseline: 14.40 GOPS (exact match to Table II).
    """
    delta_ip = sop_latency_l2r(cfg) if l2r else sop_latency_baseline(cfg)
    ops_per_wave = cfg.pes * 2 * cfg.macs_per_pe
    return ops_per_wave * cfg.freq_hz / delta_ip / 1e9


def inference_seconds(
    layers: List[ConvLayer] | None = None,
    cfg: AcceleratorConfig = AcceleratorConfig(),
    l2r: bool = True,
    n_tiles: int = 1,
) -> float:
    """Wall time for one inference on ``n_tiles`` parallel network tiles."""
    return network_cycles(layers, cfg, l2r) / n_tiles / cfg.freq_hz


def effective_gops(
    layers: List[ConvLayer] | None = None,
    cfg: AcceleratorConfig = AcceleratorConfig(),
    l2r: bool = True,
) -> float:
    layers = VGG16_CONV_LAYERS if layers is None else layers
    ops = sum(l.ops for l in layers)
    return ops / inference_seconds(layers, cfg, l2r) / 1e9
