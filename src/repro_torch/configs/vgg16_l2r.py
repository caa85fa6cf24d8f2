"""VGG-16 + L2R-CIPU — the paper's own evaluation configuration.

The port of ``repro/configs/vgg16_l2r.py``: the quantization config
(n=8 bits, radix-4 digit planes: D=4 planes, 7 significance levels) and
the accelerator cycle model configuration of Tables I/II.
"""

import dataclasses

from repro_torch.core.cycle_model import AcceleratorConfig
from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class VGG16L2RConfig:
    n_classes: int = 1000
    quant: QuantConfig = QuantConfig(n_bits=8, log2_radix=2)
    accel: AcceleratorConfig = AcceleratorConfig()
    levels: int | None = None  # None = exact; fewer = progressive precision


CONFIG = VGG16L2RConfig()
SMOKE = VGG16L2RConfig(n_classes=10)
