"""Model configurations: the ten LM records of the registry and the
paper's VGG-16 (``vgg16_l2r``)."""

from .registry import (ARCHS, SHAPES, all_cells, cell_supported, get_config,
                       get_smoke)

__all__ = ["ARCHS", "SHAPES", "all_cells", "cell_supported", "get_config",
           "get_smoke"]
