"""Checkpoints in the reference's ``.npz`` format: atomic step
directories, int8 weight records and prepared serving trees."""

from .manager import CheckpointManager, load_pytree, save_pytree
from .quantized import (load_prepared, load_quantized, prepared_template,
                        quantized_nbytes, save_prepared, save_quantized)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "save_quantized", "load_quantized", "quantized_nbytes",
           "save_prepared", "prepared_template", "load_prepared"]
