from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    cosine_schedule, global_norm, clip_by_global_norm)
from .compression import EFState, ef_init, ef_compress_grads, compress_decompress

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm",
           "EFState", "ef_init", "ef_compress_grads",
           "compress_decompress"]
