"""The train step: loss, gradients, AdamW, remat and microbatching."""

from .step import (TrainConfig, chunked_xent, make_loss_fn, make_train_step,
                   value_and_grad)

__all__ = ["TrainConfig", "make_train_step", "make_loss_fn", "chunked_xent",
           "value_and_grad"]
