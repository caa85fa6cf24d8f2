"""Serving: the prefill and decode step factories and greedy decoding."""

from .engine import (greedy_generate, make_decode_step, make_prefill_step,
                     prepare_params)

__all__ = ["greedy_generate", "make_decode_step", "make_prefill_step",
           "prepare_params"]
