"""Serving: the step factories (one-shot, progressive and bucketed),
the continuous batcher and the request-queue gateway."""

from .batching import ContinuousBatcher, Request, latency_percentiles
from .engine import (bucket_for, greedy_generate, make_bucket_prefill_step,
                     make_decode_step, make_prefill_step, prefill_buckets,
                     prepare_params, progressive_logits_from_hidden,
                     supports_bucketed_prefill)
from .gateway import ServingGateway

__all__ = ["ContinuousBatcher", "Request", "ServingGateway",
           "latency_percentiles", "bucket_for", "greedy_generate", "make_bucket_prefill_step",
           "make_decode_step", "make_prefill_step", "prefill_buckets",
           "prepare_params", "progressive_logits_from_hidden",
           "supports_bucketed_prefill"]
