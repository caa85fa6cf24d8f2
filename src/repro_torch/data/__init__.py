"""The synthetic, resumable data pipeline."""

from .pipeline import DataConfig, ShardedPipeline, synthetic_batch

__all__ = ["DataConfig", "ShardedPipeline", "synthetic_batch"]
