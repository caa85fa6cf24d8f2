"""Fault tolerance around the train loop."""

from .fault import (ElasticPlan, FaultTolerantLoop, StragglerPolicy,
                    elastic_replan)

__all__ = ["StragglerPolicy", "FaultTolerantLoop", "ElasticPlan",
           "elastic_replan"]
