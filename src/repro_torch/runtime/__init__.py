"""The fault-tolerant training runner (``repro.runtime``)."""
from .fault_tolerance import FaultTolerantRunner, RunnerConfig, RunnerStats

__all__ = ["FaultTolerantRunner", "RunnerConfig", "RunnerStats"]
