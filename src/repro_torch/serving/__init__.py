"""Continuous-batching serving (``repro.serving``), on one device or a mesh."""
from repro_torch.serving.chaos import ChaosConfig, InjectedFault
from repro_torch.serving.engine import Engine, EngineConfig, MeshConfig, ObsConfig
from repro_torch.serving.lifecycle import SLO, TERMINAL_STATUSES, Request
from repro_torch.serving.paged_kv import BlockTable, PageAllocator
from repro_torch.serving.scheduler import Scheduler

# api imports Engine/EngineConfig from engine: keep this import last
from repro_torch.serving.api import build_engine

__all__ = [
    "BlockTable",
    "ChaosConfig",
    "Engine",
    "EngineConfig",
    "InjectedFault",
    "MeshConfig",
    "ObsConfig",
    "PageAllocator",
    "Request",
    "SLO",
    "Scheduler",
    "TERMINAL_STATUSES",
    "build_engine",
]
