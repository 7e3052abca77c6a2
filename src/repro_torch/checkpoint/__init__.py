"""Snapshots of trees of tensors (``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
