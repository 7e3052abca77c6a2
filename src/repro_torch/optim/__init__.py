"""Optimizer and gradient compression (``repro.optim``)."""
from .adamw import AdamW, AdamWState, GradAccumulator, cosine_schedule, global_norm

__all__ = ["AdamW", "AdamWState", "GradAccumulator", "cosine_schedule", "global_norm"]
