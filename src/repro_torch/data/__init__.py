"""Data pipelines (``repro.data``): the LM token stream (:mod:`.tokens`)
and the convnets' synthetic sets (:mod:`.synthetic`)."""
from .synthetic import batches, classification_set, detection_set

__all__ = ["batches", "classification_set", "detection_set"]
