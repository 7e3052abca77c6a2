"""Data pipelines (``repro.data``): the LM token stream (:mod:`.tokens`)."""
