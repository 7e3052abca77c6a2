"""Command-line entry points (``repro.launch``): ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``."""
