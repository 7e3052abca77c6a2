"""Command-line entry points (``repro.launch``): ``python -m repro_torch.launch.serve``."""
