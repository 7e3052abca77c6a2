from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ARCHS", "get_config"]
