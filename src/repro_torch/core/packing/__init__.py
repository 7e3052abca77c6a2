from .profiles import TPU_VPU15, MulProfile
from .select import kernel_acc_chunk, runtime_kernel_placements, select_kernel_placement
from .strategies import PackingConfig, kernel_placements

__all__ = [
    "TPU_VPU15",
    "MulProfile",
    "PackingConfig",
    "kernel_acc_chunk",
    "kernel_placements",
    "runtime_kernel_placements",
    "select_kernel_placement",
]
