from .profiles import TPU_MXU7, TPU_VPU15, MulProfile
from .select import (
    filter_acc_chunk,
    kernel_acc_chunk,
    runtime_kernel_placements,
    select_filter_placement,
    select_kernel_placement,
)
from .strategies import PackingConfig, filter_placements, kernel_placements

__all__ = [
    "TPU_MXU7",
    "TPU_VPU15",
    "MulProfile",
    "PackingConfig",
    "filter_acc_chunk",
    "filter_placements",
    "kernel_acc_chunk",
    "kernel_placements",
    "runtime_kernel_placements",
    "select_filter_placement",
    "select_kernel_placement",
]
