from .profiles import DSP48E2, PROFILES, TPU_MXU7, TPU_MXU8, TPU_VPU15, MulProfile
from .select import (
    filter_acc_chunk,
    kernel_acc_chunk,
    runtime_kernel_placements,
    select_filter_placement,
    select_kernel_placement,
    trivial_placement,
)
from .strategies import PackingConfig, all_placements, filter_placements, kernel_placements
from .optimizer import (
    DEFAULT_BITS,
    PackingLUT,
    best_packing,
    build_lut,
    cached_luts,
    compare_luts,
    default_lut_cache,
    lut_overhead_estimate,
)
from . import bitpack

__all__ = [
    "DEFAULT_BITS",
    "DSP48E2",
    "PROFILES",
    "TPU_MXU7",
    "TPU_MXU8",
    "TPU_VPU15",
    "MulProfile",
    "PackingConfig",
    "PackingLUT",
    "all_placements",
    "bitpack",
    "best_packing",
    "build_lut",
    "cached_luts",
    "compare_luts",
    "default_lut_cache",
    "filter_acc_chunk",
    "filter_placements",
    "kernel_acc_chunk",
    "kernel_placements",
    "lut_overhead_estimate",
    "runtime_kernel_placements",
    "select_filter_placement",
    "select_kernel_placement",
    "trivial_placement",
]
