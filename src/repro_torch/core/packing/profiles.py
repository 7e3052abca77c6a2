"""The multiplier profile the packed kernels run on (the ``TPU_VPU15`` part
of ``repro.core.packing.profiles``).

The port keeps the reference's profile unchanged: the placement the
runtime chooses, and with it every packed weight word, must equal the
reference's bit for bit.  ``TPU_VPU15`` models an int32 lane as a 15x15
unsigned multiplier, so every packed partial sum stays below 2**30; the
CUDA kernels run the same placements on int32 CUDA-core lanes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MulProfile:
    """A fixed-width multiplier with two unsigned input ports."""

    name: str
    port_big: int
    port_small: int


TPU_VPU15 = MulProfile(name="tpu_vpu15", port_big=15, port_small=15)
