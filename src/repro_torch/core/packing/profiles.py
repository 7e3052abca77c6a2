"""The multiplier profiles the packed kernels run on (the ``TPU_VPU15``
and ``TPU_MXU7`` parts of ``repro.core.packing.profiles``).

The port keeps the reference's profiles unchanged: the placement the
runtime chooses, and with it every packed weight word, must equal the
reference's bit for bit.  ``TPU_VPU15`` models an int32 lane as a 15x15
unsigned multiplier, so every packed partial sum stays below 2**30; the
CUDA kernels run the same placements on int32 CUDA-core lanes.
``TPU_MXU7`` is the sign-safe int8 lane (7 usable unsigned bits per port)
that the int8-lane packed matmul packs its weight words for.
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
TPU_MXU7 = MulProfile(name="tpu_mxu7", port_big=7, port_small=7)
