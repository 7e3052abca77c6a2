"""The multiplier profiles of ``repro.core.packing.profiles``: the ones
the packed kernels run on, and the ones the packing LUTs score.

The port keeps the reference's profiles unchanged: the placement the
runtime chooses, and with it every packed weight word, must equal the
reference's bit for bit.  ``TPU_VPU15`` models an int32 lane as a 15x15
unsigned multiplier, so every packed partial sum stays below 2**30; the
CUDA kernels run the same placements on int32 CUDA-core lanes.
``TPU_MXU7`` is the sign-safe int8 lane (7 usable unsigned bits per port)
that the int8-lane packed matmul packs its weight words for.
``DSP48E2`` is the paper's 27x18 FPGA multiplier and ``TPU_MXU8`` the
nominal-width int8 lane: the packing optimizer's LUTs score them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MulProfile:
    """A fixed-width multiplier with two unsigned input ports."""

    name: str
    port_big: int
    port_small: int


DSP48E2 = MulProfile(name="dsp48e2", port_big=27, port_small=18)
TPU_VPU15 = MulProfile(name="tpu_vpu15", port_big=15, port_small=15)
TPU_MXU8 = MulProfile(name="tpu_mxu8", port_big=8, port_small=8)
TPU_MXU7 = MulProfile(name="tpu_mxu7", port_big=7, port_small=7)

PROFILES = {p.name: p for p in (DSP48E2, TPU_VPU15, TPU_MXU8, TPU_MXU7)}
