"""Kernel-Packing placement enumeration (copy of the kernel-packing part
of ``repro.core.packing.strategies``, DeepBurning-MixQ Eq. 1).

Port D carries N_d operands at stride p_b, port E carries N_e operands
at stride N_d*p_b; constraints:

    d_b + (N_d-1) p_b        <= P_D
    e_b + (N_e-1) N_d p_b    <= P_E        with P_E >= P_D
    p_b = d_b + e_b + g_b,   g_b >= -overlap
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

from .profiles import MulProfile


@dataclasses.dataclass(frozen=True)
class PackingConfig:
    """One scored packing placement (see the reference for the fields)."""

    strategy: str
    w_bits: int
    a_bits: int
    n_w: int
    n_a: int
    stride: int
    overlap: int
    w_port_big: bool
    separated: str
    t_mul: float
    e_g: int
    dsps: int = 1


def kernel_placements(
    profile: MulProfile,
    w_bits: int,
    a_bits: int,
    *,
    allow_overpack: bool = True,
) -> Iterator[PackingConfig]:
    """Enumerate Kernel-Packing placements (Eq. 1 constraints)."""
    p_small, p_big = profile.port_small, profile.port_big
    for w_on_big in (False, True):
        d_b, e_b = (a_bits, w_bits) if w_on_big else (w_bits, a_bits)
        for overlap in ((0, 1) if allow_overpack else (0,)):
            p_min = d_b + e_b - overlap
            max_nd = max(1, (p_small - d_b) // p_min + 1)
            for n_d in range(1, max_nd + 1):
                p_cap_d = p_small if n_d == 1 else (p_small - d_b) // (n_d - 1)
                if p_cap_d < p_min:
                    continue
                max_ne = max(1, (p_big - e_b) // (n_d * p_min) + 1)
                for n_e in range(1, max_ne + 1):
                    p_cap_e = p_big if n_e == 1 else (p_big - e_b) // ((n_e - 1) * n_d)
                    stride = min(p_cap_d, p_cap_e)
                    if stride < p_min:
                        continue
                    if n_d == n_e == 1:
                        stride = p_min + overlap
                    n_w, n_a = (n_e, n_d) if w_on_big else (n_d, n_e)
                    yield PackingConfig(
                        strategy="kernel",
                        w_bits=w_bits,
                        a_bits=a_bits,
                        n_w=n_w,
                        n_a=n_a,
                        stride=stride,
                        overlap=overlap,
                        w_port_big=w_on_big,
                        separated="",
                        t_mul=float(n_d * n_e),
                        e_g=stride - (d_b + e_b) + overlap,
                    )
