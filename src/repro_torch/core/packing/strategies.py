"""Packing-placement enumeration (copy of
``repro.core.packing.strategies``, DeepBurning-MixQ Eq. 1, 2 and 5).

Kernel Packing: port D carries N_d operands at stride p_b, port E carries
N_e operands at stride N_d*p_b; constraints:

    d_b + (N_d-1) p_b        <= P_D
    e_b + (N_e-1) N_d p_b    <= P_E        with P_E >= P_D
    p_b = d_b + e_b + g_b,   g_b >= -overlap

Filter Packing: k_p filter taps on one port and n_p sequence elements on
the other, both at one stride, so one multiply yields the k_p + n_p - 1
coefficients of their polynomial product.

Operand Separation splits one operand into hi/lo halves packed with one
placement: two multipliers per product set, so T_mul halves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

from .profiles import MulProfile


def _ceil_log2(x: int) -> int:
    return math.ceil(math.log2(x)) if x > 1 else 0


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

    @property
    def key(self) -> tuple[float, int]:
        """Sort key: maximize throughput first, then extra guard bits."""
        return (self.t_mul, self.e_g)


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


def filter_placements(
    profile: MulProfile,
    w_bits: int,
    a_bits: int,
    kernel_len: int,
    seq_len: int,
    *,
    allow_overpack: bool = True,
) -> Iterator[PackingConfig]:
    """Enumerate Filter-Packing placements (Eq. 2 constraints), scored by
    the up-rounding-aware T_mul = K*N / (ceil(K/k_p) * ceil(N/n_p))."""
    for w_on_big in (False, True):
        p_w = profile.port_big if w_on_big else profile.port_small
        p_a = profile.port_small if w_on_big else profile.port_big
        for overlap in ((0, 1) if allow_overpack else (0,)):
            max_kp = max(1, (p_w - w_bits) // max(1, w_bits + a_bits - overlap) + 1)
            for k_p in range(1, min(max_kp, kernel_len) + 1):
                max_np = max(1, (p_a - a_bits) // max(1, w_bits + a_bits - overlap) + 1)
                for n_p in range(1, min(max_np, seq_len) + 1):
                    if k_p == 1 and n_p == 1:
                        continue  # covered by kernel packing
                    g_min = _ceil_log2(min(k_p, n_p)) - overlap
                    p_min = w_bits + a_bits + max(g_min, -1 if overlap else 0)
                    cap_w = p_w if k_p == 1 else (p_w - w_bits) // (k_p - 1)
                    cap_a = p_a if n_p == 1 else (p_a - a_bits) // (n_p - 1)
                    stride = min(cap_w, cap_a)
                    if stride < p_min:
                        continue
                    eff = (kernel_len * seq_len) / (
                        math.ceil(kernel_len / k_p) * math.ceil(seq_len / n_p)
                    )
                    yield PackingConfig(
                        strategy="filter",
                        w_bits=w_bits,
                        a_bits=a_bits,
                        n_w=k_p,
                        n_a=n_p,
                        stride=stride,
                        overlap=overlap,
                        w_port_big=w_on_big,
                        separated="",
                        t_mul=eff,
                        e_g=stride - (w_bits + a_bits) - _ceil_log2(min(k_p, n_p)) + overlap,
                    )


def separated_placements(
    profile: MulProfile,
    w_bits: int,
    a_bits: int,
    kernel_len: int,
    seq_len: int,
    *,
    allow_overpack: bool = True,
) -> Iterator[PackingConfig]:
    """Operand Separation (Eq. 5): both halves packed with the placement
    sized for the wider (low) half, ``ceil(b / 2)`` bits."""
    for which, bits in (("w", w_bits), ("a", a_bits)):
        if bits < 3:
            continue  # splitting below 3 bits can't help
        lo_bits = -(-bits // 2)
        wb, ab = (lo_bits, a_bits) if which == "w" else (w_bits, lo_bits)
        halves = list(kernel_placements(profile, wb, ab, allow_overpack=allow_overpack))
        halves += list(
            filter_placements(profile, wb, ab, kernel_len, seq_len, allow_overpack=allow_overpack)
        )
        for cfg in halves:
            yield dataclasses.replace(
                cfg, w_bits=w_bits, a_bits=a_bits, separated=which, t_mul=cfg.t_mul / 2.0, dsps=2,
            )


def all_placements(
    profile: MulProfile,
    w_bits: int,
    a_bits: int,
    kernel_len: int,
    seq_len: int,
    *,
    allow_overpack: bool = True,
    allow_separation: bool = True,
    allow_filter: bool = True,
) -> list[PackingConfig]:
    out = list(kernel_placements(profile, w_bits, a_bits, allow_overpack=allow_overpack))
    if allow_filter and kernel_len > 1:
        out += list(
            filter_placements(profile, w_bits, a_bits, kernel_len, seq_len, allow_overpack=allow_overpack)
        )
    if allow_separation:
        out += list(
            separated_placements(
                profile, w_bits, a_bits, kernel_len, seq_len, allow_overpack=allow_overpack
            )
        )
    return out
