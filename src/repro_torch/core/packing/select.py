"""Runtime kernel- and filter-placement selection (copy of
``repro.core.packing.select``).

Feasible means executable on an int32 lane: the packed accumulator fits
``container_bits``, the pre-decode chunk obeys Eq. 4's exact bound at
``stride + overlap`` decoded bits, and overpacked placements keep the
per-segment LSB-parity count below ``2**stride``.
"""
from __future__ import annotations

from typing import Iterator

from .profiles import MulProfile
from .strategies import PackingConfig, _ceil_log2, filter_placements, kernel_placements


def kernel_acc_chunk(cfg: PackingConfig) -> int:
    """Largest A with ``A * max_prod <= 2**(stride + overlap) - 1``;
    overpacked placements are further capped at ``2**stride - 1`` so the
    parity-plane counters stay segment-aligned."""
    max_prod = ((1 << cfg.w_bits) - 1) * ((1 << cfg.a_bits) - 1)
    chunk = max(1, ((1 << (cfg.stride + cfg.overlap)) - 1) // max_prod)
    if cfg.overlap:
        chunk = min(chunk, (1 << cfg.stride) - 1)
    return chunk


def _container_bits_kernel(cfg: PackingConfig) -> int:
    n_seg = cfg.n_w * cfg.n_a
    return (n_seg - 1) * cfg.stride + cfg.stride + cfg.overlap


def runtime_kernel_placements(
    profile: MulProfile,
    w_bits: int,
    a_bits: int,
    *,
    allow_overpack: bool = True,
    container_bits: int = 31,
) -> Iterator[PackingConfig]:
    """Placements the matmul kernels can run: weights packed on one port
    (``n_a == 1``) and the whole accumulator int32-safe."""
    for cfg in kernel_placements(profile, w_bits, a_bits, allow_overpack=allow_overpack):
        if cfg.n_a != 1:
            continue
        if container_bits is not None and _container_bits_kernel(cfg) > container_bits:
            continue
        yield cfg


def select_kernel_placement(
    profile: MulProfile,
    w_bits: int,
    a_bits: int,
    *,
    allow_overpack: bool = True,
    min_chunk: int = 4,
    container_bits: int = 31,
) -> tuple[PackingConfig, int] | None:
    """Best executable placement: density first, then accumulation
    headroom; exact ties prefer no overpack.  None when no multi-segment
    placement survives."""
    best: tuple[tuple[int, int, int], PackingConfig, int] | None = None
    for cfg in runtime_kernel_placements(
        profile, w_bits, a_bits,
        allow_overpack=allow_overpack, container_bits=container_bits,
    ):
        chunk = kernel_acc_chunk(cfg)
        if chunk < min_chunk and cfg.n_w > 1:
            continue
        score = (cfg.n_w, chunk, -cfg.overlap)
        if best is None or score > best[0]:
            best = (score, cfg, chunk)
    if best is None or best[1].n_w == 1:
        return None
    return best[1], best[2]


def filter_acc_chunk(cfg: PackingConfig, *, container_bits: int = 31) -> int | None:
    """Pre-decode channel-accumulation chunk for a filter placement, or
    None when it is not executable on an int32 lane.

    One multiply's segment already sums ``min(k_p, n_p)`` products and
    ``chunk`` channels multiply that: the decoded per-segment total must
    fit ``stride + overlap`` bits, the packed accumulator the container,
    and (overpacked) the parity counters ``stride`` bits."""
    k_p, n_p = cfg.n_w, cfg.n_a
    nseg = k_p + n_p - 1
    guard = cfg.stride + cfg.overlap - (cfg.w_bits + cfg.a_bits) - _ceil_log2(min(k_p, n_p))
    container = cfg.w_bits + cfg.a_bits + (nseg - 1) * cfg.stride + cfg.overlap
    if container > container_bits or guard < 0:
        return None
    chunk = 1 << min(guard, container_bits - container)
    if cfg.overlap:
        chunk = min(chunk, ((1 << cfg.stride) - 1) // min(k_p, n_p))
        if chunk < 1:
            return None
        if nseg * cfg.stride > container_bits:
            return None  # the parity-plane product itself must stay int32
    return max(1, chunk)


def select_filter_placement(
    profile: MulProfile,
    w_bits: int,
    a_bits: int,
    kernel_len: int,
    *,
    allow_overpack: bool = True,
    container_bits: int = 31,
) -> tuple[PackingConfig, int] | None:
    """Best executable filter placement: maximizes ``t_mul * min(chunk, 4)``,
    then density, then headroom; exact ties prefer no overpack."""
    best: tuple[tuple, PackingConfig, int] | None = None
    for cfg in filter_placements(
        profile, w_bits, a_bits, kernel_len, 1 << 30, allow_overpack=allow_overpack
    ):
        chunk = filter_acc_chunk(cfg, container_bits=container_bits)
        if chunk is None:
            continue
        score = (cfg.t_mul * min(chunk, 4), cfg.t_mul, chunk, -cfg.overlap)
        if best is None or score > best[0]:
            best = (score, cfg, chunk)
    if best is None:
        return None
    return best[1], best[2]


def trivial_placement(w_bits: int, a_bits: int) -> PackingConfig:
    """The n_seg == 1 fallback (plain integer path): T_mul = 1, no guard."""
    return PackingConfig(
        strategy="kernel", w_bits=w_bits, a_bits=a_bits, n_w=1, n_a=1,
        stride=w_bits + a_bits, overlap=0, w_port_big=False, separated="",
        t_mul=1.0, e_g=0,
    )
