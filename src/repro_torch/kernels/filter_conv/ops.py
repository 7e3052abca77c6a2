"""Quantized multi-channel 1-D convolution via Filter Packing, with an
int32-container-safe placement choice (``repro.kernels.filter_conv.ops``).

:func:`packed_conv1d` follows its inputs' device: CUDA tensors run K6,
CPU tensors its plain version.  Pairs with no placement, or one that
packs a single product per multiply, take :func:`ref.conv_full_levels`,
as the reference does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import TPU_VPU15
from repro_torch.core.packing.select import select_filter_placement

from . import ref
from .kernel import filter_conv_raw


class FilterConfig(NamedTuple):
    """Frozen filter-placement choice; ``overlap=1`` is overpacked."""

    k_p: int
    n_p: int
    stride: int
    acc_chunk: int
    overlap: int = 0


@functools.lru_cache(maxsize=None)
def choose_filter_config(
    w_bits: int, a_bits: int, k_len: int, *, allow_overpack: bool = True
) -> FilterConfig | None:
    """The reference's filter placement on ``TPU_VPU15`` for a ``k_len``-tap
    filter, or None when no int32-safe placement exists."""
    sel = select_filter_placement(TPU_VPU15, w_bits, a_bits, k_len, allow_overpack=allow_overpack)
    if sel is None:
        return None
    cfg, acc = sel
    return FilterConfig(k_p=cfg.n_w, n_p=cfg.n_a, stride=cfg.stride,
                        acc_chunk=int(max(1, acc)), overlap=cfg.overlap)


def packed_conv1d(
    s_lvl: torch.Tensor,  # [B, C, N] int32 unsigned levels (< 2**a_bits)
    f_lvl: torch.Tensor,  # [C, K]    int32 unsigned levels (< 2**w_bits)
    *,
    w_bits: int,
    a_bits: int,
) -> torch.Tensor:
    """Full convolution summed over channels: [B, N+K-1] int32, bit-exact
    against :func:`ref.conv_full_levels`."""
    n = s_lvl.shape[2]
    k = f_lvl.shape[1]
    cfg = choose_filter_config(w_bits, a_bits, k)
    if cfg is None or cfg.k_p * cfg.n_p <= 1:
        return ref.conv_full_levels(f_lvl, s_lvl)
    n_pad = -(-n // cfg.n_p) * cfg.n_p
    s = F.pad(s_lvl.to(torch.int32), (0, n_pad - n)).contiguous()
    fp = ref.pack_filter(f_lvl, cfg.k_p, cfg.stride)
    return filter_conv_raw(s, fp, k_p=cfg.k_p, n_p=cfg.n_p, stride=cfg.stride,
                           acc_chunk=cfg.acc_chunk, k_len=k, n_len=n, overlap=cfg.overlap)
