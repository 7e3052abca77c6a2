"""Packing, plain integer matmul and dequantization
(``repro.kernels.packed_matmul.ref``)."""
from __future__ import annotations

import torch


def pack_weights(w_lvl: torch.Tensor, n_seg: int, stride: int) -> torch.Tensor:
    """[K, N] int32 levels -> [K, N // n_seg] packed (channel d at bit d*stride)."""
    k, n = w_lvl.shape
    if n % n_seg:
        raise ValueError(f"N={n} must be divisible by the packing factor {n_seg}")
    grouped = w_lvl.to(torch.int32).reshape(k, n // n_seg, n_seg)
    shifts = torch.arange(n_seg, dtype=torch.int32, device=w_lvl.device) * stride
    return torch.sum(grouped << shifts, dim=-1, dtype=torch.int32)


def pack_lsb_planes(w_lvl: torch.Tensor, n_seg: int, stride: int) -> torch.Tensor:
    """The weight-LSB planes the overpacked decode reads, in the
    :func:`pack_weights` layout.  Because stride >= w_bits this equals
    ``pack_weights(w_lvl) & lsb_mask`` — the kernels read that masked
    view and never store these."""
    return pack_weights(w_lvl & 1, n_seg, stride)


def matmul_levels(a_lvl: torch.Tensor, w_lvl: torch.Tensor) -> torch.Tensor:
    """Plain integer matmul of levels, for bit pairs with no packing
    placement.  CPU only: PyTorch has no CUDA int32 matmul."""
    if a_lvl.is_cuda or w_lvl.is_cuda:
        raise NotImplementedError(
            "this bit pair has no packing placement; the plain-integer CUDA "
            "kernel for such pairs comes in a later slice (ROADMAP.md, port queue)"
        )
    return a_lvl.to(torch.int32) @ w_lvl.to(torch.int32)


def dequantize(acc: torch.Tensor, a_sum: torch.Tensor, w_scale: float, w_zero: float,
               a_scale: float) -> torch.Tensor:
    """``(s_w (W - z_w))^T (s_a A)``: acc[m, n] = sum_k A W, a_sum[m] = sum_k A."""
    return (w_scale * a_scale) * (acc.to(torch.float32) - w_zero * a_sum[:, None].to(torch.float32))
