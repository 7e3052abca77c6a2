"""Filter packing and the plain full convolution
(``repro.kernels.filter_conv.ref``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_filter(f_lvl: torch.Tensor, k_p: int, stride: int) -> torch.Tensor:
    """[C, K] int32 levels -> [C, ceil(K/k_p)] packed filter chunks."""
    c, k = f_lvl.shape
    n_fc = -(-k // k_p)
    f = F.pad(f_lvl.to(torch.int32), (0, n_fc * k_p - k))
    chunks = f.reshape(c, n_fc, k_p)
    shifts = torch.arange(k_p, dtype=torch.int32, device=f_lvl.device) * stride
    return torch.sum(chunks << shifts, dim=-1, dtype=torch.int32)


def pack_lsb_filter(f_lvl: torch.Tensor, k_p: int, stride: int) -> torch.Tensor:
    """The filter-LSB planes the overpacked decode multiplies, in the
    :func:`pack_filter` layout.  Because stride >= w_bits this equals
    ``pack_filter(f) & lsb_mask(k_p, stride)``, the masked view the kernel
    reads."""
    return pack_filter(f_lvl & 1, k_p, stride)


def conv_full_levels(f_lvl: torch.Tensor, s_lvl: torch.Tensor) -> torch.Tensor:
    """Ground truth: ``sum_c full_convolution(f[c], s[b, c])`` -> [B, N+K-1] int32.

    A float64 ``conv1d`` of the flipped filter with K-1 zeros of padding
    on both sides: exact, since every sum of level products is far below
    2**53 (the reference computes it with ``jnp.convolve`` outside any
    kernel)."""
    k = f_lvl.shape[1]
    out = F.conv1d(s_lvl.to(torch.float64), torch.flip(f_lvl, (1,)).to(torch.float64)[None],
                   padding=k - 1)
    return out[:, 0].to(torch.int32)
