"""Symmetric int8 quantization and the plain W8A8 matmul
(``repro.kernels.quant_matmul.ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.packed_matmul.ref import matmul_levels


def _div(a: torch.Tensor, n: int) -> torch.Tensor:
    """``a / n`` as a true division on every device: PyTorch's CUDA kernel
    multiplies by the reciprocal of a Python-number divisor, which can be
    an ulp off the reference's division and flip a level."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def quantize_symmetric(w: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization: ``w ~ levels * scale``
    (levels int8 [K, N], scale float32 [1, N])."""
    n = (1 << (bits - 1)) - 1
    scale = _div(torch.amax(torch.abs(w), dim=0, keepdim=True), n) + 1e-12
    levels = torch.clamp(torch.round(w / scale), -n, n).to(torch.int8)
    return levels, scale.to(torch.float32)


def quantize_act_symmetric(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization: levels int8, one 0-d scale."""
    n = (1 << (bits - 1)) - 1
    scale = _div(torch.max(torch.abs(x)), n) + 1e-12
    levels = torch.clamp(torch.round(x / scale), -n, n).to(torch.int8)
    return levels, scale


def quant_matmul(a_i8: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                 a_scale: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 dot, then ONE float multiply by the combined
    scale (two sequential multiplies would differ by an ulp)."""
    acc = matmul_levels(a_i8, w_i8)
    return acc.to(torch.float32) * (w_scale * a_scale)
