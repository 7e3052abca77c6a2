"""Gradient compression (``repro.optim.compression``), per leaf: int8
(symmetric per-tensor quantize then dequantize) and top-k (keep the
largest-magnitude fraction, zero the rest).  Both keep the tree's
structure and dtypes."""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_map


def quantize_int8(g: torch.Tensor) -> torch.Tensor:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def topk_mask(g: torch.Tensor, frac: float = 0.1) -> torch.Tensor:
    if g.numel() <= 16:
        return g
    k = max(1, int(g.numel() * frac))
    thresh = torch.topk(torch.abs(g.reshape(-1)), k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, 0.0)


def compress_tree(grads, method: str = "int8", topk_frac: float = 0.1):
    if method == "int8":
        return tree_map(quantize_int8, grads)
    if method == "topk":
        return tree_map(lambda g: topk_mask(g, topk_frac), grads)
    raise ValueError(method)
