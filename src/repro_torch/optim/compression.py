"""Gradient compression (``repro.optim.compression``), per leaf: int8
(symmetric per-tensor quantize then dequantize) and top-k (keep the
largest-magnitude fraction, zero the rest).  Both keep the tree's
structure and dtypes.  A sharded leaf's scale and threshold are taken
over the whole logical leaf, each element once (its unique parts), then
applied part by part: the result is the unsharded one, bit for bit."""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import Sharded
from repro_torch.optim.adamw import tree_map


def _int8(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def quantize_int8(g):
    if isinstance(g, Sharded):
        parts = g.unique_parts()
        amax = torch.stack([torch.max(torch.abs(p)).to(parts[0].device) for p in parts]).max()
        scale = amax / 127.0 + 1e-12
        return g.map(lambda p: _int8(p, scale.to(p.device)))
    return _int8(g, torch.max(torch.abs(g)) / 127.0 + 1e-12)


def topk_mask(g, frac: float = 0.1):
    n = math.prod(g.shape)
    if n <= 16:
        return g
    k = max(1, int(n * frac))
    if isinstance(g, Sharded):
        parts = g.unique_parts()
        flat = torch.cat([torch.abs(p.reshape(-1)).to(parts[0].device) for p in parts])
        thresh = torch.topk(flat, k).values[-1]
        return g.map(lambda p: torch.where(torch.abs(p) >= thresh.to(p.device), p, 0.0))
    thresh = torch.topk(torch.abs(g.reshape(-1)), k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, 0.0)


def compress_tree(grads, method: str = "int8", topk_frac: float = 0.1):
    if method == "int8":
        return tree_map(quantize_int8, grads)
    if method == "topk":
        return tree_map(lambda g: topk_mask(g, topk_frac), grads)
    raise ValueError(method)
