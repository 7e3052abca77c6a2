"""Carry the reference's params into the port, so both run on identical
weights and identical packed words.

The reference's arrays arrive as numpy (``np.asarray`` of each leaf);
its ``PackedDenseParams`` leaves are read by attribute, so this module
imports nothing of the reference.  bfloat16 arrays (numpy's
``ml_dtypes`` type) go through float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.packed_matmul.ops import PackConfig, PackedDenseParams


def tensor_from_numpy(a, device: str | torch.device = "cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def packed_from_jax(p, device: str | torch.device = "cpu") -> PackedDenseParams:
    """A reference ``PackedDenseParams`` (arrays as numpy or jax arrays)
    as the port's, on ``device``: the same packed words and metadata."""
    cfg = None if p.cfg is None else PackConfig(*(int(v) for v in p.cfg))
    return PackedDenseParams(
        w_packed=None if p.w_packed is None else tensor_from_numpy(p.w_packed, device),
        w_lvl=None if p.w_lvl is None else tensor_from_numpy(p.w_lvl, device),
        w_bits=int(p.w_bits), a_bits=int(p.a_bits), w_scale=float(p.w_scale),
        w_zero=float(p.w_zero), cfg=cfg, n_out=int(p.n_out),
        block_k=None if p.block_k is None else int(p.block_k),
    )


def params_from_jax(tree, device: str | torch.device = "cpu"):
    """The reference's params tree (dicts of numpy arrays, stacked
    ``[L, ...]``, packed leaves allowed) as the port's."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    if hasattr(tree, "w_packed"):
        return packed_from_jax(tree, device)
    return tensor_from_numpy(tree, device)
