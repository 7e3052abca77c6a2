"""Carry the reference's params (and optimizer state) into the port, so
both run on identical weights, packed words and moments.

The reference's arrays arrive as numpy (``np.asarray`` of each leaf);
its ``PackedDenseParams`` leaves are read by attribute, so this module
imports nothing of the reference.  bfloat16 arrays (numpy's
``ml_dtypes`` type) go through float32, which is exact.  Convnet weights
go from HWIO to OIHW and images from NHWC to NCHW, the port's layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.packed_matmul.ops import PackConfig, PackedDenseParams
from repro_torch.optim import AdamWState


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
    ``[L, ...]``, packed leaves allowed) as the port's; an ``AdamWState``
    (a NamedTuple of ``step``, ``mu``, ``nu``) becomes the port's."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if type(tree).__name__ == "AdamWState":
        return AdamWState(*(params_from_jax(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    if hasattr(tree, "w_packed"):
        return packed_from_jax(tree, device)
    return tensor_from_numpy(tree, device)


def shards_from_jax(stacked, mp: int, device: str | torch.device = "cpu") -> list:
    """The reference's ``[mp]``-stacked tensor-parallel shards (its
    ``stack_decode_shards`` output: ``_packed_shards``, ``_plan_shards``'s
    trees and heads) as the port's list of per-rank trees."""
    from repro_torch.parallel.sharding import unstack_decode_shards

    return unstack_decode_shards(params_from_jax(stacked, device), mp)


def sharded_from_jax(tree, specs, mesh):
    """The reference's params (or ``AdamWState``) as the port's per-rank
    shards on ``mesh`` by a matching tree of partition specs
    (``param_shardings``, ``param_shardings_opt``); the step count stays
    one tensor on the first rank's device."""
    from repro_torch.launch.mesh import shard_tree

    return shard_tree(params_from_jax(tree), specs, mesh)


def convnet_params_from_jax(tree, device: str | torch.device = "cpu") -> dict:
    """The reference's convnet params (``{"layer{i}": {"w", "scale",
    "bias"}}``, weights HWIO ``[k, k, cin/groups, cout]``) as the port's,
    weights OIHW ``[cout, cin/groups, k, k]``."""
    out = {}
    for name, p in tree.items():
        out[name] = {k: tensor_from_numpy(v, device) for k, v in p.items()}
        out[name]["w"] = out[name]["w"].permute(3, 2, 0, 1).contiguous()
    return out


def images_from_jax(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """The reference's NHWC images as the port's NCHW."""
    return tensor_from_numpy(x, device).permute(0, 3, 1, 2).contiguous()
