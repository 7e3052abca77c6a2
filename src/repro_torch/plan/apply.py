"""The projection-weight walk of ``repro.plan.apply`` (deployment plans
themselves, and MoE expert tensors, come in later slices)."""
from __future__ import annotations

import re

import torch

from repro_torch.kernels.packed_matmul.ops import prepack_dense

# projection weights live at ".../<name>/w"
PROJ_WEIGHT_RE = r"(wq|wk|wv|wo|w_up|w_gate|w_down|in_z|in_xbc|out_proj)/w$"


def prepack_tree(tree, *, w_bits: int, a_bits: int, block_k: int | None = None,
                 device: str | torch.device = "cuda", _path: str = ""):
    """Quantize + bit-pack every projection weight ([K, N] or stacked
    [L, K, N]) of a params subtree into ``PackedDenseParams``."""
    if isinstance(tree, dict):
        return {
            k: prepack_tree(v, w_bits=w_bits, a_bits=a_bits, block_k=block_k, device=device,
                            _path=f"{_path}/{k}" if _path else str(k))
            for k, v in tree.items()
        }
    if isinstance(tree, torch.Tensor) and tree.ndim in (2, 3) and re.search(PROJ_WEIGHT_RE, _path):
        return prepack_dense(tree, w_bits=w_bits, a_bits=a_bits, block_k=block_k, device=device)
    return tree
