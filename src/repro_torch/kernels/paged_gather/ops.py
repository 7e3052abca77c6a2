"""Dispatch wrapper for the paged-KV gather (``repro.kernels.paged_gather.ops``).

:func:`paged_gather_kv` runs the chosen backend and flattens its
per-block tiles into the ``[S, T, D]`` view / ``[S, C, T]`` mask layout
the attention math reads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_gather.kernel import paged_gather_plain, paged_gather_raw

# "xla" is the pool[block_table] gather written with torch indexing (the
# reference's name is kept), "kernel" the CUDA paged-gather kernel
GATHER_BACKENDS = ("xla", "kernel")


def check_gather_backend(name: str) -> str:
    if name not in GATHER_BACKENDS:
        raise ValueError(f"unknown gather backend {name!r} (know {GATHER_BACKENDS})")
    return name


def paged_gather_kv(
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_table: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: int,
    chunk: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    out_dtype: torch.dtype,
    backend: str = "kernel",
):
    """Returns ``(k_view [S,T,D], v_view [S,T,D], mask [S,C,T])``."""
    S, n_blocks = block_table.shape
    page_size, width = pool_k.shape[1], pool_k.shape[2]
    if check_gather_backend(backend) == "kernel":
        k4, v4, m4 = paged_gather_raw(
            block_table, pos, window, pool_k, pool_v, k_scale, v_scale,
            chunk=chunk, out_dtype=out_dtype,
        )
    else:
        k4, v4, m4 = paged_gather_plain(
            block_table, pos, window, pool_k, pool_v, k_scale, v_scale,
            chunk=chunk, out_dtype=out_dtype, zero_null=False,
        )
    T = n_blocks * page_size
    return k4.reshape(S, T, width), v4.reshape(S, T, width), m4.reshape(S, chunk, T)
