"""Quantized dense layer through the Kernel-Packing matmul
(``repro.kernels.packed_matmul.ops``).

:func:`prepack_dense` quantizes and packs a float weight matrix once, at
load time; :func:`packed_dense` then runs each call on the packed words
(the reference's repack-per-call baseline is not ported).
Dispatch mirrors the reference's ``_prepacked_fn``:

* the resolved ``block_k`` covers K (the default: :func:`resolve_block_k`
  returns K, as the reference does off the TPU) -> K1, the fused kernel;
* an explicit ``block_k < K`` -> K2, the K-blocked kernel;
* a bit pair with no placement (``cfg is None``) -> the plain integer
  matmul :func:`ref.matmul_levels` (float64 on the card, exact), as the
  reference runs a ``jnp.dot`` outside any kernel for such pairs.

MoE experts take the same dispatch with a leading expert axis (``x [E,
M, K]`` on ``[E, K, Np]`` words): K1 and K2 then run all E products in
one launch, the counterpart of the reference's ``jax.vmap`` of
``packed_dense`` over experts (``repro/models/moe.py:84``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core.packing import TPU_VPU15
from repro_torch.core.packing.select import select_kernel_placement
from repro_torch.core.quant import act_to_int_levels, weight_to_int_levels
from repro_torch.device import resolve_device

from . import ref
from .kernel import packed_dense_fused_raw, packed_matmul_raw


class PackConfig(NamedTuple):
    """Frozen kernel-placement choice; ``overlap=1`` is overpacked."""

    n_seg: int
    stride: int
    acc_chunk: int
    overlap: int = 0


@functools.lru_cache(maxsize=None)
def choose_config(
    w_bits: int, a_bits: int, min_chunk: int = 4, *, allow_overpack: bool = True
) -> PackConfig | None:
    """The reference's placement for ``(w_bits, a_bits)`` on ``TPU_VPU15``,
    or None when no multi-segment placement exists."""
    sel = select_kernel_placement(
        TPU_VPU15, w_bits, a_bits, allow_overpack=allow_overpack, min_chunk=min_chunk,
    )
    if sel is None:
        return None
    cfg, chunk = sel
    return PackConfig(n_seg=cfg.n_w, stride=cfg.stride, acc_chunk=int(chunk), overlap=cfg.overlap)


@dataclasses.dataclass(frozen=True)
class PackedDenseParams:
    """One-time-packed serving weights for :func:`packed_dense`.

    Exactly one of ``w_packed`` ([..., K, N_pad // n_seg] int32, N padded
    up to a multiple of ``n_seg``) and ``w_lvl`` ([..., K, N] int32, bit
    pairs with no placement) is set.  Leading axes stack layers (or
    experts); :meth:`layer` takes one."""

    w_packed: torch.Tensor | None
    w_lvl: torch.Tensor | None
    w_bits: int
    a_bits: int
    w_scale: float
    w_zero: float
    cfg: PackConfig | None
    n_out: int
    block_k: int | None = None

    @property
    def data(self) -> torch.Tensor:
        return self.w_packed if self.cfg is not None else self.w_lvl

    def _with(self, data: torch.Tensor) -> "PackedDenseParams":
        if self.cfg is not None:
            return dataclasses.replace(self, w_packed=data)
        return dataclasses.replace(self, w_lvl=data)

    def layer(self, i: int) -> "PackedDenseParams":
        """Index ``i`` of the leading axis (a layer of ``[L, ...]`` words,
        or of ``[L, E, ...]`` expert words, which keeps the expert axis)."""
        return self._with(self.data[i])

    def to(self, device) -> "PackedDenseParams":
        return self._with(self.data.to(device))


def resolve_block_k(block_k: int | None, k_dim: int) -> int:
    """An explicit ``block_k`` wins; None means whole K (no TPU VMEM
    sizing applies on this card)."""
    return k_dim if block_k is None else block_k




def prepack_dense(
    w: torch.Tensor,
    *,
    w_bits: int,
    a_bits: int,
    block_k: int | None = None,
    t_max: torch.Tensor | float | None = None,
    device: str | torch.device = "cuda",
) -> PackedDenseParams:
    """Quantize + pack a float weight matrix once, on ``device``.

    ``w`` is [K, N] or stacked [L, K, N] / [E, K, N] / [L, E, K, N];
    levels are normalized per matrix (one leading index at a time, which
    also bounds the temporaries: each matrix's words are written into the
    stacked tensor as they come).  ``t_max`` overrides the normalizer and
    then carries the leading shape."""
    dev = resolve_device(device)
    if w.ndim in (3, 4):
        first, out = None, None
        for i in range(w.shape[0]):
            p = prepack_dense(w[i], w_bits=w_bits, a_bits=a_bits, block_k=block_k,
                              t_max=None if t_max is None else t_max[i], device=dev)
            if first is None:
                first = dataclasses.replace(p, w_packed=None, w_lvl=None)
                out = torch.empty((w.shape[0],) + tuple(p.data.shape), dtype=p.data.dtype, device=dev)
            elif dataclasses.replace(p, w_packed=None, w_lvl=None) != first:
                raise ValueError("stacked matrices must share their packing metadata")
            out[i] = p.data
            del p
        return first._with(out)
    w = w.to(dev)
    cfg = choose_config(w_bits, a_bits)
    n = w.shape[1]
    w_lvl, w_scale, w_zero = weight_to_int_levels(w, w_bits, t_max=t_max)
    if cfg is None:
        return PackedDenseParams(None, w_lvl, w_bits, a_bits, w_scale, w_zero, None, n, block_k)
    # zero-level padding columns ride the packed words and are sliced off
    n_pad = -(-n // cfg.n_seg) * cfg.n_seg
    if n_pad != n:
        w_lvl = torch.nn.functional.pad(w_lvl, (0, n_pad - n))
    wp = ref.pack_weights(w_lvl, cfg.n_seg, cfg.stride)
    return PackedDenseParams(wp, None, w_bits, a_bits, w_scale, w_zero, cfg, n, block_k)


def packed_dense(
    x: torch.Tensor,  # [M, K] (or [E, M, K] on [E, K, ...] words) float activations
    w: PackedDenseParams,
    *,
    block_k: int | None = None,
) -> torch.Tensor:
    """Quantized dense layer on prepacked weights -> [M, N] float32 (or
    [E, M, N], one product per expert)."""
    cfg = w.cfg
    bk = block_k if block_k is not None else w.block_k
    if x.ndim != w.data.ndim:
        raise ValueError(f"activations {tuple(x.shape)} do not match weights {tuple(w.data.shape)}")
    if cfg is not None and resolve_block_k(bk, x.shape[-1]) >= x.shape[-1]:
        # whole K: one fused kernel quantizes, multiplies and sums the rows
        acc, a_sum = packed_dense_fused_raw(
            x.to(torch.float32), w.w_packed, a_bits=w.a_bits, n_seg=cfg.n_seg,
            stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap,
        )
        a_scale = 1.0 / ((1 << w.a_bits) - 1)
    else:
        a_lvl, a_scale = act_to_int_levels(x, w.a_bits)
        if cfg is None:
            acc = ref.matmul_levels(a_lvl, w.w_lvl)
        else:
            acc = packed_matmul_raw(
                a_lvl, w.w_packed, n_seg=cfg.n_seg, stride=cfg.stride,
                acc_chunk=cfg.acc_chunk, overlap=cfg.overlap, block_k=bk,
            )
        a_sum = torch.sum(a_lvl, dim=-1, dtype=torch.int32)
    out = ref.dequantize(acc, a_sum, w.w_scale, w.w_zero, a_scale)
    return out if out.shape[-1] == w.n_out else out[..., : w.n_out]
