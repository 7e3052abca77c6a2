"""Float-in/float-out int8 matmul and the segment-packed ultra-low-bit
dense layer inside the int8 lane (``repro.kernels.quant_matmul.ops``).

* :func:`quant_dense`: W8A8 symmetric quantization, then K4.
* :func:`quant_packed_dense`: DoReFa levels, weights packed ``n_seg`` to
  an int8 word at the ``TPU_MXU7`` placement, then K5.  Pairs with no
  int8-lane placement (every pair but w2a2 and w2a3), or N not a multiple
  of ``n_seg``, take the plain integer matmul :func:`matmul_levels`, as
  the reference does.

Both follow their inputs' device: CUDA tensors run the kernels, CPU
tensors the plain versions.  The reference's TPU tiling arguments
(``block_k``, ``interpret``) have no counterpart: any chunking within the
placement's bound gives the same integers.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.packing import TPU_MXU7
from repro_torch.core.packing.select import select_kernel_placement
from repro_torch.core.quant import act_to_int_levels, weight_to_int_levels
from repro_torch.kernels.packed_matmul import ref as pm_ref

from . import ref
from .kernel import quant_matmul_raw, quant_packed_matmul_raw


class MxuPackConfig(NamedTuple):
    """Frozen int8-lane placement choice; ``overlap=1`` is overpacked."""

    n_seg: int
    stride: int
    acc_chunk: int
    overlap: int = 0


@functools.lru_cache(maxsize=None)
def choose_mxu_config(
    w_bits: int, a_bits: int, min_chunk: int = 2, *, allow_overpack: bool = True
) -> MxuPackConfig | None:
    """The reference's int8-lane placement for ``(w_bits, a_bits)`` on
    ``TPU_MXU7``, or None when no multi-segment placement exists."""
    sel = select_kernel_placement(
        TPU_MXU7, w_bits, a_bits, allow_overpack=allow_overpack, min_chunk=min_chunk,
    )
    if sel is None:
        return None
    cfg, chunk = sel
    return MxuPackConfig(n_seg=cfg.n_w, stride=cfg.stride, acc_chunk=int(chunk), overlap=cfg.overlap)


def quant_packed_dense(x: torch.Tensor, w: torch.Tensor, *, w_bits: int, a_bits: int) -> torch.Tensor:
    """Ultra-low-bit dense layer on the int8 lane -> [M, N] float32;
    bit-exact against the plain integer path wherever a placement exists."""
    cfg = choose_mxu_config(w_bits, a_bits)
    w_lvl, w_scale, w_zero = weight_to_int_levels(w, w_bits)
    a_lvl, a_scale = act_to_int_levels(x, a_bits)
    if cfg is None or w.shape[1] % cfg.n_seg != 0:
        acc = pm_ref.matmul_levels(a_lvl, w_lvl)
    else:
        wp = pm_ref.pack_weights(w_lvl, cfg.n_seg, cfg.stride).to(torch.int8)
        acc = quant_packed_matmul_raw(
            a_lvl.to(torch.int8), wp, n_seg=cfg.n_seg, stride=cfg.stride,
            acc_chunk=cfg.acc_chunk, overlap=cfg.overlap,
        )
    a_sum = torch.sum(a_lvl, dim=1, dtype=torch.int32)
    return pm_ref.dequantize(acc, a_sum, w_scale, w_zero, a_scale)


def quant_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """W8A8 symmetric quantized dense layer through K4 -> [M, N] float32."""
    w_i8, w_scale = ref.quantize_symmetric(w)
    a_i8, a_scale = ref.quantize_act_symmetric(x)
    return quant_matmul_raw(a_i8, w_i8, w_scale * a_scale)


def quant_dense_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same layer through the plain integer matmul."""
    w_i8, w_scale = ref.quantize_symmetric(w)
    a_i8, a_scale = ref.quantize_act_symmetric(x)
    return ref.quant_matmul(a_i8, w_i8, w_scale, a_scale)
