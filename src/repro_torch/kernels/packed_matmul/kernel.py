"""Kernel-Packing matmul: CUDA kernels K1/K2 and their plain versions.

K1 ``packed_dense_fused_raw`` replaces the TPU kernel
``repro/kernels/packed_matmul/kernel.py:111 packed_dense_fused_raw``:
it quantizes float activations in the kernel, runs the whole-K packed
dot with the chunked peel, interleaves segments to channel order and
sums each row's levels.  K2 ``packed_matmul_raw`` replaces
``kernel.py:168 packed_matmul_raw``: the same packed dot on activation
levels, with chunks restarting at every multiple of ``block_k``.  Both
are ``csrc/packed_matmul.cu`` (peel in ``csrc/peel.cuh``); see that file
for what bounds them on the card.

Given CUDA tensors a wrapper launches its kernel or raises; given CPU
tensors it runs the plain version (``*_plain`` below).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.peel import interleave, peel_chunks

# segment counts the CUDA kernels are instantiated for: every placement
# choose_config selects for bit pairs 2..8 x 2..8 packs 2 or 3 segments
KERNEL_N_SEG = (2, 3)


def packed_dense_fused_plain(x, w_packed, *, a_bits, n_seg, stride, acc_chunk, overlap=0):
    """Plain version of K1: ``(acc [M, N] int32, a_sum [M] int32)``."""
    n_lvl = (1 << a_bits) - 1
    a = torch.round(torch.clamp(x.to(torch.float32), 0.0, 1.0) * n_lvl).to(torch.int32)
    acc = peel_chunks(a, w_packed, n_seg=n_seg, stride=stride,
                      acc_chunk=acc_chunk, overlap=overlap)
    return interleave(acc), torch.sum(a, dim=1, dtype=torch.int32)


def packed_matmul_plain(a_lvl, w_packed, *, n_seg, stride, acc_chunk, overlap=0, block_k=None):
    """Plain version of K2: ``acc [M, N] int32``."""
    acc = peel_chunks(a_lvl, w_packed, n_seg=n_seg, stride=stride,
                      acc_chunk=acc_chunk, overlap=overlap, block_k=block_k)
    return interleave(acc)


def _check(a, a_dtype, w_packed, n_seg, overlap, acc_chunk):
    if not w_packed.is_cuda or a.device != w_packed.device:
        raise ValueError("activations and packed weights must be on the same CUDA device")
    if a.dtype != a_dtype or w_packed.dtype != torch.int32:
        raise TypeError(f"expected {a_dtype} activations and int32 packed weights, "
                        f"got {a.dtype} and {w_packed.dtype}")
    if a.ndim != 2 or w_packed.ndim != 2 or a.shape[1] != w_packed.shape[0]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(w_packed.shape)}")
    if not (a.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("packed matmul operands must be contiguous")
    if n_seg not in KERNEL_N_SEG or overlap not in (0, 1) or acc_chunk < 1:
        raise ValueError(f"no kernel for n_seg={n_seg}, overlap={overlap}, acc_chunk={acc_chunk}")
    if max(a.shape[0], a.shape[1], w_packed.shape[1] * n_seg) >= 2**31:
        raise ValueError("dimension exceeds int32 indexing")


def packed_dense_fused_raw(
    x: torch.Tensor,  # [M, K] float32 activations (clipped to [0, 1] in the kernel)
    w_packed: torch.Tensor,  # [K, N // n_seg] int32 packed weight levels
    *,
    a_bits: int,
    n_seg: int,
    stride: int,
    acc_chunk: int,
    overlap: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: quantize + whole-K packed dot + peel + row sums in one launch."""
    if not x.is_cuda:
        return packed_dense_fused_plain(x, w_packed, a_bits=a_bits, n_seg=n_seg, stride=stride,
                                        acc_chunk=acc_chunk, overlap=overlap)
    _check(x, torch.float32, w_packed, n_seg, overlap, acc_chunk)
    m, k = x.shape
    np_ = w_packed.shape[1]
    acc = torch.empty((m, np_ * n_seg), dtype=torch.int32, device=x.device)
    a_sum = torch.empty((m,), dtype=torch.int32, device=x.device)
    lib = build.library("packed_matmul")
    err = lib.packed_dense_fused(
        x.data_ptr(), w_packed.data_ptr(), acc.data_ptr(), a_sum.data_ptr(),
        m, k, np_, a_bits, n_seg, stride, acc_chunk, overlap,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "packed_dense_fused")
    build.launched("packed_dense_fused")
    return acc, a_sum


def packed_matmul_raw(
    a_lvl: torch.Tensor,  # [M, K] int32 activation levels
    w_packed: torch.Tensor,  # [K, N // n_seg] int32 packed weight levels
    *,
    n_seg: int,
    stride: int,
    acc_chunk: int,
    overlap: int = 0,
    block_k: int | None = None,
) -> torch.Tensor:
    """K2: packed dot of activation levels; chunks restart every ``block_k``."""
    if not a_lvl.is_cuda:
        return packed_matmul_plain(a_lvl, w_packed, n_seg=n_seg, stride=stride,
                                   acc_chunk=acc_chunk, overlap=overlap, block_k=block_k)
    _check(a_lvl, torch.int32, w_packed, n_seg, overlap, acc_chunk)
    if block_k is not None and block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    m, k = a_lvl.shape
    np_ = w_packed.shape[1]
    acc = torch.empty((m, np_ * n_seg), dtype=torch.int32, device=a_lvl.device)
    lib = build.library("packed_matmul")
    err = lib.packed_matmul(
        a_lvl.data_ptr(), w_packed.data_ptr(), acc.data_ptr(),
        m, k, np_, n_seg, stride, acc_chunk, overlap, block_k or 0,
        torch.cuda.current_stream(a_lvl.device).cuda_stream,
    )
    build.check(lib, err, "packed_matmul")
    build.launched("packed_matmul")
    return acc
