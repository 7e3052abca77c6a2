"""int8-lane matmuls: CUDA kernels K4/K5 and their plain versions.

K4 ``quant_matmul_raw`` replaces the TPU kernel
``repro/kernels/quant_matmul/kernel.py:63 quant_matmul_raw``: an int8 x
int8 -> int32 dot, then one float multiply by the combined scale.  K5
``quant_packed_matmul_raw`` replaces ``kernel.py:103
quant_packed_matmul_raw``: int8 activation levels times int8 words that
each pack ``n_seg`` sub-4-bit weight levels (``TPU_MXU7`` placements),
decoded by the segment peel.  Both are ``csrc/quant_matmul.cu``; see that
file for what bounds them on the card.

The plans of both live here, where the CPU tests reach them: K4's row
tile by M (:func:`k4_bm`), :data:`K4_PLAN` and :data:`K5_PLAN` (K1/K2's
``grid_plan`` with each kernel's tile), :func:`slab_chunks` and
:func:`k5_chunk_plan` (which rows each tensor-core accumulator that K5
decodes may hold) and :func:`copy_width` (the weight copy path, from the
row width alone).  A K split reuses K1/K2's workspace and per-stream
arrival counters (``packed_matmul.kernel._split_scratch``).

Given CUDA tensors a wrapper launches its kernel or raises; given CPU
tensors it runs the plain version (``*_plain`` below).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_matmul.kernel import _split_scratch
from repro_torch.kernels.packed_matmul.ref import matmul_levels
from repro_torch.kernels.peel import interleave, peel_chunks

# segment counts K5 is instantiated for: choose_mxu_config packs 2 segments
# for every bit pair in 2..8 x 2..8 that has an int8-lane placement
KERNEL_N_SEG = (2,)

# K4's tile (csrc/quant_matmul.cu, namespace k4): BM activation rows (by M,
# k4_bm) x 128 weight columns a block; K in slabs of 32 rows (one m16n8k32
# mma), a K split at least one ring stage of 128 rows and at most 8 ranges:
# the last block's sum of the splits' partials grows with their number
# (perf/k4_variants.py: wk|wv at M = 8 takes 5.95 us in 8 ranges, 7.15 in 24)
K4_BN, K4_SLAB, K4_TK = 128, 32, 128
K4_BMS = (8, 32, 64, 128)
K4_MAX_K = 1 << 17  # int8 x int8 sums over fewer rows fit int32
K4_PLAN = dict(bn=K4_BN, align=K4_SLAB, min_k=K4_TK, max_splits=8)  # grid_plan's keywords, with bm=k4_bm(m)

# K5's tile (csrc/quant_matmul.cu, namespace k5): 8 activation rows x 64
# packed columns a block; K in slabs of 16 rows (one m16n8k16 mma), a K
# split at least 64 rows (half a ring stage)
K5_BM, K5_BN, K5_SLAB = 8, 64, 16
K5_PLAN = dict(bm=K5_BM, bn=K5_BN, align=K5_SLAB, min_k=64)  # grid_plan's keywords for K5


def k4_bm(m: int) -> int:
    """K4's row tile: the smallest of :data:`K4_BMS` that holds ``m`` rows,
    else 128, so that a block's staged weights serve up to 128 rows."""
    return next((bm for bm in K4_BMS if m <= bm), K4_BMS[-1])


def slab_chunks(acc_chunk: int, slab: int = K5_SLAB) -> list[tuple[int, int]]:
    """Row ranges ``[lo, hi)`` of one k16 slab that K5 gives an mma of
    their own: ``min(acc_chunk, slab)`` rows each, the last one cut at the
    slab's end."""
    ch = min(acc_chunk, slab)
    return [(lo, min(lo + ch, slab)) for lo in range(0, slab, ch)]


def k5_chunk_plan(k: int, acc_chunk: int) -> list[tuple[int, int]]:
    """Every accumulation chunk K5 decodes over ``[0, k)``: slabs start at
    multiples of 16 (a K split starts on one too), each cut by
    :func:`slab_chunks`; rows past ``k`` meet zero weights and are dropped."""
    return [(s0 + lo, min(s0 + hi, k)) for s0 in range(0, k, K5_SLAB)
            for lo, hi in slab_chunks(acc_chunk) if s0 + lo < k]


def copy_width(np_: int) -> int:
    """Bytes per weight copy of K4's and K5's rings: 16 needs a row stride
    (``np_`` bytes) that is a multiple of 16, 4 a multiple of 4; other
    widths take byte loads (same ring, exact)."""
    return 16 if np_ % 16 == 0 else 4 if np_ % 4 == 0 else 1


def quant_matmul_plain(a_i8, w_i8, w_scale):
    """Plain version of K4: ``float32(a @ w) * w_scale`` -> [M, N] float32."""
    return matmul_levels(a_i8, w_i8).to(torch.float32) * w_scale


def quant_packed_matmul_plain(a_i8, w_packed_i8, *, n_seg, stride, acc_chunk, overlap=0):
    """Plain version of K5: ``acc [M, N] int32`` (int8 operands widen with
    their sign, as the reference's int8 -> int32 dot)."""
    acc = peel_chunks(a_i8.to(torch.int32), w_packed_i8.to(torch.int32), n_seg=n_seg,
                      stride=stride, acc_chunk=acc_chunk, overlap=overlap)
    return interleave(acc)


def _check(a, w):
    if not w.is_cuda or a.device != w.device:
        raise ValueError("activations and weights must be on the same CUDA device")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"expected int8 activations and int8 weights, got {a.dtype} and {w.dtype}")
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(w.shape)}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("int8 matmul operands must be contiguous")
    if max(a.shape[0] * a.shape[1], w.shape[0] * w.shape[1]) >= 2**31:
        raise ValueError("operand exceeds int32 indexing")


def quant_matmul_raw(
    a_i8: torch.Tensor,  # [M, K] int8 levels
    w_i8: torch.Tensor,  # [K, N] int8 levels
    w_scale: torch.Tensor,  # [1, N] float32 combined (w x a) scales
) -> torch.Tensor:
    """K4: int8 dot, rescaled once -> [M, N] float32."""
    if not a_i8.is_cuda:
        return quant_matmul_plain(a_i8, w_i8, w_scale)
    _check(a_i8, w_i8)
    m, k = a_i8.shape
    n = w_i8.shape[1]
    if w_scale.dtype != torch.float32 or w_scale.numel() != n or w_scale.device != a_i8.device:
        raise ValueError(f"w_scale must be float32 [1, {n}] on the operands' device")
    if k >= K4_MAX_K:
        raise ValueError(f"K = {k} >= {K4_MAX_K}: int8 x int8 sums could overflow int32")
    scale = w_scale.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a_i8.device)
    bm = k4_bm(m)
    copy = copy_width(n)
    while w_i8.data_ptr() % copy:  # a view that starts off the copy's alignment
        copy = 4 if copy == 16 else 1
    splits, kps, ws, counters = _split_scratch(a_i8.device, m, k, n, bm * K4_BN, bm=bm, **K4_PLAN)
    lib = build.library("quant_matmul")
    err = lib.quant_matmul(
        a_i8.data_ptr(), w_i8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(),
        m, k, n, bm, copy, splits, kps, torch.cuda.current_stream(a_i8.device).cuda_stream,
    )
    build.check(lib, err, "quant_matmul")
    build.launched("quant_matmul")
    return out


def quant_packed_matmul_raw(
    a_i8: torch.Tensor,  # [M, K] int8 unsigned activation levels (< 2**a_bits)
    w_packed_i8: torch.Tensor,  # [K, N // n_seg] int8 packed weight levels
    *,
    n_seg: int,
    stride: int,
    acc_chunk: int,
    overlap: int = 0,
) -> torch.Tensor:
    """K5: segment-packed dot inside the int8 lane + peel -> [M, N] int32."""
    if not a_i8.is_cuda:
        return quant_packed_matmul_plain(a_i8, w_packed_i8, n_seg=n_seg, stride=stride,
                                         acc_chunk=acc_chunk, overlap=overlap)
    _check(a_i8, w_packed_i8)
    if n_seg not in KERNEL_N_SEG or overlap not in (0, 1) or acc_chunk < 1 or not 1 <= stride <= 7:
        raise ValueError(f"no kernel for n_seg={n_seg}, stride={stride}, overlap={overlap}, "
                         f"acc_chunk={acc_chunk}")
    if overlap and acc_chunk >= 1 << stride:
        raise ValueError(f"acc_chunk={acc_chunk} >= 2**stride: the parity bit would not be exact")
    m, k = a_i8.shape
    np_ = w_packed_i8.shape[1]
    copy = copy_width(np_)
    if w_packed_i8.data_ptr() % copy:
        raise ValueError(f"packed weights of width {np_} must start on a {copy}-byte boundary")
    acc = torch.empty((m, np_ * n_seg), dtype=torch.int32, device=a_i8.device)
    splits, kps, ws, counters = _split_scratch(a_i8.device, m, k, np_, K5_BM * K5_BN * n_seg, **K5_PLAN)
    lib = build.library("quant_matmul")
    err = lib.quant_packed_matmul(
        a_i8.data_ptr(), w_packed_i8.data_ptr(), acc.data_ptr(),
        None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(),
        m, k, np_, n_seg, stride, acc_chunk, overlap, copy, splits, kps,
        torch.cuda.current_stream(a_i8.device).cuda_stream,
    )
    build.check(lib, err, "quant_packed_matmul")
    build.launched("quant_packed_matmul")
    return acc
