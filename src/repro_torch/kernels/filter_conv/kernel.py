"""Filter-Packing 1-D convolution: CUDA kernel K6 and its plain version.

K6 ``filter_conv_raw`` replaces the TPU kernel
``repro/kernels/filter_conv/kernel.py:155 filter_conv_raw``: the full
convolution of every sequence row with its channel's filter, summed over
the channels, where one packed multiply of ``n_p`` sequence levels by
``k_p`` filter taps yields ``k_p + n_p - 1`` coefficients (the paper's
Filter Packing, Eq. 2), channel chunks of at most ``acc_chunk`` are
summed before the decode, and overpacked placements recover the stolen
bit with the Fig. 3 parity dot.  The kernel is ``csrc/filter_conv.cu``;
see that file for what bounds it on the card.

The kernel's tile plan lives here, where the CPU tests reach it:
:func:`tile_plan` picks the output tile per block, the channels per slice
and per staged piece from the shape, and :func:`tile_windows` gives each
tile's output positions and the sequence chunks whose products reach them.

Given CUDA tensors the wrapper launches the kernel or raises; given CPU
tensors it runs :func:`filter_conv_plain`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.peel import lsb_mask, peel_chunk

# coefficients per packed multiply (k_p + n_p - 1) the kernel is
# instantiated for: every placement choose_filter_config selects for bit
# pairs 2..8 x 2..8 and filters of 3, 5 or 7 taps
KERNEL_NSEG = (2, 3, 4)

# the kernel's block (csrc/filter_conv.cu) and its plan's choices
THREADS = 128
TILES = (256, 128, 64, 32, 16, 8, 4, 2)  # output positions per block, largest first
SMEM_WORDS = 12 * 1024  # int32 words of shared memory a block may use (48 KB)


class TilePlan(NamedTuple):
    """``T`` output positions per block, ``cs`` channels per slice, ``cp``
    channels staged at a time, ``nv_max`` sequence chunks a tile's window
    holds at most, ``blocks`` of the launch."""

    T: int
    cs: int
    cp: int
    nv_max: int
    blocks: int


def halo(k_p: int, n_p: int, n_fc: int) -> int:
    """Positions a packed product reaches past its sequence chunk's first:
    ``u * k_p + m`` at most, over filter chunks u and segments m."""
    return (n_fc - 1) * k_p + k_p + n_p - 2


def tile_plan(b: int, c: int, n_out: int, k_p: int, n_p: int, n_fc: int, acc_chunk: int,
              sms: int) -> TilePlan:
    """The kernel's launch plan for ``b`` rows of ``n_out`` outputs and ``c``
    channels.  The tile is the largest of :data:`TILES` whose blocks cover
    ``sms`` SMs while each thread stages at most 4 sequence words and one
    slice of every (v, u) item fits twice into the block's threads (else
    the smallest); then the channels are cut into as many slices (each a
    multiple of ``acc_chunk``) as the threads left over hold, and staged in
    pieces that fit :data:`SMEM_WORDS`."""
    h = halo(k_p, n_p, n_fc)

    def nv_max(t):
        return (t - 1 + h) // n_p + 1

    T = TILES[-1]
    for t in TILES:
        if (nv_max(t) * n_fc <= 2 * THREADS and c * nv_max(t) <= 4 * THREADS
                and b * -(-n_out // t) >= sms):
            T = t
            break
    nv = nv_max(T)
    n_chunks = max(1, -(-c // acc_chunk))
    slices = max(1, min(n_chunks, THREADS // (nv * n_fc)))
    cs = acc_chunk * -(-n_chunks // slices)
    cp = max(1, min(c, (SMEM_WORDS - T) // (nv + n_fc)))
    if cs <= cp < c:
        cp -= cp % cs  # pieces of whole slices
    return TilePlan(T=T, cs=cs, cp=cp, nv_max=nv, blocks=b * -(-n_out // T))


def tile_windows(n_out: int, n_sc: int, T: int, k_p: int, n_p: int, n_fc: int
                 ) -> list[tuple[int, int, int, int]]:
    """``(t0, t1, v_lo, v_hi)`` of every tile of a row, as the kernel
    computes them: positions ``[t0, t1)`` and the sequence chunks
    ``v_lo .. v_hi`` whose windows ``[v n_p, v n_p + halo]`` meet them."""
    h = halo(k_p, n_p, n_fc)
    out = []
    for t0 in range(0, n_out, T):
        v_lo = 0 if t0 - h <= 0 else -(-(t0 - h) // n_p)
        v_hi = min(n_sc - 1, (t0 + T - 1) // n_p)
        out.append((t0, min(t0 + T, n_out), v_lo, v_hi))
    return out


def filter_conv_plain(s_lvl, f_packed, *, k_p, n_p, stride, acc_chunk, k_len, n_len, overlap=0):
    """Plain version of K6: ``[B, n_len + k_len - 1]`` int32.

    Elementwise int32 products and sums (exact: the placement keeps every
    packed sum below 2**31), the same peel as the kernel, and each decoded
    coefficient added at offset ``u*k_p + v*n_p + m`` of the output row."""
    b, c, n_pad = s_lvl.shape
    n_fc = f_packed.shape[1]
    n_sc = n_pad // n_p
    nseg = k_p + n_p - 1
    dev = s_lvl.device
    shifts = torch.arange(n_p, dtype=torch.int32, device=dev) * stride
    s_pack = torch.sum(s_lvl.to(torch.int32).reshape(b, c, n_sc, n_p) << shifts, dim=-1,
                       dtype=torch.int32)  # [B, C, n_sc]
    fp = f_packed.to(torch.int32)
    s_lsb, fp_lsb = s_pack & lsb_mask(n_p, stride), fp & lsb_mask(k_p, stride)
    out = torch.zeros((b, n_sc * n_p + (n_fc - 1) * k_p + nseg), dtype=torch.int32, device=dev)
    negative = torch.zeros((), dtype=torch.bool, device=dev)
    for u in range(n_fc):
        dec = torch.zeros((nseg, b, n_sc), dtype=torch.int32, device=dev)
        for c0 in range(0, c, acc_chunk):
            c1 = min(c0 + acc_chunk, c)
            part = torch.sum(s_pack[:, c0:c1] * fp[c0:c1, u, None], dim=1, dtype=torch.int32)
            negative |= (part < 0).any()
            parity = (torch.sum(s_lsb[:, c0:c1] * fp_lsb[c0:c1, u, None], dim=1, dtype=torch.int32)
                      if overlap else None)
            for m, val in enumerate(peel_chunk(part, parity, n_seg=nseg, stride=stride)):
                dec[m] += val
        for m in range(nseg):
            base = u * k_p + m
            out[:, base:base + n_sc * n_p:n_p] += dec[m]
    if bool(negative):
        raise ValueError("packed partial sum went negative: placement bound violated")
    return out[:, : n_len + k_len - 1]


def filter_conv_raw(
    s_lvl: torch.Tensor,  # [B, C, N_pad] int32 levels (N_pad a multiple of n_p)
    f_packed: torch.Tensor,  # [C, ceil(K / k_p)] int32 packed filter chunks
    *,
    k_p: int,
    n_p: int,
    stride: int,
    acc_chunk: int,
    k_len: int,
    n_len: int,
    overlap: int = 0,
) -> torch.Tensor:
    """K6: full convolution summed over channels -> [B, n_len + k_len - 1] int32."""
    kw = dict(k_p=k_p, n_p=n_p, stride=stride, acc_chunk=acc_chunk, k_len=k_len, n_len=n_len,
              overlap=overlap)
    if not s_lvl.is_cuda:
        return filter_conv_plain(s_lvl, f_packed, **kw)
    if not f_packed.is_cuda or f_packed.device != s_lvl.device:
        raise ValueError("sequence levels and packed filter must be on the same CUDA device")
    if s_lvl.dtype != torch.int32 or f_packed.dtype != torch.int32:
        raise TypeError(f"expected int32 operands, got {s_lvl.dtype} and {f_packed.dtype}")
    if not (s_lvl.is_contiguous() and f_packed.is_contiguous()):
        raise ValueError("filter conv operands must be contiguous")
    b, c, n_pad = s_lvl.shape
    n_fc = f_packed.shape[1]
    if f_packed.shape[0] != c or n_pad % n_p or n_len > n_pad or k_len > n_fc * k_p:
        raise ValueError(f"shape mismatch: s {tuple(s_lvl.shape)}, packed filter "
                         f"{tuple(f_packed.shape)}, n_p={n_p}, k_p={k_p}, N={n_len}, K={k_len}")
    if k_p + n_p - 1 not in KERNEL_NSEG or overlap not in (0, 1) or acc_chunk < 1:
        raise ValueError(f"no kernel for k_p={k_p}, n_p={n_p}, overlap={overlap}, "
                         f"acc_chunk={acc_chunk}")
    if b > 65535 or s_lvl.numel() >= 2**31:
        raise ValueError("batch exceeds the grid or operand exceeds int32 indexing")
    n_out = n_len + k_len - 1
    plan = tile_plan(b, c, n_out, k_p, n_p, n_fc, acc_chunk, sm_count(s_lvl.device))
    out = torch.empty((b, n_out), dtype=torch.int32, device=s_lvl.device)
    lib = build.library("filter_conv")
    err = lib.filter_conv(
        s_lvl.data_ptr(), f_packed.data_ptr(), out.data_ptr(), b, c, n_pad, n_fc, k_p, n_p,
        stride, acc_chunk, overlap, n_out, plan.T, plan.cs, plan.cp, plan.nv_max,
        torch.cuda.current_stream(s_lvl.device).cuda_stream,
    )
    build.check(lib, err, "filter_conv")
    build.launched("filter_conv")
    return out
