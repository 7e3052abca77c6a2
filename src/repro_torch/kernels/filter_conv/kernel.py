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

Given CUDA tensors the wrapper launches the kernel or raises; given CPU
tensors it runs :func:`filter_conv_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.peel import lsb_mask, peel_chunk

# coefficients per packed multiply (k_p + n_p - 1) the kernel is
# instantiated for: every placement choose_filter_config selects for bit
# pairs 2..8 x 2..8 and filters of 3, 5 or 7 taps
KERNEL_NSEG = (2, 3, 4)


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
    out = torch.empty((b, n_out), dtype=torch.int32, device=s_lvl.device)
    lib = build.library("filter_conv")
    err = lib.filter_conv(
        s_lvl.data_ptr(), f_packed.data_ptr(), out.data_ptr(), b, c, n_pad, n_fc, k_p, n_p,
        stride, acc_chunk, overlap, n_out, torch.cuda.current_stream(s_lvl.device).cuda_stream,
    )
    build.check(lib, err, "filter_conv")
    build.launched("filter_conv")
    return out
