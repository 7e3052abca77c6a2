"""Plain PyTorch chunked packed dot + segment peel (``repro.kernels.peel``).

This is the plain version of both packed matmul kernels
(``csrc/packed_matmul.cu``, whose device peel is ``csrc/peel.cuh``).
The CPU tests hold it against the JAX kernels; ``chip_smoke.py`` holds
the CUDA kernels against it on the card.

## No-overpack peel (overlap == 0)

Every segment sum fits ``stride`` bits: segment d of a chunk's packed
sum is ``(part >> d*stride) & mask``.

## Overpacked peel (overlap == 1, Fig. 3)

Each segment sum may need ``stride + 1`` bits.  The stolen bit is
recovered from a second integer dot of the operand LSBs,
``parity = dot(a & 1, wp & LSB_MASK)``, whose stride-aligned counters
hold every segment's true LSB in bit 0; segments then peel bottom-up,
the top one keeping all remaining bits.

## Integer arithmetic in torch

PyTorch has no int32 (or int64) matmul on CUDA.  On the card the chunk
dot runs in float64, which is exact: every chunk sum is below 2**30
(the ``TPU_VPU15`` bound) and float64 holds integers up to 2**53.  On
the CPU the int32 matmul is exact.  ``>>`` on int32 is an arithmetic
shift where the reference uses ``shift_right_logical``; the two agree
while the packed sums are non-negative, which :func:`peel_chunks`
checks.
"""
from __future__ import annotations

import torch


def lsb_mask(n_seg: int, stride: int) -> int:
    """Mask selecting each segment's LSB (bit ``d*stride``) of a packed word."""
    return sum(1 << (d * stride) for d in range(n_seg))


def chunk_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ w`` for one accumulation chunk."""
    if a.is_cuda:
        return (a.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
    return a.to(torch.int32) @ w.to(torch.int32)


def peel_chunks(
    a: torch.Tensor,  # [M, K] activation levels
    wp: torch.Tensor,  # [K, Np] packed weight words
    *,
    n_seg: int,
    stride: int,
    acc_chunk: int,
    overlap: int,
    block_k: int | None = None,
) -> torch.Tensor:
    """Chunked packed dot + segment peel -> ``[n_seg, M, Np]`` int32.

    Chunks hold at most ``acc_chunk`` products and restart at every
    multiple of ``block_k`` (the reference's K tiles); any such chunking
    gives the same integers."""
    m, k = a.shape
    np_ = wp.shape[1]
    mask = (1 << stride) - 1
    wmask = lsb_mask(n_seg, stride)
    acc = torch.zeros((n_seg, m, np_), dtype=torch.int32, device=a.device)
    negative = torch.zeros((), dtype=torch.bool, device=a.device)
    bk = k if block_k is None else block_k
    for kb in range(0, k, bk):
        for c0 in range(kb, min(kb + bk, k), acc_chunk):
            c1 = min(c0 + acc_chunk, kb + bk, k)
            w = wp[c0:c1]
            part = chunk_dot(a[:, c0:c1], w)
            negative |= (part < 0).any()
            if overlap:
                parity = chunk_dot(a[:, c0:c1] & 1, w & wmask)
                p = part
                for d in range(n_seg):
                    if d == n_seg - 1:
                        val = p  # the top segment keeps all remaining bits
                    else:
                        low = p & mask
                        bit_p = (p >> stride) & 1
                        lsb_next = (parity >> ((d + 1) * stride)) & 1
                        val = low + ((bit_p ^ lsb_next) << stride)
                        p = (p - val) >> stride
                    acc[d] += val
            else:
                for d in range(n_seg):
                    acc[d] += (part >> (d * stride)) & mask
    if bool(negative):
        raise ValueError("packed partial sum went negative: placement bound violated")
    return acc


def interleave(acc: torch.Tensor) -> torch.Tensor:
    """Channel order: ``out[:, j*n_seg + d] = acc[d, :, j]``."""
    n_seg, m, np_ = acc.shape
    return acc.permute(1, 2, 0).reshape(m, np_ * n_seg)
