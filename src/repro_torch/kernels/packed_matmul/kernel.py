"""Kernel-Packing matmul: CUDA kernels K1/K2 and their plain versions.

K1 ``packed_dense_fused_raw`` replaces the TPU kernel
``repro/kernels/packed_matmul/kernel.py:111 packed_dense_fused_raw``:
it quantizes float activations in the kernel, runs the whole-K packed
dot with the chunked peel, interleaves segments to channel order and
sums each row's levels.  K2 ``packed_matmul_raw`` replaces
``kernel.py:168 packed_matmul_raw``: the same packed dot on activation
levels, with chunks restarting at every multiple of ``block_k``.  Both
are ``csrc/packed_matmul.cu`` (peel in ``csrc/peel.cuh``); see that file
for what bounds them on the card and how the design answers it.

Both also take a leading expert axis, ``x [E, M, K]`` and ``w_packed [E,
K, Np]``, in one launch (the expert on a grid axis): the reference vmaps
its kernels over experts for MoE (``repro/models/moe.py:84
_expert_matmul``).

The launch geometry lives here, where the CPU tests reach it:
:func:`grid_plan` splits K across blocks to fill the card, and
:func:`uses_vector_copy` picks the weight copy path from the packed width
alone.  A K split needs a workspace of partial sums (allocated per launch)
and one arrival counter per output tile, which the kernel leaves at zero.
The counters are zeroed once per device and cut into one slot per CUDA
stream (:class:`CounterSlots`), so split launches on two streams never
share a counter; every kernel that splits K (K4 and K5 in
``quant_matmul`` too) takes its counters from :func:`_split_scratch`.

Given CUDA tensors a wrapper launches its kernel or raises; given CPU
tensors it runs the plain version (``*_plain`` below).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.peel import interleave, peel_chunks

# segment counts the CUDA kernels are instantiated for: every placement
# choose_config selects for bit pairs 2..8 x 2..8 packs 2 or 3 segments
KERNEL_N_SEG = (2, 3)

# the kernels' tile: BM activation rows x BN packed columns (csrc/packed_matmul.cu)
BM, BN = 8, 64
BLOCKS_PER_SM = 2  # resident 256-thread blocks an SM at n_seg = 2
MAX_SPLITS = 32
MIN_K_PER_SPLIT = 32  # half a ring stage
N_COUNTERS = 1 << 16  # arrival counters per device, one slot of them per stream


@functools.lru_cache(maxsize=4096)
def grid_plan(m: int, k: int, np_: int, sms: int, *, bm: int = BM, bn: int = BN, align: int = 1,
              min_k: int = MIN_K_PER_SPLIT, max_splits: int = MAX_SPLITS,
              batch: int = 1) -> tuple[int, int]:
    """``(splits, k_per_split)`` for ``batch`` ``[m, k] x [k, np_]``
    products in one launch on a card of ``sms`` SMs, with blocks of ``bm``
    rows x ``bn`` packed columns (K1/K2's tile by default; K4 and K5 pass
    their own).  One block per (matrix, row tile, column tile, K split);
    when the tiles of all ``batch`` matrices fill fewer than
    ``BLOCKS_PER_SM`` blocks an SM, K is split into at most ``max_splits``
    equal ranges of at least ``min_k`` rows, each a multiple of ``align``,
    choosing the split count whose blocks fill the last wave best (a larger
    count must fill it more than 2 % better), so that every SM moves about
    the same bytes."""
    tiles = batch * -(-m // bm) * -(-np_ // bn)
    cap = BLOCKS_PER_SM * sms
    if k <= 0 or tiles >= cap:
        return 1, max(k, 1)
    best = (0.0, 1, k)
    for s in range(1, min(max_splits, -(-k // min_k)) + 1):
        kps = -(-k // s)
        kps = -(-kps // align) * align
        splits = -(-k // kps)
        units = tiles * splits
        fill = units / (-(-units // cap) * cap)
        if fill > best[0] + 0.02:
            best = (fill, splits, kps)
    return best[1], best[2]


def uses_vector_copy(np_: int) -> bool:
    """16-byte weight copies need a row stride of ``np_ * 4`` bytes that is
    a multiple of 16; other widths take 4-byte copies (same ring, exact)."""
    return np_ % 4 == 0


class CounterSlots:
    """Which slot of a device's arrival counters each stream's split
    launches use: a stream gets the next free slot at its first split
    launch and keeps it, so two streams never share a counter.  Assigning
    a slot allocates nothing, so it may happen inside a graph capture; it
    raises only when all ``n_slots`` are taken."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._of: dict[int, int] = {}

    def slot(self, stream: int) -> int:
        s = self._of.get(stream)
        if s is None:
            if len(self._of) == self.n_slots:
                raise RuntimeError(f"split-K launch: all {self.n_slots} counter slots are taken "
                                   f"by other streams")
            s = self._of[stream] = len(self._of)
        return s


# per device: (the zeroed counters, their slots, counters a slot)
_COUNTERS: dict[int, tuple[torch.Tensor, CounterSlots, int]] = {}


def _split_scratch(dev: torch.device, m: int, k: int, np_: int, slab: int, *, bm: int = BM,
                   bn: int = BN, batch: int = 1, **plan):
    """``(splits, k_per_split, workspace, counters)`` of one launch of
    ``batch`` products with blocks of ``bm`` x ``bn`` that each leave
    ``slab`` int32 partials when K is split (``plan``: :func:`grid_plan`'s
    other keywords); the last two, one slab a block and one counter an
    output tile of each matrix, are None when K is not split.
    ``counters`` is the current stream's slot of the device's arrival
    counters: ``BLOCKS_PER_SM`` x SMs of them, more than a split launch has
    output tiles (:func:`grid_plan` splits only below that).  The array is allocated at the device's first split
    launch, which must not be inside a graph capture.  A captured graph
    keeps the counters of its capture stream: a replay must not overlap a
    split launch on that stream or another replay of the same graph.  The
    engine's step program (``serving/engine.py StepProgram``) therefore
    captures on a stream of its own, so two engines' graphs hold two slots,
    and replays its graph serially: each step waits for its logits."""
    sms = sm_count(dev)
    splits, kps = grid_plan(m, k, np_, sms, bm=bm, bn=bn, batch=batch, **plan)
    if splits == 1:
        return splits, kps, None, None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    entry = _COUNTERS.get(idx)
    if entry is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("split-K launch: launch once before capturing a CUDA graph, so that "
                               "its split-K counters are allocated outside the graph")
        size = BLOCKS_PER_SM * sms
        entry = _COUNTERS[idx] = (torch.zeros(N_COUNTERS, dtype=torch.int32, device=dev),
                                  CounterSlots(N_COUNTERS // size), size)
    counters, slots, size = entry
    slot = slots.slot(torch.cuda.current_stream(dev).cuda_stream)
    units = batch * -(-m // bm) * -(-np_ // bn) * splits
    ws = torch.empty(units * slab, dtype=torch.int32, device=dev)
    return splits, kps, ws, counters[slot * size:(slot + 1) * size]


def packed_dense_fused_plain(x, w_packed, *, a_bits, n_seg, stride, acc_chunk, overlap=0):
    """Plain version of K1: ``(acc [M, N] int32, a_sum [M] int32)``, or
    ``[E, M, N]`` and ``[E, M]`` batched over experts."""
    n_lvl = (1 << a_bits) - 1
    a = torch.round(torch.clamp(x.to(torch.float32), 0.0, 1.0) * n_lvl).to(torch.int32)
    acc = peel_chunks(a, w_packed, n_seg=n_seg, stride=stride,
                      acc_chunk=acc_chunk, overlap=overlap)
    return interleave(acc), torch.sum(a, dim=-1, dtype=torch.int32)


def packed_matmul_plain(a_lvl, w_packed, *, n_seg, stride, acc_chunk, overlap=0, block_k=None):
    """Plain version of K2: ``acc [M, N] int32`` (``[E, M, N]`` batched)."""
    acc = peel_chunks(a_lvl, w_packed, n_seg=n_seg, stride=stride,
                      acc_chunk=acc_chunk, overlap=overlap, block_k=block_k)
    return interleave(acc)


def _check(a, a_dtype, w_packed, n_seg, stride, overlap, acc_chunk):
    if not w_packed.is_cuda or a.device != w_packed.device:
        raise ValueError("activations and packed weights must be on the same CUDA device")
    if a.dtype != a_dtype or w_packed.dtype != torch.int32:
        raise TypeError(f"expected {a_dtype} activations and int32 packed weights, "
                        f"got {a.dtype} and {w_packed.dtype}")
    if (a.ndim not in (2, 3) or w_packed.ndim != a.ndim or a.shape[-1] != w_packed.shape[-2]
            or a.shape[:-2] != w_packed.shape[:-2]):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(w_packed.shape)}")
    if not (a.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("packed matmul operands must be contiguous")
    if n_seg not in KERNEL_N_SEG or overlap not in (0, 1) or acc_chunk < 1:
        raise ValueError(f"no kernel for n_seg={n_seg}, overlap={overlap}, acc_chunk={acc_chunk}")
    if overlap and acc_chunk >= 1 << stride:
        raise ValueError(f"acc_chunk={acc_chunk} >= 2**stride: the XOR parity word would not be exact")
    if overlap and n_seg == 2 and stride < BM:
        raise ValueError(f"stride={stride} < {BM}: no room for every row's parity bit in one word")
    if max(a.shape[-2], a.shape[-1], w_packed.shape[-1] * n_seg) >= 2**31:
        raise ValueError("dimension exceeds int32 indexing")
    if a.ndim == 3 and a.shape[0] > 65535:
        raise ValueError(f"{a.shape[0]} experts exceed the grid's y extent (65535)")
    if uses_vector_copy(w_packed.shape[-1]) and w_packed.data_ptr() % 16:
        raise ValueError("packed weights of a width divisible by 4 must start on a 16-byte boundary")


def packed_dense_fused_raw(
    x: torch.Tensor,  # [M, K] or [E, M, K] float32 activations (clipped to [0, 1] in the kernel)
    w_packed: torch.Tensor,  # [K, N // n_seg] or [E, K, N // n_seg] int32 packed weight levels
    *,
    a_bits: int,
    n_seg: int,
    stride: int,
    acc_chunk: int,
    overlap: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: quantize + whole-K packed dot + peel + row sums in one launch;
    with a leading expert axis ``E``, all E products in that launch."""
    if not x.is_cuda:
        return packed_dense_fused_plain(x, w_packed, a_bits=a_bits, n_seg=n_seg, stride=stride,
                                        acc_chunk=acc_chunk, overlap=overlap)
    _check(x, torch.float32, w_packed, n_seg, stride, overlap, acc_chunk)
    lead, (m, k), np_ = x.shape[:-2], x.shape[-2:], w_packed.shape[-1]
    e = x.shape[0] if lead else 1
    acc = torch.empty(lead + (m, np_ * n_seg), dtype=torch.int32, device=x.device)
    a_sum = torch.empty(lead + (m,), dtype=torch.int32, device=x.device)
    splits, kps, ws, counters = _split_scratch(x.device, m, k, np_, BM * (BN * n_seg + 1), batch=e)
    lib = build.library("packed_matmul")
    err = lib.packed_dense_fused(
        x.data_ptr(), w_packed.data_ptr(), acc.data_ptr(), a_sum.data_ptr(),
        None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(),
        e, m, k, np_, a_bits, n_seg, stride, acc_chunk, overlap, int(uses_vector_copy(np_)),
        splits, kps, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "packed_dense_fused")
    build.launched("packed_dense_fused")
    return acc, a_sum


def packed_matmul_raw(
    a_lvl: torch.Tensor,  # [M, K] or [E, M, K] int32 activation levels
    w_packed: torch.Tensor,  # [K, N // n_seg] or [E, K, N // n_seg] int32 packed weight levels
    *,
    n_seg: int,
    stride: int,
    acc_chunk: int,
    overlap: int = 0,
    block_k: int | None = None,
) -> torch.Tensor:
    """K2: packed dot of activation levels; chunks restart every ``block_k``
    (a leading expert axis as K1's)."""
    if not a_lvl.is_cuda:
        return packed_matmul_plain(a_lvl, w_packed, n_seg=n_seg, stride=stride,
                                   acc_chunk=acc_chunk, overlap=overlap, block_k=block_k)
    _check(a_lvl, torch.int32, w_packed, n_seg, stride, overlap, acc_chunk)
    if block_k is not None and block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    lead, (m, k), np_ = a_lvl.shape[:-2], a_lvl.shape[-2:], w_packed.shape[-1]
    e = a_lvl.shape[0] if lead else 1
    acc = torch.empty(lead + (m, np_ * n_seg), dtype=torch.int32, device=a_lvl.device)
    splits, kps, ws, counters = _split_scratch(a_lvl.device, m, k, np_, BM * (BN * n_seg + 1), batch=e)
    lib = build.library("packed_matmul")
    err = lib.packed_matmul(
        a_lvl.data_ptr(), w_packed.data_ptr(), acc.data_ptr(),
        None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(),
        e, m, k, np_, n_seg, stride, acc_chunk, overlap, block_k or 0, int(uses_vector_copy(np_)),
        splits, kps, torch.cuda.current_stream(a_lvl.device).cuda_stream,
    )
    build.check(lib, err, "packed_matmul")
    build.launched("packed_matmul")
    return acc
