"""Paged-KV gather: CUDA kernel K3 and its plain version.

K3 ``paged_gather_raw`` replaces the TPU kernel
``repro/kernels/paged_gather/kernel.py:121 paged_gather_raw``: it
gathers each slot's pages through the block table into
``[S, n_blocks, page_size, D]`` K and V views, writes zeros for the null
page 0, dequantizes int8 pages as ``level.to(out) * scale.to(out)``, and
emits the causal / sliding-window lane mask ``[S, C, n_blocks, page_size]``.
The kernel is ``csrc/paged_gather.cu``; on int8 pools its launch is
:func:`gather_plan`'s (row groups of a page, one block each, and which
units, the levels of one 16-byte store, each thread takes: :func:`group_units`).

Given CUDA tensors the wrapper launches the kernel or raises; given CPU
tensors it runs :func:`paged_gather_plain` (``pool[block_table]`` +
where + iota mask).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

_FLOAT_OUT = (torch.float32, torch.bfloat16)

# gather_i8's blocks (csrc/paged_gather.cu): about I8_THREADS threads taking
# I8_VPT units each (a unit: the levels of one 16-byte store of a view, 8 at
# bf16 and 4 at float32; the kernel's VPT), at most I8_MAX_THREADS threads;
# chosen on the H100 with perf/k3_variants.py
I8_THREADS, I8_VPT, I8_MAX_THREADS = 256, 4, 512


def unit_levels(out_dtype: torch.dtype) -> int:
    """Levels of one 16-byte store of a view of ``out_dtype``."""
    return 16 // out_dtype.itemsize


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    rows: int  # page rows a block (a divisor of page_size)
    vpt: int  # units a thread takes from each pool
    threads: int  # threads a block, a multiple of 32
    grid: tuple[int, int]  # (S * n_blocks page slots, page_size // rows row groups)


def gather_plan(S: int, n_blocks: int, page_size: int, width: int, levels: int, *,
                vpt: int = I8_VPT, threads: int = I8_THREADS) -> GatherPlan:
    """gather_i8's launch for units of ``levels`` levels: block ``(x, y)``
    owns page slot ``x = s * n_blocks + b`` and its rows ``[y * rows, (y +
    1) * rows)`` in both pools; ``rows`` is the largest divisor of
    ``page_size`` whose ``rows * width / levels`` units ``threads`` threads
    take ``vpt`` at a time, and the block has just enough threads (whole
    warps) for them.  The kernel is built for ``vpt = I8_VPT``; other
    values describe its variants (``perf/k3_variants.py``)."""
    if width % 16 or page_size <= 0:
        raise ValueError(f"int8 pool width {width} must be a multiple of 16")
    upr = width // levels
    rows = max(r for r in range(1, page_size + 1) if page_size % r == 0 and (r == 1 or r * upr <= vpt * threads))
    t = 32 * -(-rows * upr // (32 * vpt))  # ceil(units / vpt), whole warps
    if t > I8_MAX_THREADS:
        raise ValueError(f"a page row of width {width} needs {t} gather_i8 threads, more than {I8_MAX_THREADS}")
    return GatherPlan(rows=rows, vpt=vpt, threads=t, grid=(S * n_blocks, page_size // rows))


def group_units(plan: GatherPlan, width: int, levels: int, y: int, t: int) -> list[tuple[int, int]]:
    """``(page row, unit of the row)`` that thread ``t`` of a block of row
    group ``y`` loads, dequantizes and stores in each pool, in the kernel's
    order: units ``t, t + threads, ...`` of the group."""
    upr = width // levels
    n = plan.rows * upr
    return [(y * plan.rows + j // upr, j % upr)
            for j in (t + k * plan.threads for k in range(plan.vpt)) if j < n]


def paged_gather_plain(block_table, pos, window, pool_k, pool_v, k_scale=None, v_scale=None,
                       *, chunk, out_dtype, zero_null=True):
    """Plain version: ``pool[block_table]``, null pages zeroed, + lane mask.

    ``zero_null=False`` keeps the null page's contents, as the reference's
    ``pool[block_table]`` ("xla") view does; only the lanes of inactive
    slots, whose outputs are never sampled, can see the difference."""
    n_blocks = block_table.shape[1]
    page_size = pool_k.shape[1]
    table = block_table.long()
    live = (block_table != 0)[..., None, None]

    def gather(pool, scale):
        view = pool[table].to(out_dtype)
        if scale is not None:
            view = view * scale[table].to(out_dtype)
        return torch.where(live, view, torch.zeros_like(view)) if zero_null else view

    dev = pool_k.device
    kpos = torch.arange(n_blocks * page_size, dtype=torch.int32, device=dev).reshape(
        1, 1, n_blocks, page_size)
    posc = (pos.to(torch.int32)[:, None]
            + torch.arange(chunk, dtype=torch.int32, device=dev)[None])[:, :, None, None]
    mask = kpos <= posc
    if window > 0:
        mask = mask & ((posc - kpos) < window)
    return gather(pool_k, k_scale), gather(pool_v, v_scale), mask


def _check(block_table, pos, pool_k, pool_v, k_scale, v_scale, out_dtype):
    dev = pool_k.device
    tensors = [block_table, pos, pool_k, pool_v] + (
        [k_scale, v_scale] if pool_k.dtype == torch.int8 else [])
    if any(t is None or t.device != dev for t in tensors):
        raise ValueError("paged gather operands must share one CUDA device "
                         "(int8 pools need k_scale/v_scale)")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged gather operands must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned for the vector loads")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("block_table and pos must be int32")
    if pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype:
        raise ValueError("K and V pools must match in shape and dtype")
    if pos.shape != (block_table.shape[0],):
        raise ValueError(f"pos shape {tuple(pos.shape)} does not match {tuple(block_table.shape)}")
    if pool_k.dtype == torch.int8:
        if out_dtype not in _FLOAT_OUT:
            raise TypeError(f"int8 pools dequantize to float32 or bfloat16, not {out_dtype}")
        if k_scale.dtype != torch.float32 or k_scale.shape != pool_k.shape[:2] + (1,) \
                or v_scale.shape != k_scale.shape or v_scale.dtype != torch.float32:
            raise ValueError("k_scale/v_scale must be float32 [n_pages, page_size, 1]")
        if pool_k.shape[2] % 16:
            raise ValueError("int8 pool width must be a multiple of 16")
    elif pool_k.dtype != out_dtype:
        raise TypeError(f"fp pool of {pool_k.dtype} gathers to its own dtype, not {out_dtype}")
    elif pool_k.shape[2] * pool_k.element_size() % 16:
        raise ValueError("pool rows must be a multiple of 16 bytes")


def paged_gather_raw(
    block_table: torch.Tensor,  # [S, n_blocks] int32 page ids (0 = null page)
    pos: torch.Tensor,  # [S] int32 first query position per slot
    window: int,  # <= 0: full causal; > 0: sliding window
    pool_k: torch.Tensor,  # [n_pages, page_size, D] float or int8 levels
    pool_v: torch.Tensor,
    k_scale: torch.Tensor | None = None,  # [n_pages, page_size, 1] float32 (int8 pools)
    v_scale: torch.Tensor | None = None,
    *,
    chunk: int,
    out_dtype: torch.dtype,
):
    """K3: ``(k_view, v_view [S, n_blocks, page_size, D], mask [S, C, n_blocks, page_size])``."""
    window = int(window)
    if not pool_k.is_cuda:
        return paged_gather_plain(block_table, pos, window, pool_k, pool_v, k_scale, v_scale,
                                  chunk=chunk, out_dtype=out_dtype)
    _check(block_table, pos, pool_k, pool_v, k_scale, v_scale, out_dtype)
    S, n_blocks = block_table.shape
    _, page_size, width = pool_k.shape
    dev = pool_k.device
    k_out = torch.empty((S, n_blocks, page_size, width), dtype=out_dtype, device=dev)
    v_out = torch.empty_like(k_out)
    mask = torch.empty((S, chunk, n_blocks, page_size), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.library("paged_gather")
    if pool_k.dtype == torch.int8:
        plan = gather_plan(S, n_blocks, page_size, width, unit_levels(out_dtype))
        err = lib.paged_gather_i8(
            block_table.data_ptr(), pos.data_ptr(), window, pool_k.data_ptr(),
            pool_v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), k_out.data_ptr(),
            v_out.data_ptr(), mask.data_ptr(), S, n_blocks, page_size, width, chunk,
            int(out_dtype == torch.bfloat16), plan.rows, plan.threads, stream,
        )
    else:
        err = lib.paged_gather_fp(
            block_table.data_ptr(), pos.data_ptr(), window, pool_k.data_ptr(),
            pool_v.data_ptr(), k_out.data_ptr(), v_out.data_ptr(), mask.data_ptr(),
            S, n_blocks, page_size, width * pool_k.element_size(), chunk, stream,
        )
    build.check(lib, err, "paged_gather")
    build.launched("paged_gather")
    return k_out, v_out, mask
