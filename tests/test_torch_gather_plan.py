"""K3's launch plan on int8 pools, on the CPU.

The CUDA kernel (``csrc/paged_gather.cu gather_i8``) cannot run here, so its
work split is kept as a small Python helper beside the wrapper
(``paged_gather/kernel.py``: ``gather_plan``, ``group_units``) and held
here against what the kernel relies on: every (slot, block, page row,
unit) of the views has exactly one owning thread (a unit: the levels of one
16-byte store, 8 at bf16 views and 4 at float32), and a plain
emulation of the split, block by block in the kernel's arithmetic, gives
the plain version's bits and the JAX kernel's (interpret mode).  Inputs are
made with numpy from a seed; results must be bit-exact.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_gather import ref as ref_pg
from repro.kernels.paged_gather.kernel import paged_gather_raw as ref_paged_gather_raw
from repro_torch.kernels.paged_gather.kernel import (
    I8_MAX_THREADS,
    I8_VPT,
    gather_plan,
    group_units,
    paged_gather_plain,
    unit_levels,
)

WIDTHS = (256, 512, 1024, 1536, 2048)  # kv_heads x head_dim of the registry's archs
PAGE_SIZES = (8, 16, 32)


OUT_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("S,nb", list(itertools.product((1, 8, 32), (1, 16, 256))))
@pytest.mark.parametrize("page_size", PAGE_SIZES)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("out", list(OUT_DTYPES))
def test_every_unit_has_one_owner(out, width, page_size, S, nb):
    """Block ``(x, y)`` takes page slot ``x`` (``s = x // nb``, ``b = x % nb``,
    as the kernel divides) and row group ``y``; its threads' units depend
    on ``y`` alone.  So every (slot, block, row, unit) has one owner iff
    ``x`` covers the page slots once and the (group, thread, k) triples
    cover a page's ``page_size x width / levels`` units once."""
    levels = unit_levels(OUT_DTYPES[out])
    plan = gather_plan(S, nb, page_size, width, levels)
    upr = width // levels
    assert plan.threads % 32 == 0 and 0 < plan.threads <= I8_MAX_THREADS and plan.vpt == I8_VPT
    assert page_size % plan.rows == 0 and plan.grid == (S * nb, page_size // plan.rows)
    assert plan.threads * plan.vpt >= plan.rows * upr  # the C entry point's coverage check
    assert sorted(divmod(x, nb) for x in range(plan.grid[0])) == list(itertools.product(range(S), range(nb)))
    owners = np.zeros((page_size, upr), np.int64)
    for y, t in itertools.product(range(plan.grid[1]), range(plan.threads)):
        for row, u in group_units(plan, width, levels, y, t):
            owners[row, u] += 1
    assert (owners == 1).all()


def _emulate(plan, table, pos, window, pool_k, pool_v, k_scale, v_scale, *, chunk, out_dtype):
    """``gather_i8`` block by block: each block reads its table entry, takes
    its threads' units (``t + k * threads``), zeroes them for the null page
    or widens each level to float, multiplies it by the row's scale
    (rounded to bf16 first at a bf16 output) and rounds once; then it
    writes its rows' mask lanes.  Unwritten views stay NaN, unwritten
    mask lanes 2, so a hole shows."""
    S, nb = table.shape
    _, ps, D = pool_k.shape
    levels = unit_levels(out_dtype)
    upr = D // levels
    views = [torch.full((S * nb, ps, upr, levels), float("nan"), dtype=out_dtype) for _ in range(2)]
    mask = torch.full((S, chunk, nb, ps), 2, dtype=torch.uint8)
    t = torch.arange(plan.threads)
    j = (t[:, None] + torch.arange(plan.vpt)[None] * plan.threads).reshape(-1)
    j = j[j < plan.rows * upr]
    for x, y in itertools.product(range(plan.grid[0]), range(plan.grid[1])):
        s, b = divmod(x, nb)
        page = int(table[s, b])
        row, col = y * plan.rows + j // upr, j % upr
        for out, pool, scale in zip(views, (pool_k, pool_v), (k_scale, v_scale)):
            if page == 0:
                out[x, row, col] = 0
                continue
            lvl = pool[page].reshape(ps, upr, levels)[row, col].to(torch.float32)
            sc = scale[page, row, 0][:, None]
            if out_dtype == torch.bfloat16:
                out[x, row, col] = (lvl * sc.to(torch.bfloat16).to(torch.float32)).to(torch.bfloat16)
            else:
                out[x, row, col] = lvl * sc
        r0 = y * plan.rows
        kpos = b * ps + torch.arange(r0, r0 + plan.rows)[None]
        posc = int(pos[s]) + torch.arange(chunk)[:, None]
        m = kpos <= posc
        if window > 0:
            m &= (posc - kpos) < window
        mask[s, :, b, r0:r0 + plan.rows] = m.to(torch.uint8)
    assert not (mask == 2).any(), "a mask lane has no owner"
    return (*(v.reshape(S, nb, ps, D) for v in views), mask.bool())


def _int8_operands(S, nb, ps, D, seed):
    """The reference's allocator-faithful fixture, quantized per row, with
    NaN scales on the null page (whose levels hold garbage)."""
    ops = ref_pg.make_operands(ref_pg.GatherCase(n_slots=S, n_blocks=nb, page_size=ps, width=D,
                                                 int8=True, seed=seed))
    for name in ("k_scale", "v_scale"):
        ops[name][0] = np.nan
    return ops


def _torch_args(ops, window):
    return (torch.from_numpy(ops["block_table"]), torch.from_numpy(ops["pos"]), window,
            torch.from_numpy(ops["pool_k"]), torch.from_numpy(ops["pool_v"]),
            torch.from_numpy(ops["k_scale"]), torch.from_numpy(ops["v_scale"]))


@pytest.mark.parametrize("plan_kw", [{}, {"threads": 32}], ids=["plan", "small-blocks"])
@pytest.mark.parametrize("window,chunk", [(0, 1), (40, 1), (0, 16), (40, 16)])
@pytest.mark.parametrize("out", list(OUT_DTYPES))
def test_emulated_split_matches_the_plain_version(out, window, chunk, plan_kw):
    """At D = 1024 (several row groups a page) and D = 48 (6 or 12 units a
    row: threads past a group's units idle), the default plan and one
    forced to blocks of as few rows as 32 threads take."""
    for S, nb, ps, D, seed in ((3, 4, 16, 1024, 1), (4, 5, 16, 48, 2)):
        ops = _int8_operands(S, nb, ps, D, seed)
        args = _torch_args(ops, window)
        plan = gather_plan(S, nb, ps, D, unit_levels(OUT_DTYPES[out]), **plan_kw)
        got = _emulate(plan, *args, chunk=chunk, out_dtype=OUT_DTYPES[out])
        want = paged_gather_plain(*args, chunk=chunk, out_dtype=OUT_DTYPES[out])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (S, nb, ps, D, plan)


@pytest.mark.parametrize("window,chunk", [(0, 1), (40, 1), (0, 16), (40, 16)])
@pytest.mark.parametrize("out", list(OUT_DTYPES))
def test_emulated_split_matches_the_jax_kernel(out, window, chunk):
    """Against ``repro.kernels.paged_gather.kernel.paged_gather_raw`` (Pallas,
    interpret mode) at 4 slots x 6 blocks of 8 rows, D = 32, forced to
    small row groups (several a page)."""
    S, nb, ps, D = 4, 6, 8, 32
    ops = _int8_operands(S, nb, ps, D, seed=3 + window + chunk)
    jdt = jnp.bfloat16 if out == "bf16" else jnp.float32
    rk, rv, rm = ref_paged_gather_raw(
        jnp.asarray(ops["block_table"]), jnp.asarray(ops["pos"]), jnp.asarray(window),
        *(jnp.asarray(ops[k]) for k in ("pool_k", "pool_v", "k_scale", "v_scale")),
        chunk=chunk, out_dtype=jdt,
    )
    plan = gather_plan(S, nb, ps, D, unit_levels(OUT_DTYPES[out]), threads=2)
    assert plan.grid[1] > 1
    k, v, m = _emulate(plan, *_torch_args(ops, window), chunk=chunk, out_dtype=OUT_DTYPES[out])
    for ours, theirs in ((k, rk), (v, rv)):
        np.testing.assert_array_equal(ours.to(torch.float32).numpy(), np.asarray(theirs, np.float32))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
