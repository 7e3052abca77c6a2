"""The premises of K5's tensor-core design and K6's output tiles, on the CPU.

The CUDA kernels cannot run here, so their plans are kept as small Python
helpers beside the wrappers (``quant_matmul/kernel.py``: ``slab_chunks``,
``k5_chunk_plan``, ``K5_PLAN``, ``copy_width``; ``filter_conv/kernel.py``:
``tile_plan``, ``tile_windows``) and held here against what the kernels
rely on: every chunk that K5 decodes holds at most ``acc_chunk`` products,
a plain emulation of K5's chunked decode gives the plain version's integers
(and the JAX kernel's) at every int8-lane placement, K5's shared-memory
layouts are free of bank conflicts, and K6's tiles give every output
position one owner whose window reaches all its products.  Inputs are made
with numpy from a seed; integer results must be bit-exact.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.filter_conv.kernel import filter_conv_raw as ref_filter_conv_raw
from repro.kernels.quant_matmul.kernel import quant_packed_matmul_raw as ref_quant_packed_raw
from repro_torch.kernels.filter_conv import ref as fc
from repro_torch.kernels.filter_conv.kernel import (
    SMEM_WORDS,
    THREADS,
    filter_conv_plain,
    halo,
    tile_plan,
    tile_windows,
)
from repro_torch.kernels.filter_conv.ops import choose_filter_config
from repro_torch.kernels.packed_matmul import ref as pm
from repro_torch.kernels.packed_matmul.kernel import N_COUNTERS, grid_plan
from repro_torch.kernels.peel import interleave, lsb_mask, peel_chunk
from repro_torch.kernels.quant_matmul.kernel import (
    K5_BN,
    K5_PLAN,
    K5_SLAB,
    copy_width,
    k5_chunk_plan,
    quant_packed_matmul_plain,
    slab_chunks,
)
from repro_torch.kernels.quant_matmul.ops import choose_mxu_config

BITS = range(2, 9)


def _placements(chooser, *extra):
    """Every distinct placement ``chooser`` picks over bit pairs 2..8 x 2..8
    (and ``extra`` arguments), with the first pair that picks it."""
    seen = {}
    for w_bits, a_bits, overpack in itertools.product(BITS, BITS, (True, False)):
        cfg = chooser(w_bits, a_bits, *extra, allow_overpack=overpack)
        if cfg is not None and tuple(cfg) not in seen:
            seen[tuple(cfg)] = ((w_bits, a_bits), cfg)
    return list(seen.values())


MXU = _placements(choose_mxu_config)


# -- K5 --------------------------------------------------------------------------


def test_every_int8_lane_placement_is_covered():
    assert sorted(tuple(c) for _, c in MXU) == [(2, 5, 3, 0), (2, 5, 3, 1), (2, 5, 7, 1)]


@pytest.mark.parametrize("acc_chunk", [1, 2, 3, 7, 15, 16, 18])
def test_k5_chunk_plan_partitions_k_into_chunks_of_at_most_acc_chunk(acc_chunk):
    for k in (1, 2, 9, 15, 16, 17, 40, 517, 3072, 8192):
        plan = k5_chunk_plan(k, acc_chunk)
        assert plan[0][0] == 0 and plan[-1][1] == k
        for (lo, hi), (nxt, _) in zip(plan, plan[1:] + [(k, None)]):
            assert lo < hi == nxt, (k, lo, hi)
            assert hi - lo <= acc_chunk
            assert lo // K5_SLAB == (hi - 1) // K5_SLAB  # one mma's slab
    assert slab_chunks(7) == [(0, 7), (7, 14), (14, 16)]
    assert len(slab_chunks(3)) == 6 and slab_chunks(18) == [(0, 16)]


def _emulate_k5(a, wp, cfg, chunks, groups):
    """K5's arithmetic in int64 numpy: each chunk's own masked dot, segment 0
    decoded per chunk from the packed sum and the parity dot on segment 1's
    LSB plane (peel.cuh peel_low2), the unmasked packed sum of each group of
    chunks (a warp's slabs, a K split), and segment 1 = (sum - segment 0) >>
    stride per group, the groups then added."""
    s = cfg.stride
    seg0_total = np.zeros((a.shape[0], wp.shape[1]), np.int64)
    seg1_total = np.zeros_like(seg0_total)
    for group in groups:
        seg0 = np.zeros_like(seg0_total)
        packed = np.zeros_like(seg0_total)
        for lo, hi in (chunks[i] for i in group):
            part = a[:, lo:hi] @ wp[lo:hi]
            packed += part
            if cfg.overlap:
                par_hi = (a[:, lo:hi] & 1) @ (wp[lo:hi] & (1 << s))
                assert not (par_hi & ((1 << s) - 1)).any()
                seg0 += (part ^ par_hi) & ((2 << s) - 1)
            else:
                seg0 += part & ((1 << s) - 1)
        diff = packed - seg0
        assert not (diff & ((1 << s) - 1)).any() and (diff >= 0).all()
        seg0_total += seg0
        seg1_total += diff >> s
    return np.stack([seg0_total, seg1_total], axis=-1).reshape(a.shape[0], -1)


@pytest.mark.parametrize("pair,cfg", MXU, ids=[f"{tuple(c)}" for _, c in MXU])
@pytest.mark.parametrize("operands", ["max", "random"])
@pytest.mark.parametrize("m,k,n_groups", [(8, 517, 12), (3, 40, 5), (1, 9, 1)])
def test_k5_emulation_matches_plain_and_the_integer_dot(pair, cfg, operands, m, k, n_groups):
    """At all-maximum operands every chunk sum sits at the placement's bound:
    the additive-parity peel of each chunk (peel.py) and K5's decode (segment
    0 per chunk, segment 1 from the packed sum, per warp of slabs) both give
    the plain version's integers and ``a @ w``."""
    w_bits, a_bits = pair
    rng = np.random.default_rng(k + n_groups)
    if operands == "max":
        a = np.full((m, k), (1 << a_bits) - 1, np.int64)
        w_lvl = np.full((k, n_groups * cfg.n_seg), (1 << w_bits) - 1, np.int64)
    else:
        a = rng.integers(0, 1 << a_bits, (m, k)).astype(np.int64)
        w_lvl = rng.integers(0, 1 << w_bits, (k, n_groups * cfg.n_seg)).astype(np.int64)
    wp = pm.pack_weights(torch.from_numpy(w_lvl).to(torch.int32), cfg.n_seg, cfg.stride).numpy()
    wp = wp.astype(np.int64)
    want = a @ w_lvl
    plain = quant_packed_matmul_plain(torch.from_numpy(a.astype(np.int8)),
                                      torch.from_numpy(wp.astype(np.int8)), n_seg=cfg.n_seg,
                                      stride=cfg.stride, acc_chunk=cfg.acc_chunk,
                                      overlap=cfg.overlap).numpy()
    np.testing.assert_array_equal(plain, want)

    chunks = k5_chunk_plan(k, cfg.acc_chunk)
    # the additive parity dot and peel.py's peel_chunk, chunk by chunk
    acc = [torch.zeros((m, wp.shape[1]), dtype=torch.int32) for _ in range(cfg.n_seg)]
    for lo, hi in chunks:
        part = torch.from_numpy(a[:, lo:hi] @ wp[lo:hi]).to(torch.int32)
        parity = None
        if cfg.overlap:
            mask = lsb_mask(cfg.n_seg, cfg.stride)
            par = (a[:, lo:hi] & 1) @ (wp[lo:hi] & mask)
            parity = torch.from_numpy(par).to(torch.int32)
            # the bit the peel reads is the bit K5's one-plane parity dot gives
            par_hi = (a[:, lo:hi] & 1) @ (wp[lo:hi] & (1 << cfg.stride))
            assert ((par >> cfg.stride) & 1 == (par_hi >> cfg.stride) & 1).all()
        for d, val in enumerate(peel_chunk(part, parity, n_seg=cfg.n_seg, stride=cfg.stride)):
            acc[d] += val
    np.testing.assert_array_equal(interleave(torch.stack(acc)).numpy(), want)

    # K5's decode: warp w of a block takes slabs w, w + 8, ...; K split in
    # two ranges of whole slabs, as a split launch would
    slab_of = [lo // K5_SLAB for lo, _ in chunks]
    half = (max(slab_of) + 1) // 2
    groups = [[i for i, sl in enumerate(slab_of) if (sl < half) == first and sl % 8 == w]
              for first in (True, False) for w in range(8)]
    groups = [gr for gr in groups if gr]
    np.testing.assert_array_equal(_emulate_k5(a, wp, cfg, chunks, groups), want)


@pytest.mark.parametrize("pair,cfg", MXU, ids=[f"{tuple(c)}" for _, c in MXU])
def test_k5_emulation_matches_the_jax_kernel(pair, cfg):
    """K5's decode emulated at all-maximum operands against the reference's
    Pallas kernel (interpret mode) on the same int8 words: bit-exact."""
    w_bits, a_bits = pair
    m, k, n_groups = 5, 83, 6
    a = np.full((m, k), (1 << a_bits) - 1, np.int8)
    w_lvl = np.full((k, n_groups * cfg.n_seg), (1 << w_bits) - 1, np.int32)
    wp = pm.pack_weights(torch.from_numpy(w_lvl), cfg.n_seg, cfg.stride).to(torch.int8).numpy()
    chunks = k5_chunk_plan(k, cfg.acc_chunk)
    ours = _emulate_k5(a.astype(np.int64), wp.astype(np.int64), cfg, chunks, [list(range(len(chunks)))])
    theirs = ref_quant_packed_raw(jnp.asarray(a), jnp.asarray(wp), n_seg=cfg.n_seg, stride=cfg.stride,
                                  acc_chunk=cfg.acc_chunk, overlap=cfg.overlap, block_m=8, block_n=8,
                                  block_k=16)
    np.testing.assert_array_equal(ours, np.asarray(theirs))


# llama3.2-3b at full width, w2a2 (n_seg 2): (K, Np) of every decode matmul
DECODE_SHAPES = {"wq|wo": (3072, 1536), "wk|wv": (3072, 512), "w_up|w_gate": (3072, 4096),
                 "w_down": (8192, 1536), "head": (3072, 64128)}


@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
@pytest.mark.parametrize("m", [1, 8, 128])
def test_k5_grid_plan_covers_k_in_whole_slabs_and_fills_an_h100(shape, m):
    k, np_ = DECODE_SHAPES[shape]
    splits, kps = grid_plan(m, k, np_, 132, **K5_PLAN)
    assert (splits - 1) * kps < k <= splits * kps
    tiles = -(-m // 8) * -(-np_ // K5_BN)
    assert tiles <= N_COUNTERS
    if splits > 1:
        assert kps % K5_SLAB == 0 and kps >= 64
    assert tiles * splits >= 132 or splits == 32 or kps == 64  # every SM busy, or K cut as far as allowed
    assert copy_width(np_) == 16


def test_k5_copy_path_follows_the_packed_width():
    assert [copy_width(n) for n in (64, 1536, 36, 20, 75, 7, 1)] == [16, 16, 4, 4, 1, 1, 1]


def _ring_offset(row, gran):
    """Twin of csrc/quant_matmul.cu ring_offset."""
    line = row >> 1
    gi = (((row & 1) << 2) | gran) ^ (((line >> 1) & 3) << 1)
    return line * 128 + gi * 16


def test_k5_ring_layout_is_a_bijection_without_bank_conflicts():
    """The swizzled stage layout holds each 16-byte granule of a 128 x 64
    byte tile once; the fragment reads (lane (g, t) takes 8 bytes of row 4t +
    r of its warp's slab, a half-warp per pass) and the 16-byte copies (8
    lanes per pass) touch every bank at most once a pass."""
    offs = {_ring_offset(row, gran) for row in range(128) for gran in range(4)}
    assert offs == set(range(0, 128 * 64, 16))
    for warp, r in itertools.product(range(8), range(4)):
        for half in (0, 1):
            banks = []
            for lane in range(16 * half, 16 * half + 16):
                g, t = lane >> 2, lane & 3
                addr = _ring_offset(warp * 16 + 4 * t + r, g >> 1) + (g & 1) * 8
                banks += [(addr // 4) % 32, (addr // 4 + 1) % 32]
            assert len(set(banks)) == 32, (warp, r, half)
    for first in range(0, 512, 8):  # COPY 16: thread i copies granule i % 4 of row i / 4
        banks = []
        for i in range(first, first + 8):
            addr = _ring_offset(i >> 2, i & 3)
            banks += [(addr // 4 + j) % 32 for j in range(4)]
        assert len(set(banks)) == 32


@pytest.mark.parametrize("rows", [96, 288, 768, 3072, 4096])
def test_k5_activation_pitch_gives_each_lane_its_own_bank(rows):
    pitch = -(-rows // 128) * 128 + 16  # csrc/quant_matmul.cu act_ld
    for k0 in range(0, rows, 16):
        banks = {((g * pitch + k0 + 4 * t) // 4) % 32 for g in range(8) for t in range(4)}
        assert len(banks) == 32


# -- K6 --------------------------------------------------------------------------

# phase 7's UltraNet row shapes (B, C, N), ragged N, C = 1, B = 1, and a C
# that needs several staged pieces
FILTER_SHAPES = [(160, 3, 320), (80, 16, 160), (40, 32, 80), (20, 64, 40), (10, 64, 20),
                 (3, 6, 19), (2, 1, 300), (1, 5, 7), (2, 3000, 9)]
FILTERS = {k: _placements(choose_filter_config, k) for k in (3, 5, 7)}


@pytest.mark.parametrize("k_len", [3, 5, 7])
def test_tile_plan_gives_every_output_one_owner_whose_window_reaches_it(k_len):
    for (_, cfg), (b, c, n) in itertools.product(FILTERS[k_len], FILTER_SHAPES):
        n_pad = -(-n // cfg.n_p) * cfg.n_p
        n_sc, n_fc = n_pad // cfg.n_p, -(-k_len // cfg.k_p)
        nseg = cfg.k_p + cfg.n_p - 1
        n_out = n + k_len - 1
        plan = tile_plan(b, c, n_out, cfg.k_p, cfg.n_p, n_fc, cfg.acc_chunk, 132)
        label = (tuple(cfg), k_len, b, c, n, plan)
        # channel slices start on chunk boundaries; a piece holds whole slices
        # unless all C fit; shared memory within the budget
        assert plan.cs % cfg.acc_chunk == 0 and plan.cs >= 1, label
        assert plan.cp == c or plan.cp % plan.cs == 0 or plan.cp < plan.cs, label
        assert plan.T + plan.cp * (plan.nv_max + n_fc) <= SMEM_WORDS, label
        assert plan.blocks == b * -(-n_out // plan.T), label
        assert -(-c // plan.cs) * n_fc * plan.nv_max <= 2 * THREADS or plan.cs >= c or plan.T == 2, label
        wins = tile_windows(n_out, n_sc, plan.T, cfg.k_p, cfg.n_p, n_fc)
        owner = np.full(n_out, -1)
        for i, (t0, t1, v_lo, v_hi) in enumerate(wins):
            assert (owner[t0:t1] == -1).all(), label
            owner[t0:t1] = i
            assert v_hi - v_lo + 1 <= plan.nv_max, label
        assert (owner >= 0).all(), label
        # every product lands in the tile of its position, from a v the tile stages
        reach = halo(cfg.k_p, cfg.n_p, n_fc)
        assert reach == (n_fc - 1) * cfg.k_p + nseg - 1
        for v, u, m in itertools.product(range(n_sc), range(n_fc), range(nseg)):
            pos = v * cfg.n_p + u * cfg.k_p + m
            if pos < n_out:
                _, _, v_lo, v_hi = wins[owner[pos]]
                assert v_lo <= v <= v_hi, (label, v, u, m)


def _emulate_k6(s_pad, fp, cfg, k_len, n_len, plan):
    """K6's tiles in numpy: per tile, per piece of ``cp`` channels, per slice
    of ``cs`` channels, per chunk of at most ``acc_chunk``, the packed dot
    and its parity peeled by peel.py; decoded coefficients added into the
    tile; each tile written once."""
    b, c, n_pad = s_pad.shape
    n_p, k_p, st = cfg.n_p, cfg.k_p, cfg.stride
    n_fc, nseg = fp.shape[1], cfg.k_p + cfg.n_p - 1
    n_sc, n_out = n_pad // n_p, n_len + k_len - 1
    shifts = np.arange(n_p) * st
    sp = (s_pad.reshape(b, c, n_sc, n_p).astype(np.int64) << shifts).sum(-1)
    out = np.full((b, n_out), -(1 << 40), np.int64)
    for t0, t1, v_lo, v_hi in tile_windows(n_out, n_sc, plan.T, k_p, n_p, n_fc):
        tile = np.zeros((b, plan.T), np.int64)
        for c_base in range(0, c, plan.cp):
            cn = min(plan.cp, c - c_base)
            for c_lo, v, u in itertools.product(range(0, cn, plan.cs), range(v_lo, v_hi + 1), range(n_fc)):
                dec = [0] * nseg
                c_hi = min(cn, c_lo + plan.cs)
                for cc in range(c_lo, c_hi, cfg.acc_chunk):
                    ch = slice(c_base + cc, c_base + min(c_hi, cc + cfg.acc_chunk))
                    part = (sp[:, ch, v] * fp[ch, u]).sum(1)
                    par = None
                    if cfg.overlap:
                        par = torch.from_numpy(((sp[:, ch, v] & lsb_mask(n_p, st))
                                                * (fp[ch, u] & lsb_mask(k_p, st))).sum(1))
                    vals = peel_chunk(torch.from_numpy(part), par, n_seg=nseg, stride=st)
                    dec = [d + val.numpy() for d, val in zip(dec, vals)]
                for m in range(nseg):
                    pos = v * n_p + u * k_p + m - t0
                    if 0 <= pos < plan.T:
                        tile[:, pos] += dec[m]
        out[:, t0:t1] = tile[:, : t1 - t0]
    return out


@pytest.mark.parametrize("w_bits,a_bits,k_len", [(2, 2, 3), (3, 4, 3), (4, 4, 3), (2, 2, 7), (3, 3, 5)])
@pytest.mark.parametrize("operands", ["max", "random"])
@pytest.mark.parametrize("b,c,n,sms", [(3, 6, 19, 132), (2, 9, 23, 4), (1, 1, 5, 132), (2, 70, 6, 132)])
def test_k6_tile_emulation_matches_plain_and_the_convolution(w_bits, a_bits, k_len, operands, b, c, n, sms):
    """Tiles with their halos, channel slices and pieces give the plain
    version's integers and the true convolution, at all-maximum operands
    (every chunk sum at its bound) and random ones."""
    cfg = choose_filter_config(w_bits, a_bits, k_len)
    rng = np.random.default_rng(b + c + n)
    if operands == "max":
        s = np.full((b, c, n), (1 << a_bits) - 1, np.int32)
        f = np.full((c, k_len), (1 << w_bits) - 1, np.int32)
    else:
        s = rng.integers(0, 1 << a_bits, (b, c, n)).astype(np.int32)
        f = rng.integers(0, 1 << w_bits, (c, k_len)).astype(np.int32)
    n_pad = -(-n // cfg.n_p) * cfg.n_p
    s_pad = np.pad(s, ((0, 0), (0, 0), (0, n_pad - n)))
    fp = fc.pack_filter(torch.from_numpy(f), cfg.k_p, cfg.stride)
    n_fc = fp.shape[1]
    plan = tile_plan(b, c, n + k_len - 1, cfg.k_p, cfg.n_p, n_fc, cfg.acc_chunk, sms)
    ours = _emulate_k6(s_pad, fp.numpy().astype(np.int64), cfg, k_len, n, plan)
    kw = dict(k_p=cfg.k_p, n_p=cfg.n_p, stride=cfg.stride, acc_chunk=cfg.acc_chunk, k_len=k_len,
              n_len=n, overlap=cfg.overlap)
    plain = filter_conv_plain(torch.from_numpy(s_pad), fp, **kw).numpy()
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, fc.conv_full_levels(torch.from_numpy(f), torch.from_numpy(s)).numpy())


def test_k6_tile_emulation_matches_the_jax_kernel():
    """One overpacked 4-coefficient case against the reference's Pallas
    kernel (interpret mode) on the same packed operands: bit-exact."""
    cfg = choose_filter_config(2, 2, 3)
    rng = np.random.default_rng(3)
    b, c, n, k_len = 2, 9, 21, 3
    s = rng.integers(0, 4, (b, c, n)).astype(np.int32)
    f = rng.integers(0, 4, (c, k_len)).astype(np.int32)
    n_pad = -(-n // cfg.n_p) * cfg.n_p
    s_pad = np.pad(s, ((0, 0), (0, 0), (0, n_pad - n)))
    fp = fc.pack_filter(torch.from_numpy(f), cfg.k_p, cfg.stride).numpy()
    plan = tile_plan(b, c, n + k_len - 1, cfg.k_p, cfg.n_p, fp.shape[1], cfg.acc_chunk, 8)
    ours = _emulate_k6(s_pad, fp.astype(np.int64), cfg, k_len, n, plan)
    theirs = ref_filter_conv_raw(jnp.asarray(s_pad), jnp.asarray(fp), k_p=cfg.k_p, n_p=cfg.n_p,
                                 stride=cfg.stride, acc_chunk=cfg.acc_chunk, k_len=k_len, n_len=n,
                                 overlap=cfg.overlap)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
