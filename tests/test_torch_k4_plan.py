"""The premises of K4's tensor-core design and of the per-stream split-K
counters, on the CPU.

K4 (``csrc/quant_matmul.cu``, namespace ``k4``) cannot run here, so its plan
is kept as small Python helpers beside the wrapper (``quant_matmul/kernel.py``:
``k4_bm``, ``K4_PLAN``, ``copy_width``) and held here against what the kernel
relies on: the grid plan covers K in whole 32-row slabs and fills an H100,
the row tile follows M, the swizzled ring stage is a bijection free of bank
conflicts, and a plain numpy emulation of the kernel (the prmt transposition
of weight rows into m16n8k32 A fragments, the mma fragment layouts, the sum
of the warps' K groups, the last block's sum of the K splits and the one
float rounding) gives the plain version's float32 outputs bit for bit, and
the JAX kernel's.  The counter slots are held to one slot per stream.
Inputs are made with numpy from a seed.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul.kernel import quant_matmul_raw as ref_quant_matmul_raw
from repro_torch.kernels.packed_matmul.kernel import BLOCKS_PER_SM, N_COUNTERS, CounterSlots, grid_plan
from repro_torch.kernels.quant_matmul.kernel import (
    K4_BN,
    K4_PLAN,
    K4_SLAB,
    K4_TK,
    copy_width,
    k4_bm,
    quant_matmul_plain,
)

# csrc/quant_matmul.cu namespace k4
WARPS, WN, ACT_LD = 8, 2, K4_TK + 16


def _layout(bm):
    """(NT, WM, WK, SPW) of Tile<bm>: n8 tiles a warp, row groups, K groups,
    slabs a warp takes per stage."""
    nt = bm // 8 if bm < 32 else 4
    wm = bm // (8 * nt)
    wk = WARPS // (wm * WN)
    return nt, wm, wk, K4_TK // K4_SLAB // wk


def _ring_offset(row, gran):
    """Twin of csrc/quant_matmul.cu k4::ring_offset."""
    return row * K4_BN + ((gran ^ (((row >> 2) & 3) << 1)) << 4)


# -- the plan ----------------------------------------------------------------------

# llama3.2-3b at full width: (K, N) of every decode matmul (chip_smoke.py phase 6)
DECODE_SHAPES = {"wq|wo": (3072, 3072), "wk|wv": (3072, 1024), "w_up|w_gate": (3072, 8192),
                 "w_down": (8192, 3072), "head": (3072, 128256)}


@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
@pytest.mark.parametrize("m", [1, 8, 128])
def test_k4_grid_plan_covers_k_in_whole_slabs_and_fills_an_h100(shape, m):
    k, n = DECODE_SHAPES[shape]
    bm = k4_bm(m)
    splits, kps = grid_plan(m, k, n, 132, bm=bm, **K4_PLAN)
    assert (splits - 1) * kps < k <= splits * kps
    tiles = -(-m // bm) * -(-n // K4_BN)
    if splits > 1:
        assert kps % K4_SLAB == 0 and kps >= K4_TK
        assert tiles < BLOCKS_PER_SM * 132  # the counters of one stream's slot suffice
    # every SM busy, or K cut as far as allowed
    assert tiles * splits >= 132 or splits == K4_PLAN["max_splits"] or kps == K4_TK
    assert copy_width(n) == 16


def test_k4_row_tile_follows_m():
    assert [k4_bm(m) for m in (1, 8, 9, 17, 32, 33, 64, 65, 128, 129, 1000)] == \
        [8, 8, 32, 32, 32, 64, 64, 128, 128, 128, 128]
    for bm in (8, 32, 64, 128):
        nt, wm, wk, spw = _layout(bm)
        assert wm * WN * wk == WARPS and spw * wk * K4_SLAB == K4_TK and wm * nt * 8 == bm
        assert nt <= 4  # at most 64 accumulators a thread


def test_k4_ring_layout_is_a_bijection_without_bank_conflicts():
    """The swizzled stage holds each 16-byte granule of a 128 x 128 byte
    tile once; the fragment reads (lane (g, t) takes 8 bytes of granule 4 cg
    + g / 2 of row 4t + r, and of row 16 + 4t + r, a half-warp a pass), the
    16-byte copies (8 lanes, one row, a pass) and the 4-byte copies (a warp,
    one row) touch every bank at most once a pass."""
    offs = {_ring_offset(row, gran) for row in range(K4_TK) for gran in range(8)}
    assert offs == set(range(0, K4_TK * K4_BN, 16))
    for slab, cg, r, hi, half in itertools.product(range(4), range(2), range(4), range(2), range(2)):
        banks = []
        for lane in range(16 * half, 16 * half + 16):
            g, t = lane >> 2, lane & 3
            addr = _ring_offset(slab * 32 + 16 * hi + 4 * t + r, cg * 4 + (g >> 1)) + (g & 1) * 8
            banks += [(addr // 4) % 32, (addr // 4 + 1) % 32]
        assert len(set(banks)) == 32, (slab, cg, r, hi, half)
    for row in range(K4_TK):
        banks = [(_ring_offset(row, gran) // 4 + j) % 32 for gran in range(8) for j in range(4)]
        assert len(set(banks)) == 32
        banks = [((_ring_offset(row, word >> 2) + (word & 3) * 4) // 4) % 32 for word in range(32)]
        assert len(set(banks)) == 32


@pytest.mark.parametrize("bm", [8, 32, 64, 128])
def test_k4_activation_pitch_gives_each_lane_its_own_bank(bm):
    """B fragments: lane (g, t) reads the word at k 4t (and 16 + 4t) of
    activation row g of an n8 tile, rows ACT_LD bytes apart."""
    for row0, k0 in itertools.product(range(0, bm, 8), range(0, K4_TK, 16)):
        banks = {(((row0 + g) * ACT_LD + k0 + 4 * t) // 4) % 32 for g in range(8) for t in range(4)}
        assert len(banks) == 32


# -- a plain emulation of the kernel ------------------------------------------------


def _byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)`` on uint32 arrays."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _transpose4x4(r0, r1, r2, r3):
    """Twin of csrc/quant_matmul.cu transpose4x4."""
    t0, t1 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    t2, t3 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _word(buf, off):
    """Little-endian uint32 at byte offsets ``off`` (an array) of ``buf``."""
    return sum(buf[off + i].astype(np.int64) << (8 * i) for i in range(4))


def _sbyte(word, i):
    return (((word >> (8 * i)) & 0xFF) ^ 0x80) - 0x80


LANE = np.arange(32)
G, T_ = LANE >> 2, LANE & 3


def _mma_k32(d, a, b):
    """d[e][lane] += the m16n8k32 s8 product of the lanes' fragments ``a``
    (4 registers) and ``b`` (2), in PTX's fragment layouts."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(4):
        A[G, 4 * T_ + i] = _sbyte(a[0], i)
        A[G + 8, 4 * T_ + i] = _sbyte(a[1], i)
        A[G, 16 + 4 * T_ + i] = _sbyte(a[2], i)
        A[G + 8, 16 + 4 * T_ + i] = _sbyte(a[3], i)
        B[4 * T_ + i, G] = _sbyte(b[0], i)
        B[16 + 4 * T_ + i, G] = _sbyte(b[1], i)
    D = A @ B
    d[0] += D[G, 2 * T_]
    d[1] += D[G, 2 * T_ + 1]
    d[2] += D[G + 8, 2 * T_]
    d[3] += D[G + 8, 2 * T_ + 1]


def _emulate_block(a, w, bm, mt, ct, k_begin, k_end):
    """One block's int32 quads [QUADS, 4], its warps' K groups summed."""
    m, k = a.shape
    n = w.shape[1]
    nt, wm, wk, spw = _layout(bm)
    m0, c0 = mt * bm, ct * K4_BN
    acc = np.zeros((WARPS, nt, 4, 4, 32), np.int64)
    for kt in range(k_begin, k_end, K4_TK):
        # the ring stage: weights swizzled, activations at pitch ACT_LD, zeros outside
        wst = np.zeros(K4_TK * K4_BN, np.uint8)
        act = np.zeros(bm * ACT_LD, np.uint8)
        for row, gran in itertools.product(range(min(K4_TK, k_end - kt)), range(8)):
            cols = w[kt + row, c0 + 16 * gran: min(n, c0 + 16 * gran + 16)].view(np.uint8)
            off = _ring_offset(row, gran)
            wst[off: off + len(cols)] = cols
        for r in range(min(bm, m - m0)):
            vals = a[m0 + r, kt: min(k_end, kt + K4_TK)].view(np.uint8)
            act[r * ACT_LD: r * ACT_LD + len(vals)] = vals
        for warp in range(WARPS):
            cg, rg, kg = warp % WN, (warp // WN) % wm, warp // (WN * wm)
            for ss in range(spw):
                s = ss * wk + kg
                if kt + s * K4_SLAB >= k_end:
                    break
                pieces = [[], [], [], []]  # words of bytes 0..3 / 4..7, rows 4t + r / 16 + 4t + r
                for r in range(4):
                    for hi in range(2):
                        off = _ring_offset(s * 32 + 16 * hi + 4 * T_ + r, cg * 4 + (G >> 1)) + (G & 1) * 8
                        pieces[2 * hi].append(_word(wst, off))
                        pieces[2 * hi + 1].append(_word(wst, off + 4))
                clo = _transpose4x4(*pieces[0]) + _transpose4x4(*pieces[1])
                chi = _transpose4x4(*pieces[2]) + _transpose4x4(*pieces[3])
                for j in range(nt):
                    base = (rg * nt * 8 + j * 8 + G) * ACT_LD + s * K4_SLAB + 4 * T_
                    b = (_word(act, base), _word(act, base + 16))
                    for i in range(4):
                        _mma_k32(acc[warp, j, i], (clo[2 * i], clo[2 * i + 1], chi[2 * i], chi[2 * i + 1]), b)
    quads = np.zeros((bm * K4_BN // 4, 4), np.int64)
    for warp in range(WARPS):
        cg, rg = warp % WN, (warp // WN) % wm
        pos = rg * WN + cg
        for j, h, pp in itertools.product(range(nt), range(2), range(2)):
            q = ((pos * nt + j) * 4 + 2 * h + pp) * 32 + LANE
            quads[q] += np.stack([acc[warp, j, 2 * pp, h], acc[warp, j, 2 * pp, 2 + h],
                                  acc[warp, j, 2 * pp + 1, h], acc[warp, j, 2 * pp + 1, 2 + h]], axis=1)
    return quads


def _emulate_k4(a, w, scale, sms):
    """K4's launch: blocks by (row tile, column tile, K split), each split's
    quads summed as the last block to arrive does, then one float32
    multiply per output."""
    m, k = a.shape
    n = w.shape[1]
    bm = k4_bm(m)
    splits, kps = grid_plan(m, k, n, sms, bm=bm, **K4_PLAN)
    nt, wm, _, _ = _layout(bm)
    out = np.full((m, n), np.nan, np.float32)
    for mt, ct in itertools.product(range(-(-m // bm)), range(-(-n // K4_BN))):
        total = sum(_emulate_block(a, w, bm, mt, ct, s * kps, min(k, (s + 1) * kps)) for s in range(splits))
        assert np.abs(total).max(initial=0) < 2**31
        for q, v in enumerate(total):
            lane, rest = q & 31, q >> 5
            pp, h, j, wpos = rest & 1, (rest >> 1) & 1, (rest >> 2) % nt, (rest >> 2) // nt
            row = mt * bm + ((wpos // WN) * nt + j) * 8 + 2 * (lane & 3) + h
            col = ct * K4_BN + (wpos % WN) * 64 + 8 * (lane >> 2) + 4 * pp
            for c in range(4):
                if row < m and col + c < n:
                    assert np.isnan(out[row, col + c])  # one owner per output
                    out[row, col + c] = np.float32(v[c]) * scale[0, col + c]
    return out, splits


@pytest.mark.parametrize("operands", ["extreme", "random"])
@pytest.mark.parametrize("m,k,n,sms,want_splits", [
    (8, 300, 150, 132, 3),   # ragged K and N (byte-load path), a K split
    (1, 9, 7, 132, 1),       # one row, K under a slab
    (13, 517, 128, 4, 5),    # the 32-row tile, ragged M and K, a split
    (40, 200, 64, 4, 2),     # the 64-row tile, 2 row groups x 2 K groups, a split
    (130, 64, 20, 132, 1),   # two 128-row tiles, the second ragged
])
def test_k4_emulation_matches_plain(operands, m, k, n, sms, want_splits):
    """The emulated kernel gives ``quant_matmul_plain``'s float32 outputs
    bit for bit; "extreme" fills the operands with -128 and 127 (every
    product at its bound, int8 -128 included)."""
    rng = np.random.default_rng(m * k + n)
    if operands == "extreme":
        a = rng.choice(np.array([-128, 127], np.int8), (m, k))
        w = rng.choice(np.array([-128, 127], np.int8), (k, n))
    else:
        a = rng.integers(-128, 128, (m, k)).astype(np.int8)
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-6, 1e-3, (1, n)).astype(np.float32)
    ours, splits = _emulate_k4(a, w, scale, sms)
    assert splits == want_splits
    plain = quant_matmul_plain(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(ours, plain)


@pytest.mark.parametrize("m,k,n", [(8, 300, 150), (33, 96, 40)])
def test_k4_emulation_matches_the_jax_kernel(m, k, n):
    """The emulated kernel against the reference's Pallas kernel
    (interpret mode, K-blocked at block_k=128) on the same int8 operands:
    bit-exact."""
    rng = np.random.default_rng(k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)
    ours, _ = _emulate_k4(a, w, scale, 132)
    theirs = ref_quant_matmul_raw(jnp.asarray(a), jnp.asarray(w), jnp.asarray(scale), block_k=128)
    np.testing.assert_array_equal(ours, np.asarray(theirs))


# -- split-K counters per stream ------------------------------------------------------


def test_counter_slots_give_each_stream_its_own_slot():
    """Streams (fake handles here) get distinct slots in order of their
    first split launch and keep them; a slot holds more counters than a
    split launch has tiles; the slots run out only past their number."""
    size = BLOCKS_PER_SM * 132
    slots = CounterSlots(N_COUNTERS // size)
    handles = [0x5000 + 16 * i for i in range(slots.n_slots)]
    got = [slots.slot(h) for h in handles]
    assert got == list(range(slots.n_slots))
    assert [slots.slot(h) for h in reversed(handles)] == got[::-1]
    assert slots.n_slots * size <= N_COUNTERS and slots.n_slots >= 64
    with pytest.raises(RuntimeError, match="counter slots"):
        slots.slot(0x1)
    assert slots.slot(handles[3]) == 3  # a known stream still gets its slot
