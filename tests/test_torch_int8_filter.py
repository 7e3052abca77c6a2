"""The port's int8-lane matmuls (K4, K5) and Filter-Packing convolution
(K6) against the JAX reference, on the CPU.

Both packages get the same numpy inputs made from a seed.  Integer results
(placements, packed words, accumulators, convolutions) must be bit-exact.
JAX runs its Pallas kernels in interpret mode, as the reference's own tests
do; the port's wrappers run their plain versions because the tensors lie on
the CPU.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffcheck
from repro.core.packing import TPU_VPU15 as REF_VPU15
from repro.core.packing.select import filter_acc_chunk as ref_filter_acc_chunk
from repro.core.packing.strategies import filter_placements as ref_filter_placements
from repro.core.quant import weight_to_int_levels as ref_weight_levels
from repro.kernels.filter_conv import ref as ref_fc
from repro.kernels.filter_conv.kernel import filter_conv_raw as ref_filter_conv_raw
from repro.kernels.filter_conv.ops import choose_filter_config as ref_choose_filter_config
from repro.kernels.filter_conv.ops import packed_conv1d as ref_packed_conv1d
from repro.kernels.packed_matmul import ref as ref_pm
from repro.kernels.quant_matmul import ref as ref_qm
from repro.kernels.quant_matmul.kernel import quant_matmul_raw as ref_quant_matmul_raw
from repro.kernels.quant_matmul.kernel import quant_packed_matmul_raw as ref_quant_packed_raw
from repro.kernels.quant_matmul.ops import choose_mxu_config as ref_choose_mxu_config
from repro.kernels.quant_matmul.ops import quant_dense as ref_quant_dense
from repro.kernels.quant_matmul.ops import quant_packed_dense as ref_quant_packed_dense
from repro_torch.core.packing import TPU_VPU15
from repro_torch.core.packing.select import filter_acc_chunk
from repro_torch.core.packing.strategies import filter_placements
from repro_torch.core.quant import weight_to_int_levels
from repro_torch.kernels.filter_conv import ref as fc
from repro_torch.kernels.filter_conv.kernel import filter_conv_raw
from repro_torch.kernels.filter_conv.ops import choose_filter_config, packed_conv1d
from repro_torch.kernels.packed_matmul import ref as pm
from repro_torch.kernels.peel import lsb_mask
from repro_torch.kernels.quant_matmul import ref as qm
from repro_torch.kernels.quant_matmul.kernel import quant_matmul_raw, quant_packed_matmul_raw
from repro_torch.kernels.quant_matmul.ops import (
    choose_mxu_config,
    quant_dense,
    quant_dense_reference,
    quant_packed_dense,
)

BITS = range(2, 9)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- placements -----------------------------------------------------------------


@pytest.mark.parametrize("w_bits", BITS)
def test_choose_mxu_config_matches_reference(w_bits):
    for a_bits in BITS:
        for overpack in (True, False):
            ours = choose_mxu_config(w_bits, a_bits, allow_overpack=overpack)
            theirs = ref_choose_mxu_config(w_bits, a_bits, allow_overpack=overpack)
            assert (None if ours is None else tuple(ours)) == \
                (None if theirs is None else tuple(theirs)), (w_bits, a_bits, overpack)


@pytest.mark.parametrize("k_len", [3, 5, 7])
def test_choose_filter_config_matches_reference(k_len):
    for w_bits in BITS:
        for a_bits in BITS:
            for overpack in (True, False):
                ours = choose_filter_config(w_bits, a_bits, k_len, allow_overpack=overpack)
                theirs = ref_choose_filter_config(w_bits, a_bits, k_len, allow_overpack=overpack)
                assert (None if ours is None else tuple(ours)) == \
                    (None if theirs is None else tuple(theirs)), (w_bits, a_bits, k_len, overpack)


@pytest.mark.parametrize("w_bits,a_bits", [(2, 2), (3, 4), (4, 4), (6, 3)])
def test_filter_placements_and_chunks_match_reference(w_bits, a_bits):
    """Every enumerated filter placement and its channel chunk, not only the winner."""
    ours = list(filter_placements(TPU_VPU15, w_bits, a_bits, 5, 1 << 30))
    theirs = list(ref_filter_placements(REF_VPU15, w_bits, a_bits, 5, 1 << 30))
    assert [(c.n_w, c.n_a, c.stride, c.overlap, c.w_port_big, c.t_mul, c.e_g) for c in ours] == \
        [(c.n_w, c.n_a, c.stride, c.overlap, c.w_port_big, c.t_mul, c.e_g) for c in theirs]
    assert [filter_acc_chunk(c) for c in ours] == [ref_filter_acc_chunk(c) for c in theirs]


# -- K4: int8 x int8 -> int32, one rescale --------------------------------------


@pytest.mark.parametrize("m,k,n", [(1, 32, 16), (16, 257, 129), (130, 512, 64), (8, 40, 7)])
def test_quant_matmul_plain_matches_jax_kernel(m, k, n):
    """K4's plain version against the JAX kernel (interpret mode, K-blocked
    at block_k=128 where K allows) and the oracle, on identical int8
    operands, ragged M, N and K included: bit-exact."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)
    a_scale = np.float32(0.0123)
    ours = quant_matmul_raw(_t(a), _t(w), _t(scale) * float(a_scale)).numpy()
    theirs = ref_quant_matmul_raw(jnp.asarray(a), jnp.asarray(w),
                                  jnp.asarray(scale) * a_scale, block_k=128)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    oracle = ref_qm.quant_matmul(jnp.asarray(a), jnp.asarray(w), jnp.asarray(scale), a_scale)
    np.testing.assert_array_equal(
        qm.quant_matmul(_t(a), _t(w), _t(scale), torch.tensor(a_scale)).numpy(), np.asarray(oracle))


@pytest.mark.parametrize("m,k,n", [(16, 257, 129), (130, 64, 64)])
def test_quant_dense_matches_reference(m, k, n):
    """Float in, float out: the port's W8A8 levels and scales equal the
    reference's, and the layer is within the reference's own bound (relative
    L2 < 5e-3: jit may flip a boundary rounding by one level)."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    w_i8, w_s = qm.quantize_symmetric(_t(w))
    rw_i8, rw_s = ref_qm.quantize_symmetric(jnp.asarray(w))
    np.testing.assert_array_equal(w_i8.numpy(), np.asarray(rw_i8))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(rw_s))
    a_i8, a_s = qm.quantize_act_symmetric(_t(x))
    ra_i8, ra_s = ref_qm.quantize_act_symmetric(jnp.asarray(x))
    np.testing.assert_array_equal(a_i8.numpy(), np.asarray(ra_i8))
    assert float(a_s) == float(ra_s)
    ours = quant_dense(_t(x), _t(w)).numpy()
    theirs = np.asarray(ref_quant_dense(jnp.asarray(x), jnp.asarray(w)))
    rel = np.linalg.norm(ours - theirs) / (np.linalg.norm(theirs) + 1e-9)
    assert rel < 5e-3, rel
    np.testing.assert_array_equal(ours, quant_dense_reference(_t(x), _t(w)).numpy())


# -- K5: packed words inside the int8 lane ---------------------------------------

MXU_PLACEMENTS = [
    ((2, 2), ref_choose_mxu_config(2, 2)),
    ((2, 3), ref_choose_mxu_config(2, 3)),
    ((2, 2), ref_choose_mxu_config(2, 2, allow_overpack=False)),
]


@pytest.mark.parametrize("pair,cfg", MXU_PLACEMENTS, ids=["w2a2", "w2a3", "w2a2-plain"])
@pytest.mark.parametrize("m,k,n_groups", [(5, 83, 9), (9, 40, 4), (1, 13, 1)])
def test_quant_packed_matmul_plain_matches_jax_kernel(pair, cfg, m, k, n_groups):
    """K5's plain version against the JAX kernel (interpret mode, K-blocked
    at 16 so chunks straddle the block edges), the integer matmul and the
    bitpack oracle on identical int8 operands: bit-exact."""
    w_bits, a_bits = pair
    rng = np.random.default_rng(m * k + n_groups)
    a = rng.integers(0, 1 << a_bits, (m, k)).astype(np.int8)
    w_lvl = rng.integers(0, 1 << w_bits, (k, n_groups * cfg.n_seg)).astype(np.int32)
    wp = pm.pack_weights(_t(w_lvl), cfg.n_seg, cfg.stride).to(torch.int8)
    assert int(wp.min()) >= 0  # the sign-safe 7-bit lane
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    ours = quant_packed_matmul_raw(_t(a), wp, **kw).numpy()
    theirs = ref_quant_packed_raw(jnp.asarray(a), jnp.asarray(wp.numpy()), block_m=8, block_n=8,
                                  block_k=16, **kw)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    np.testing.assert_array_equal(ours, a.astype(np.int64) @ w_lvl)
    case = diffcheck.MatmulCase(w_bits, a_bits, cfg, m, k, n_groups, block_k=k, seed=0)
    np.testing.assert_array_equal(
        ours, diffcheck.run_matmul_bitpack(case, a.astype(np.int64), w_lvl.astype(np.int64)))


@pytest.mark.parametrize("w_bits,a_bits", [(2, 2), (2, 3), (4, 4), (3, 2)])
def test_quant_packed_dense_matches_reference(w_bits, a_bits):
    """The whole layer from float inputs: w2a2 and w2a3 through K5's plain
    version, w4a4 and w3a2 through the plain integer path.  Weight levels
    pass through tanh, which may differ by an ulp between XLA and PyTorch
    and flip a level on a rounding boundary: at most 4 of the 1170 levels
    may differ, and every output column whose levels agree is bit-exact."""
    rng = np.random.default_rng(w_bits * 10 + a_bits)
    m, k, n = 9, 65, 18
    x = rng.uniform(-0.1, 1.1, (m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    ours = quant_packed_dense(_t(x), _t(w), w_bits=w_bits, a_bits=a_bits).numpy()
    theirs = np.asarray(ref_quant_packed_dense(jnp.asarray(x), jnp.asarray(w),
                                               w_bits=w_bits, a_bits=a_bits))
    lvl = weight_to_int_levels(_t(w), w_bits)[0].numpy()
    ref_lvl = np.asarray(ref_weight_levels(jnp.asarray(w), w_bits)[0])
    flips = lvl != ref_lvl
    assert np.count_nonzero(flips) <= 4, np.count_nonzero(flips)
    clean = ~flips.any(axis=0)
    assert clean.sum() >= n - 4
    np.testing.assert_array_equal(ours[:, clean], theirs[:, clean])


# -- K6: Filter-Packing convolution ----------------------------------------------

FILTER_CASES = [(2, 2, 3), (3, 4, 3), (4, 4, 3), (2, 2, 7), (3, 3, 5)]


@pytest.mark.parametrize("w_bits,a_bits,k_len", FILTER_CASES)
@pytest.mark.parametrize("b,c,n", [(3, 6, 19), (1, 1, 5)])
def test_filter_conv_plain_matches_jax_kernel(w_bits, a_bits, k_len, b, c, n):
    """K6's plain version against the JAX kernel (interpret mode, C/N
    blocked) on identical packed operands, overpacked and plain placements,
    ragged N: bit-exact, and equal to numpy's convolution."""
    cfg = ref_choose_filter_config(w_bits, a_bits, k_len)
    rng = np.random.default_rng(b * 100 + c + n)
    s = rng.integers(0, 1 << a_bits, (b, c, n)).astype(np.int32)
    f = rng.integers(0, 1 << w_bits, (c, k_len)).astype(np.int32)
    n_pad = -(-n // cfg.n_p) * cfg.n_p
    sp = np.pad(s, ((0, 0), (0, 0), (0, n_pad - n)))
    fp = fc.pack_filter(_t(f), cfg.k_p, cfg.stride)
    np.testing.assert_array_equal(fp.numpy(), np.asarray(ref_fc.pack_filter(jnp.asarray(f), cfg.k_p,
                                                                            cfg.stride)))
    np.testing.assert_array_equal(fp.numpy() & lsb_mask(cfg.k_p, cfg.stride),
                                  fc.pack_lsb_filter(_t(f), cfg.k_p, cfg.stride).numpy())
    kw = dict(k_p=cfg.k_p, n_p=cfg.n_p, stride=cfg.stride, acc_chunk=cfg.acc_chunk,
              k_len=k_len, n_len=n, overlap=cfg.overlap)
    ours = filter_conv_raw(_t(sp), fp, **kw).numpy()
    theirs = ref_filter_conv_raw(jnp.asarray(sp), jnp.asarray(fp.numpy()), block_b=2, block_c=4,
                                 block_n=8, **kw)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    np.testing.assert_array_equal(ours, diffcheck.run_conv_numpy(s.astype(np.int64),
                                                                 f.astype(np.int64)))


@pytest.mark.parametrize("w_bits,a_bits,k_len", FILTER_CASES + [(8, 8, 3), (7, 6, 5)])
def test_packed_conv1d_matches_reference(w_bits, a_bits, k_len):
    """The entry point against the reference's and both ground truths
    (``conv_full_levels`` of each package): bit-exact; w8a8 and w7a6 take
    the no-placement fallback."""
    rng = np.random.default_rng(w_bits + a_bits + k_len)
    s = rng.integers(0, 1 << a_bits, (2, 5, 11)).astype(np.int32)
    f = rng.integers(0, 1 << w_bits, (5, k_len)).astype(np.int32)
    ours = packed_conv1d(_t(s), _t(f), w_bits=w_bits, a_bits=a_bits).numpy()
    theirs = np.asarray(ref_packed_conv1d(jnp.asarray(s), jnp.asarray(f), w_bits=w_bits,
                                          a_bits=a_bits))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, fc.conv_full_levels(_t(f), _t(s)).numpy())
    np.testing.assert_array_equal(ours, np.asarray(ref_fc.conv_full_levels(jnp.asarray(f),
                                                                           jnp.asarray(s))))


# -- the plain integer path --------------------------------------------------------


def test_matmul_levels_matches_reference():
    """8-bit levels at a K where int32 sums exceed 2**24: exact."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (3, 700)).astype(np.int32)
    w = rng.integers(0, 256, (700, 5)).astype(np.int32)
    ours = pm.matmul_levels(_t(a), _t(w))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(ref_pm.matmul_levels(jnp.asarray(a), jnp.asarray(w))))
