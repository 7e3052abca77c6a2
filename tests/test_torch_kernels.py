"""The port's packing, quantization and kernel plain versions against the
JAX reference, on the CPU.

Both packages get the same numpy inputs made from a seed.  Integer
results (placements, packed words, accumulators, gathered views) must be
bit-exact.  JAX runs its Pallas kernels in interpret mode, as the
reference's own tests do; the port's wrappers run their plain versions
because the tensors lie on the CPU.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffcheck
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.core.quant import act_to_int_levels as ref_act_levels
from repro.core.quant import weight_to_int_levels as ref_weight_levels
from repro.kernels.packed_matmul import ref as ref_pm
from repro.kernels.packed_matmul.ops import choose_config as ref_choose_config
from repro.kernels.packed_matmul.ops import packed_dense as ref_packed_dense
from repro.kernels.packed_matmul.ops import prepack_dense as ref_prepack_dense
from repro.kernels.paged_gather import ref as ref_pg
from repro.kernels.paged_gather.kernel import paged_gather_raw as ref_paged_gather_raw
from repro_torch.bridge import packed_from_jax
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.quant import act_to_int_levels, weight_to_int_levels
from repro_torch.kernels.packed_matmul import ref as pm
from repro_torch.kernels.packed_matmul.kernel import packed_dense_fused_raw, packed_matmul_raw
from repro_torch.kernels.packed_matmul.ops import choose_config, packed_dense, prepack_dense
from repro_torch.kernels.paged_gather.kernel import paged_gather_raw
from repro_torch.kernels.peel import lsb_mask

BITS = range(2, 9)
# the serving pair (overpacked at equal density), a denser overpacked pair,
# and the no-overpack placement of the serving pair
PLACEMENTS = [
    ((4, 4), ref_choose_config(4, 4)),
    ((2, 3), ref_choose_config(2, 3)),
    ((4, 4), ref_choose_config(4, 4, allow_overpack=False)),
]


# -- configs and placements ---------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference_field_for_field(smoke):
    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        ours, theirs = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
        for f in dataclasses.fields(theirs):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name == "dtype":
                assert str(a).split(".")[-1] == jnp.dtype(b).name, (arch, f.name)
            elif f.name == "quant":
                assert (dict(a.bits), a.serve_int8) == (dict(b.bits), b.serve_int8), arch
            else:
                assert a == b, (arch, f.name, a, b)


@pytest.mark.parametrize("w_bits", BITS)
def test_choose_config_matches_reference(w_bits):
    for a_bits in BITS:
        for overpack in (True, False):
            ours = choose_config(w_bits, a_bits, allow_overpack=overpack)
            theirs = ref_choose_config(w_bits, a_bits, allow_overpack=overpack)
            assert (ours is None) == (theirs is None), (w_bits, a_bits)
            if ours is not None:
                assert tuple(ours) == tuple(theirs), (w_bits, a_bits, overpack)


@pytest.mark.parametrize("w_bits,a_bits", [(4, 4), (2, 3), (3, 4), (2, 2), (5, 2)])
def test_pack_weights_matches_reference_and_lsb_view(w_bits, a_bits):
    cfg = ref_choose_config(w_bits, a_bits)
    rng = np.random.default_rng(w_bits * 10 + a_bits)
    w_lvl = rng.integers(0, 1 << w_bits, (37, 6 * cfg.n_seg)).astype(np.int32)
    ours = pm.pack_weights(torch.from_numpy(w_lvl), cfg.n_seg, cfg.stride).numpy()
    theirs = np.asarray(ref_pm.pack_weights(jnp.asarray(w_lvl), cfg.n_seg, cfg.stride))
    np.testing.assert_array_equal(ours, theirs)
    # the overpacked decode reads the LSB planes as a masked view of the words
    planes = pm.pack_lsb_planes(torch.from_numpy(w_lvl), cfg.n_seg, cfg.stride).numpy()
    np.testing.assert_array_equal(ours & lsb_mask(cfg.n_seg, cfg.stride), planes)
    np.testing.assert_array_equal(
        planes, np.asarray(ref_pm.pack_lsb_planes(jnp.asarray(w_lvl), cfg.n_seg, cfg.stride)))


def test_quant_levels_match_reference():
    """Activation levels are exact.  Weight levels pass through tanh,
    whose float32 result may differ by an ulp between XLA and PyTorch;
    that can flip a level only where ``t * n`` sits within an ulp of a
    rounding boundary, so at most a handful of levels may differ, by 1."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.3, 1.3, (64, 96)).astype(np.float32)
    x[0, :4] = [0.5 / 15, 1.5 / 15, 0.0, 1.0]
    for bits in (2, 4, 8):
        ours, s = act_to_int_levels(torch.from_numpy(x), bits)
        theirs, s_ref = ref_act_levels(jnp.asarray(x), bits)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        assert s == s_ref
    w = rng.normal(size=(256, 192)).astype(np.float32) / 16
    for bits in (2, 4):
        ours, sc, z = weight_to_int_levels(torch.from_numpy(w), bits)
        theirs, sc_ref, z_ref = ref_weight_levels(jnp.asarray(w), bits)
        diff = np.abs(ours.numpy() - np.asarray(theirs))
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 4, np.count_nonzero(diff)
        assert (sc, z) == (sc_ref, z_ref)


# -- packed dense: plain versions vs the JAX kernels and the bitpack oracle -----


@pytest.mark.parametrize("pair,cfg", PLACEMENTS)
def test_fused_plain_matches_jax_kernel_and_oracle(pair, cfg):
    """K1's plain version: bit-exact acc and a_sum against the JAX fused
    kernel (interpret mode), the numpy integer matmul and the bitpack oracle."""
    from repro.kernels.packed_matmul.kernel import packed_dense_fused_raw as ref_fused

    w_bits, a_bits = pair
    m, k, n = 5, 61, 6 * cfg.n_seg
    rng = np.random.default_rng(1)
    # post-sigmoid-like activations, some outside [0, 1] to exercise the clip
    x = rng.uniform(-0.1, 1.1, (m, k)).astype(np.float32)
    w_lvl = rng.integers(0, 1 << w_bits, (k, n)).astype(np.int32)
    wp = pm.pack_weights(torch.from_numpy(w_lvl), cfg.n_seg, cfg.stride)
    kw = dict(a_bits=a_bits, n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk,
              overlap=cfg.overlap)
    acc, a_sum = packed_dense_fused_raw(torch.from_numpy(x), wp, **kw)
    r_acc, r_sum = ref_fused(jnp.asarray(x), jnp.asarray(wp.numpy()), block_m=8, block_n=8, **kw)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(r_acc))
    np.testing.assert_array_equal(a_sum.numpy(), np.asarray(r_sum))
    a_lvl = np.round(np.clip(x, 0, 1) * ((1 << a_bits) - 1)).astype(np.int64)
    np.testing.assert_array_equal(acc.numpy(), a_lvl @ w_lvl)
    case = diffcheck.MatmulCase(w_bits, a_bits, cfg, m, k, n // cfg.n_seg, block_k=k, seed=0)
    np.testing.assert_array_equal(acc.numpy(), diffcheck.run_matmul_bitpack(case, a_lvl, w_lvl))


@pytest.mark.parametrize("pair,cfg", PLACEMENTS)
@pytest.mark.parametrize("block_k", [16, 40])
def test_blocked_plain_matches_jax_kernel_and_oracle(pair, cfg, block_k):
    """K2's plain version with chunks restarting every ``block_k``."""
    from repro.kernels.packed_matmul.kernel import packed_matmul_raw as ref_blocked

    w_bits, a_bits = pair
    m, k, n = 3, 83, 4 * cfg.n_seg
    rng = np.random.default_rng(block_k)
    a_lvl = rng.integers(0, 1 << a_bits, (m, k)).astype(np.int32)
    w_lvl = rng.integers(0, 1 << w_bits, (k, n)).astype(np.int32)
    wp = pm.pack_weights(torch.from_numpy(w_lvl), cfg.n_seg, cfg.stride)
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    acc = packed_matmul_raw(torch.from_numpy(a_lvl), wp, block_k=block_k, **kw).numpy()
    r_acc = ref_blocked(jnp.asarray(a_lvl), jnp.asarray(wp.numpy()), block_m=4, block_n=8,
                        block_k=block_k, **kw)
    np.testing.assert_array_equal(acc, np.asarray(r_acc))
    case = diffcheck.MatmulCase(w_bits, a_bits, cfg, m, k, n // cfg.n_seg, block_k, seed=0)
    oracle = diffcheck.run_matmul_bitpack(case, a_lvl.astype(np.int64), w_lvl.astype(np.int64))
    np.testing.assert_array_equal(acc, oracle)


@pytest.mark.parametrize("w_bits,a_bits,block_k", [(4, 4, None), (4, 4, 32), (2, 3, None), (4, 8, None)])
def test_packed_dense_matches_jax_on_identical_packed_words(w_bits, a_bits, block_k):
    """The whole prepacked layer, N padded to n_seg, w4a8 on the plain
    integer path.  Both dequantize in float32 with the same op order; the
    port's output must be within one float32 ulp of the reference (XLA
    may contract the multiply and subtract into one rounding)."""
    rng = np.random.default_rng(3)
    k, n = 70, 25  # odd N: padded up to a multiple of n_seg
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.uniform(0, 1, (4, k)).astype(np.float32)
    ref_p = ref_prepack_dense(jnp.asarray(w), w_bits=w_bits, a_bits=a_bits, block_k=block_k)
    theirs = np.asarray(ref_packed_dense(jnp.asarray(x), ref_p))
    ours = packed_dense(torch.from_numpy(x), packed_from_jax(ref_p)).numpy()
    assert ours.shape == theirs.shape == (4, n)
    np.testing.assert_array_max_ulp(ours, theirs, maxulp=1)
    # and the port's own prepack gives the same words up to tanh level flips
    mine = prepack_dense(torch.from_numpy(w), w_bits=w_bits, a_bits=a_bits, device="cpu")
    data = mine.w_packed if mine.cfg is not None else mine.w_lvl
    ref_data = ref_p.w_packed if ref_p.cfg is not None else ref_p.w_lvl
    assert np.mean(data.numpy() == np.asarray(ref_data)) > 0.95


# -- paged gather: plain version vs the JAX kernel ------------------------------

GATHER_CASES = [
    ref_pg.GatherCase(),
    ref_pg.GatherCase(window=5, pos_mode="edge", inactive_slots=2, seed=1),
    ref_pg.GatherCase(int8=True, pos_mode="start", seed=2),
    ref_pg.GatherCase(int8=True, window=3, chunk=2, seed=3),
]


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: f"int8={c.int8}-w{c.window}-c{c.chunk}")
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_gather_plain_matches_jax_kernel(case, out_dtype):
    """Bit-exact K/V views and mask: fp and int8 pools, null pages, windows."""
    ops = ref_pg.make_operands(case)
    jdt, tdt = jnp.dtype(out_dtype), getattr(torch, out_dtype)
    pools = [ops["pool_k"], ops["pool_v"]]
    if not case.int8:
        pools = [p.astype(jdt) for p in pools]
    scales = [ops["k_scale"], ops["v_scale"]]
    rk, rv, rm = ref_paged_gather_raw(
        jnp.asarray(ops["block_table"]), jnp.asarray(ops["pos"]), jnp.asarray(ops["window"]),
        *(jnp.asarray(p) for p in pools), *(None if s is None else jnp.asarray(s) for s in scales),
        chunk=case.chunk, out_dtype=jdt,
    )

    if case.int8:
        tpools = [torch.from_numpy(p) for p in pools]
    else:  # bf16 numpy -> float32 -> bf16 is exact
        tpools = [torch.from_numpy(np.asarray(p, np.float32)).to(tdt) for p in pools]
    k, v, m = paged_gather_raw(
        torch.from_numpy(ops["block_table"]), torch.from_numpy(ops["pos"]), int(ops["window"]),
        *tpools, *(None if s is None else torch.from_numpy(s) for s in scales),
        chunk=case.chunk, out_dtype=tdt,
    )
    for ours, theirs in ((k, rk), (v, rv)):
        assert ours.dtype == tdt
        np.testing.assert_array_equal(ours.to(torch.float32).numpy(), np.asarray(theirs, np.float32))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))


# -- the Hopper kernels' design premises (K1/K2 in csrc/packed_matmul.cu) -------


def _overpacked_placements():
    return sorted({tuple(c) for w in BITS for a in BITS
                   if (c := choose_config(w, a)) is not None and c.overlap})


def test_xor_parity_premise_holds_for_every_overpacked_placement():
    """K1/K2 accumulate the parity word by XOR: exact only if no
    stride-aligned counter of the additive parity dot can carry, i.e.
    ``acc_chunk < 2**stride`` for every overpacked placement."""
    placements = _overpacked_placements()
    assert placements
    for n_seg, stride, acc_chunk, _ in placements:
        assert acc_chunk < 2**stride, (n_seg, stride, acc_chunk)
        if n_seg == 2:  # all 8 rows' parity bits share one word: 8 bits per segment
            assert 8 <= stride and stride + 8 <= 32, (n_seg, stride)


@pytest.mark.parametrize("placement", _overpacked_placements())
def test_xor_parity_word_peels_like_the_additive_dot(placement):
    """On random levels, the XOR-accumulated LSB plane equals the additive
    ``chunk_dot(a & 1, w & lsb_mask)`` at every bit ``(d+1)*stride`` the
    peel reads, and ``peel_chunk`` decodes the same values from either."""
    from repro_torch.kernels.peel import chunk_dot, peel_chunk

    n_seg, stride, acc_chunk, _ = placement
    w_bits, a_bits = next((w, a) for w in BITS for a in BITS
                          if (c := choose_config(w, a)) is not None and tuple(c) == placement)
    rng = np.random.default_rng(n_seg * 100 + stride)
    m, np_ = 8, 16
    a = torch.from_numpy(rng.integers(0, 1 << a_bits, (m, acc_chunk)).astype(np.int32))
    w_lvl = torch.from_numpy(rng.integers(0, 1 << w_bits, (acc_chunk, np_ * n_seg)).astype(np.int32))
    wp = pm.pack_weights(w_lvl, n_seg, stride)
    lsb = lsb_mask(n_seg, stride)
    additive = chunk_dot(a & 1, wp & lsb)
    am = lsb & -(a.to(torch.int64) & 1)  # [m, C]: the mask staged beside each level
    xor = torch.zeros((m, np_), dtype=torch.int64)
    for c in range(acc_chunk):
        xor ^= wp[c].to(torch.int64)[None, :] & am[:, c:c + 1]
    xor = xor.to(torch.int32)
    for d in range(n_seg - 1):
        bit = (d + 1) * stride
        assert torch.equal((xor >> bit) & 1, (additive >> bit) & 1), d
    part = chunk_dot(a, wp)
    got = peel_chunk(part, xor, n_seg=n_seg, stride=stride)
    want = peel_chunk(part, additive, n_seg=n_seg, stride=stride)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if n_seg == 2:
        # the kernels' one-word form: row r's LSB at bit d*stride + r of a word
        # staged per k; (w & lsb) * 0xFF widens each segment's LSB over 8 rows
        bits = ((a & 1) << torch.arange(m)[:, None]).sum(dim=0)  # [C] row LSBs
        staged = sum(bits << (d * stride) for d in range(n_seg)).to(torch.int64)
        word = torch.zeros((np_,), dtype=torch.int64)
        for c in range(acc_chunk):
            word ^= ((wp[c].to(torch.int64) & lsb) * 0xFF) & staged[c]
        rows = torch.stack([(word >> r) & 0xFFFFFFFF for r in range(m)]).to(torch.int64)
        for d in range(n_seg - 1):
            bit = (d + 1) * stride
            assert torch.equal(((rows >> bit) & 1).to(torch.int32), (additive >> bit) & 1), d
        one_word = peel_chunk(part, rows.to(torch.int32), n_seg=n_seg, stride=stride)
        for g, w in zip(one_word, want):
            assert torch.equal(g, w)
    # and the decode is the true segment dot
    for d, g in enumerate(got):
        assert torch.equal(g.long(), a.long() @ w_lvl[:, d::n_seg].long())


# llama3.2-3b at full width, w4a4 (n_seg 2): (K, Np) of every decode matmul
DECODE_SHAPES = {"wq|wo": (3072, 1536), "wk|wv": (3072, 512), "w_up|w_gate": (3072, 4096),
                 "w_down": (8192, 1536), "head": (3072, 64128)}


@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
@pytest.mark.parametrize("m", [1, 8])
def test_grid_plan_fills_an_h100_evenly_at_the_decode_shapes(shape, m):
    """At every decode shape the plan gives each of the H100's 132 SMs at
    least one 8-warp block and about the same bytes to move."""
    from repro_torch.kernels.packed_matmul.kernel import BM, BN, grid_plan

    k, np_ = DECODE_SHAPES[shape]
    sms = 132
    splits, kps = grid_plan(m, k, np_, sms)
    assert (splits - 1) * kps < k <= splits * kps
    units = -(-m // BM) * -(-np_ // BN) * splits
    assert units >= sms  # 8 warps resident on every SM
    # blocks handed out in order: the most loaded SM against the mean, in bytes
    most = -(-units // sms) * min(kps, k) * BN
    mean = k * np_ * -(-m // BM) / sms
    assert most <= 1.1 * mean, (splits, kps, units)


def test_copy_path_follows_the_packed_width():
    from repro_torch.kernels.packed_matmul.kernel import uses_vector_copy

    assert all(uses_vector_copy(np_) for _, np_ in DECODE_SHAPES.values())
    assert [uses_vector_copy(n) for n in (96, 300, 33, 7, 2)] == [True, True, False, False, False]
