"""The port's accelerator customization (``core/customize``: Bayesian
ridge, the synthesis stand-in, Algorithm 1's allocation), the NAS-to-plan
adapter (``plan.search.plan_from_nas_result``, ``plan.compile
--from-nas``) and the ``bitpack`` oracle against the reference, on the
CPU; and every engine-free test of ``tests/test_nas_customize.py`` run on
the port.

The customization is numpy on both sides, so everything is equal
exactly: predictor fits, candidate sets and ``Allocation``s (compared as
``dataclasses.asdict``, the packing configs of the two packages'
classes field by field), plan JSON files byte for byte with their
content hashes, and the oracle's integers.
"""
from __future__ import annotations

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import customize as RCU
from repro.core import nas as RN
from repro.core.packing import DSP48E2 as RDSP48E2
from repro.core.packing import bitpack as rbp
from repro.core.packing import build_lut as ref_build_lut
from repro.models import convnets as RC
from repro.plan import compile as ref_compile
from repro.plan import search as ref_search
from repro_torch.core import customize as CU
from repro_torch.core import nas as N
from repro_torch.core.nas import supernet as S
from repro_torch.core.packing import DSP48E2, bitpack, build_lut
from repro_torch.core.quant import fake_quant_act, fake_quant_weight
from repro_torch.models import convnets as C
from repro_torch.plan import compile as plan_compile
from repro_torch.plan import search as plan_search

NAS_BITS = {
    "vgg_tiny": [(2, 2), (3, 2), (4, 4), (2, 3), (5, 4), (4, 2), (8, 8)],
    "ultranet": [(4, 6), (2, 3), (2, 2), (3, 3), (4, 4), (4, 4), (5, 4), (5, 5), (6, 6)],
    "skynet": [(8, 8), (4, 4), (3, 3), (2, 4), (5, 5), (4, 3), (6, 2), (2, 2), (3, 5), (4, 4), (7, 7), (4, 6), (8, 8)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (at these sizes thread hand-offs cost more than
    the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def luts():
    return {k: build_lut(DSP48E2, kernel_len=k, seq_len=32) for k in (1, 3)}


@pytest.fixture(scope="module")
def ref_luts():
    return {k: ref_build_lut(RDSP48E2, kernel_len=k, seq_len=32) for k in (1, 3)}


def _asdict(x):
    return [dataclasses.asdict(c) for c in x] if isinstance(x, list) else dataclasses.asdict(x)


# -- customization against the reference --------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bayesian_ridge_equals_reference(seed):
    g = np.random.default_rng(seed)
    X = g.normal(size=(120, 6)) * g.uniform(0.1, 10, 6)
    y = X @ g.normal(size=6) + g.normal(0, 0.3, 120)
    ours, ref = CU.BayesianRidge().fit(X, y), RCU.BayesianRidge().fit(X, y)
    for k in ("mean_", "cov_", "x_mu_", "x_sd_"):
        assert np.array_equal(getattr(ours, k), getattr(ref, k))
    assert (ours.alpha, ours.beta, ours.y_mu_) == (ref.alpha, ref.beta, ref.y_mu_)
    m, s = ours.predict(X[:9], return_std=True)
    rm, rs = ref.predict(X[:9], return_std=True)
    assert np.array_equal(m, rm) and np.array_equal(s, rs)
    assert ours.r2(X, y) == ref.r2(X, y)


@pytest.mark.parametrize("name", ["vgg_tiny", "ultranet", "skynet"])
def test_sample_space_predictors_and_allocation_equal_reference(name, luts, ref_luts):
    spec, rspec = C.CONVNETS[name](), RC.CONVNETS[name]()
    bits = NAS_BITS[name]
    space, rspace = CU.sample_space(spec, bits, luts), RCU.sample_space(rspec, bits, ref_luts)
    assert [_asdict(s) for s in space] == [_asdict(s) for s in rspace]
    assert [CU.stage_features(c) for c in space[1]] == [RCU.stage_features(c) for c in rspace[1]]
    g, rg = np.random.default_rng(3), np.random.default_rng(3)
    assert [CU.stage_resources(c, g) for c in space[0][:20]] == [RCU.stage_resources(c, rg) for c in rspace[0][:20]]
    preds = CU.train_predictors([c for st_ in space for c in st_][::5], seed=1)
    rpreds = RCU.train_predictors([c for st_ in rspace for c in st_][::5], seed=1)
    assert preds.r2 == rpreds.r2
    assert preds.estimate_batch(space[2]) == rpreds.estimate_batch(rspace[2])
    for kw in (dict(), dict(allow_lut_arith=True), dict(max_dsp=180), dict(max_dsp=40, max_lut=9000)):
        ours, ref = CU.allocate(space, preds, **kw), RCU.allocate(rspace, rpreds, **kw)
        assert (ours is None) == (ref is None)
        if ours is not None:
            assert _asdict(ours) == _asdict(ref)
    assert CU.ULTRA96 == RCU.ULTRA96
    rt = CU.resource_model.runtime_packing(4, 4, kernel_len=3)
    assert _asdict(rt) == _asdict(RCU.resource_model.runtime_packing(4, 4, kernel_len=3))


def test_allocation_of_searched_bits_equals_reference(luts, ref_luts):
    """Algorithm 1 on the bits a short port search selects (at a cut input
    size), the full-size spec's stages."""
    spec = C.ultranet(in_hw=(16, 32))
    bits = N.search(spec, luts, eta=1.0, steps=3, batch=4, n_data=8, seed=0, device="cpu").bits
    space, rspace = CU.sample_space(C.ultranet(), bits, luts), RCU.sample_space(RC.ultranet(), bits, ref_luts)
    preds = CU.train_predictors([c for st_ in space for c in st_][::7])
    rpreds = RCU.train_predictors([c for st_ in rspace for c in st_][::7])
    assert _asdict(CU.allocate(space, preds)) == _asdict(RCU.allocate(rspace, rpreds))


# -- the NAS-to-plan adapter ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["vgg_tiny", "ultranet", "skynet"])
def test_plan_from_nas_result_equals_reference(name, tmp_path):
    luts = {k: build_lut(DSP48E2, kernel_len=k) for k in (1, 3, 5)}
    rluts = {k: ref_build_lut(RDSP48E2, kernel_len=k) for k in (1, 3, 5)}
    res = types.SimpleNamespace(bits=NAS_BITS[name], op_dsp=1234.5, final_metric=0.5)
    ours = plan_search.plan_from_nas_result(res, C.CONVNETS[name](), luts, arch=name)
    ref = ref_search.plan_from_nas_result(res, RC.CONVNETS[name](), rluts, arch=name)
    assert ours.family == "convnet" and ours.source == "nas" and ours.bit_pairs() == NAS_BITS[name]
    assert ours.content_hash() == ref.content_hash()
    ours.save(tmp_path / "ours.json")
    ref.save(tmp_path / "ref.json")
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    with pytest.raises(ValueError, match="NAS result has"):
        plan_search.plan_from_nas_result(types.SimpleNamespace(bits=NAS_BITS[name][:-1]),
                                         C.CONVNETS[name](), luts, arch=name)


@pytest.fixture
def lut_paths(tmp_path, monkeypatch):
    """Each package's LUT cache in a file of its own under ``tmp_path``."""
    monkeypatch.setattr(ref_search, "DEFAULT_LUT_PATH", tmp_path / "ref_luts.json")
    monkeypatch.setattr(plan_search, "DEFAULT_LUT_PATH", tmp_path / "luts.json")


@pytest.mark.parametrize("name", ["vgg_tiny", "ultranet", "skynet"])
def test_compile_from_nas_writes_the_reference_json(name, tmp_path, lut_paths):
    payload = {"other": {"bits": [[4, 4]] * 7}, name: {"bits": NAS_BITS[name], "op_dsp": 99.5, "metric": 0.25}}
    src = tmp_path / "selected_bits.json"
    src.write_text(json.dumps(payload))
    args = ["--from-nas", str(src), "--nas-spec", name]
    ref_compile.main(args + ["--out", str(tmp_path / "ref.json")])
    plan_compile.main(args + ["--out", str(tmp_path / "ours.json")])
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    saved = json.loads((tmp_path / "ours.json").read_text())
    assert saved["predicted"]["op_dsp"] == 99.5 and saved["arch"] == name
    # an unknown --nas-spec takes the file's first model, as the reference
    src.write_text(json.dumps({name: payload[name]}))
    plan_compile.main(["--from-nas", str(src), "--nas-spec", "nope", "--out", str(tmp_path / "first.json")])
    ref_compile.main(["--from-nas", str(src), "--nas-spec", "nope", "--out", str(tmp_path / "rfirst.json")])
    assert (tmp_path / "first.json").read_bytes() == (tmp_path / "rfirst.json").read_bytes()


@pytest.mark.parametrize("flag", ["--autotune", "--trace-cost"])
def test_compile_from_nas_refuses_as_the_reference(flag, tmp_path, lut_paths):
    src = tmp_path / "selected_bits.json"
    src.write_text(json.dumps({"vgg_tiny": {"bits": NAS_BITS["vgg_tiny"]}}))
    for main in (ref_compile.main, plan_compile.main):
        with pytest.raises(SystemExit, match="do not apply to --from-nas convnet plans"):
            main(["--from-nas", str(src), flag])


# -- bitpack ------------------------------------------------------------------------------


def test_bitpack_exports_as_the_reference():
    from repro.core import packing as RPK
    from repro_torch.core import packing as PK

    assert PK.bitpack is bitpack and "bitpack" in PK.__all__ and "bitpack" in RPK.__all__
    names = {k for k in vars(rbp) if not k.startswith("__")}
    assert names <= set(vars(bitpack))


@settings(max_examples=120, deadline=None)
@given(d_bits=st.integers(2, 6), e_bits=st.integers(2, 6), n_d=st.integers(1, 3), n_e=st.integers(1, 3),
       overlap=st.integers(0, 1), seed=st.integers(0, 2**31 - 1))
def test_kernel_packing_equals_reference(d_bits, e_bits, n_d, n_e, overlap, seed):
    stride = d_bits + e_bits - overlap + 1
    cfg = bitpack.KernelPacked(d_bits, e_bits, n_d, n_e, stride, overlap)
    rcfg = rbp.KernelPacked(d_bits, e_bits, n_d, n_e, stride, overlap)
    g = np.random.default_rng(seed)
    d = [int(v) for v in g.integers(0, 1 << d_bits, n_d)]
    e = [int(v) for v in g.integers(0, 1 << e_bits, n_e)]
    prod = bitpack.kernel_pack_multiply(cfg, d, e)
    assert prod == rbp.kernel_pack_multiply(rcfg, d, e)
    out = bitpack.kernel_pack_decode(cfg, prod, d, e)
    assert np.array_equal(out, rbp.kernel_pack_decode(rcfg, prod, d, e))
    assert np.array_equal(out, np.outer(d, e))


@settings(max_examples=120, deadline=None)
@given(w_bits=st.integers(2, 5), a_bits=st.integers(2, 5), k_p=st.integers(1, 3), n_p=st.integers(1, 4),
       overlap=st.integers(0, 1), k=st.integers(1, 7), n=st.integers(1, 12), channels=st.integers(1, 3),
       seed=st.integers(0, 2**31 - 1))
def test_filter_packing_equals_reference(w_bits, a_bits, k_p, n_p, overlap, k, n, channels, seed):
    guard = int(np.ceil(np.log2(channels * min(k_p, n_p)))) if channels * min(k_p, n_p) > 1 else 0
    stride = w_bits + a_bits + guard - overlap
    cfg = bitpack.FilterPacked(w_bits, a_bits, k_p, n_p, stride, overlap)
    rcfg = rbp.FilterPacked(w_bits, a_bits, k_p, n_p, stride, overlap)
    assert (cfg.num_segments, cfg.guard_bits, cfg.accum_headroom) == (
        rcfg.num_segments, rcfg.guard_bits, rcfg.accum_headroom)
    g = np.random.default_rng(seed)
    chans = [([int(v) for v in g.integers(0, 1 << w_bits, k)], [int(v) for v in g.integers(0, 1 << a_bits, n)])
             for _ in range(channels)]
    f, s = chans[0]
    try:
        want = rbp.conv1d_via_filter_packing(rcfg, f, s, accumulate_channels=chans[1:])
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            bitpack.conv1d_via_filter_packing(cfg, f, s, accumulate_channels=chans[1:])
        return
    ours = bitpack.conv1d_via_filter_packing(cfg, f, s, accumulate_channels=chans[1:])
    assert np.array_equal(ours, want)


@settings(max_examples=60, deadline=None)
@given(bits=st.integers(1, 16), seed=st.integers(0, 2**31 - 1))
def test_operand_separation_and_decode_equal_reference(bits, seed):
    g = np.random.default_rng(seed)
    v = int(g.integers(0, 1 << bits))
    assert bitpack.separate_operand(v, bits) == rbp.separate_operand(v, bits)
    vals = [int(x) for x in g.integers(0, 1 << 6, 4)]
    packed = bitpack.pack(vals, 9)
    assert packed == rbp.pack(vals, 9)
    assert bitpack.decode_segments(packed, 9, 4) == rbp.decode_segments(packed, 9, 4)
    with pytest.raises(ValueError):
        bitpack.decode_segments(packed, 9, 4, overlap=2)
    with pytest.raises(ValueError):
        bitpack.kernel_pack_multiply(bitpack.KernelPacked(2, 2, 1, 1, 5, 0), [4], [1])
# -- the engine-free tests of tests/test_nas_customize.py, on the port ------------------


def _trainable(tree: dict) -> dict:
    return {k: {kk: v.clone().requires_grad_(True) for kk, v in d.items()} for k, d in tree.items()}


def test_fake_quant_weight_levels():
    w = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (64,))))
    for bits in (2, 4, 8):
        q = fake_quant_weight(w, bits)
        assert q.min() >= -1.0 and q.max() <= 1.0
        assert len(np.unique(q.numpy())) <= 2**bits


def test_fake_quant_act_levels_and_ste():
    x = torch.linspace(-0.5, 1.5, 101)
    q = fake_quant_act(x, 3)
    assert q.min() >= 0.0 and q.max() <= 1.0
    assert len(np.unique(q.numpy())) <= 8
    v = torch.full((4,), 0.5, requires_grad=True)
    torch.sum(fake_quant_act(v, 3)).backward()
    assert np.allclose(v.grad.numpy(), 1.0)


def test_supernet_forward_and_grads(luts):
    spec = C.vgg_tiny()
    space = S.SearchSpace(bit_choices=(2, 4, 8))
    params = C.init_params(0, spec, device="cpu")
    alphas = _trainable(S.init_alphas(spec, space, device="cpu"))
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 3, 32, 32))))
    with torch.no_grad():
        out = S.supernet_apply(params, alphas, spec, x, space)
    assert out.shape == (2, 10)
    assert not torch.any(torch.isnan(out))
    tables, ops = S.t_mul_tables(spec, luts, space, device="cpu"), S.op_muls(spec, device="cpu")
    S.complexity_loss(alphas, tables, ops, bit_choices=space.bit_choices).backward()
    norms = [float(v.grad.abs().sum()) for lay in alphas.values() for v in lay.values()]
    assert any(n > 0 for n in norms), "complexity loss must be differentiable in alphas"


def test_complexity_loss_prefers_low_bits(luts):
    """Pushing probability mass to low bit-widths must reduce Eq. 8."""
    spec = C.vgg_tiny()
    space = S.SearchSpace(bit_choices=(2, 4, 8))
    tables, ops = S.t_mul_tables(spec, luts, space, device="cpu"), S.op_muls(spec, device="cpu")
    low = {f"layer{i}": {"w": torch.tensor([8.0, 0, 0]), "a": torch.tensor([8.0, 0, 0])} for i in range(len(spec.layers))}
    high = {f"layer{i}": {"w": torch.tensor([0, 0, 8.0]), "a": torch.tensor([0, 0, 8.0])} for i in range(len(spec.layers))}
    assert S.complexity_loss(low, tables, ops) < S.complexity_loss(high, tables, ops)


def test_eta_sweep_moves_op_dsp(luts):
    """Fig. 5 behaviour: higher eta => fewer expected DSP ops at selection."""
    spec = C.vgg_tiny(in_hw=(16, 16))
    r_lo = N.search(spec, luts, eta=0.0, steps=30, batch=16, n_data=128, seed=0, device="cpu")
    r_hi = N.search(spec, luts, eta=3.0, steps=30, batch=16, n_data=128, seed=0, device="cpu")
    assert r_hi.op_dsp <= r_lo.op_dsp


def test_op_dsp_matches_manual(luts):
    spec = C.vgg_tiny()
    bits = [(4, 4)] * len(spec.layers)
    expect = sum(
        spec.op_mul(i) / luts[l.kernel if l.kernel in luts else 3].t_mul(4, 4)
        for i, l in enumerate(spec.layers)
    )
    assert np.isclose(S.op_dsp(spec, bits, luts), expect)


def test_bayesian_ridge_recovers_linear():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4))
    w = np.array([3.0, -2.0, 0.5, 0.0])
    y = X @ w + 1.5 + rng.normal(0, 0.01, 200)
    m = CU.BayesianRidge().fit(X, y)
    assert m.r2(X, y) > 0.999
    mean, std = m.predict(X[:5], return_std=True)
    assert std.shape == (5,) and np.all(std > 0)


def test_allocation_respects_budgets(luts):
    spec = C.vgg_tiny()
    bits = [(4, 4)] * len(spec.layers)
    space = CU.sample_space(spec, bits, luts)
    preds = CU.train_predictors([c for st_ in space for c in st_][::5])
    alloc = CU.allocate(space, preds, max_dsp=360, max_lut=70_560)
    assert alloc is not None
    assert alloc.dsp_used <= 360 * 1.1  # predictor tolerance
    assert alloc.min_wns > 0
    # halving the DSP budget cannot improve the II
    alloc_half = CU.allocate(space, preds, max_dsp=180, max_lut=70_560)
    assert alloc_half.latency_cycles >= alloc.latency_cycles - 1e-6


def test_lut_replacement_helps(luts):
    """Table I: enabling LUT arithmetic must not reduce throughput."""
    spec = C.ultranet(in_hw=(160, 320))
    bits = [(4, 4)] * len(spec.layers)
    space = CU.sample_space(spec, bits, luts)
    preds = CU.train_predictors([c for st_ in space for c in st_][::5])
    base = CU.allocate(space, preds, allow_lut_arith=False)
    plus = CU.allocate(space, preds, allow_lut_arith=True)
    assert plus.fps >= base.fps


def test_mixed_precision_reduces_op_dsp_and_improves_fps(luts):
    """The paper's core claim, end to end on UltraNet:

    NAS-style low-bit middle layers -> fewer DSP ops -> higher FPS at the
    same resource budget."""
    spec = C.ultranet()
    L = len(spec.layers)
    mc = [(8, 8)] + [(4, 4)] * (L - 2) + [(8, 8)]
    mix = [(4, 6), (2, 3), (2, 2), (3, 3), (4, 4), (4, 4), (5, 4), (5, 5), (6, 6)]
    assert S.op_dsp(spec, mix, luts) < S.op_dsp(spec, mc, luts)
    space_mc, space_mix = CU.sample_space(spec, mc, luts), CU.sample_space(spec, mix, luts)
    preds = CU.train_predictors(
        ([c for st_ in space_mc for c in st_] + [c for st_ in space_mix for c in st_])[::7]
    )
    a_mc = CU.allocate(space_mc, preds)
    a_mix = CU.allocate(space_mix, preds)
    assert a_mix.fps > a_mc.fps
