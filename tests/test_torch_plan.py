"""Deployment plans in the port (``repro_torch.plan``, the packing LUTs of
``repro_torch.core.packing.optimizer``) against the JAX reference, on the
CPU.

What must be equal, exactly: LUT payloads, plan JSON and content hashes
(search, uniform, explicit bits, compile), error types for the inputs
the reference refuses, and each applied layer's placement, ``block_k``
and packed words.  The 3-layer fixture (llama3.2-3b smoke cut to 3
layers, float32, ``PRNGKey(0)`` weights carried across by the bridge)
serves one layer of each of w8a8 (plain integer path), w5a4 (n_seg 2,
``block_k=16``: K2) and w3a2 (n_seg 3: N padded) and a (4, 4) head.
Where the port prepacks for itself, a weight level may differ from the
reference's by one where ``tanh`` rounds differently in XLA and PyTorch
(ROADMAP.md §3); ``MAX_LEVEL_FLIPS`` bounds their share (none on this
fixture).  Engine logits agree to ``ATOL`` with tokens equal except at a
reference top-2 gap under ``TIE_BOUND`` (``tests/test_torch_model.py``).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import _prompts
from test_torch_chunked import _check_streams
from test_torch_model import _recording

from repro import plan as RP
from repro.configs import get_config as ref_get_config
from repro.core import packing as RPK
from repro.models import transformer as RT
from repro.plan import autotune as ref_autotune
from repro.plan import compile as ref_compile
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import build_engine as ref_build_engine
from repro_torch import plan as P
from repro_torch.bridge import packed_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import packing as PK
from repro_torch.core.packing import optimizer as opt
from repro_torch.kernels import common
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.models import transformer as T
from repro_torch.models.layers import prepack_lm_head
from repro_torch.plan import autotune, compile as plan_compile, search
from repro_torch.serving import EngineConfig, build_engine
from repro_torch.serving.api import quantize_params_packed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU engine on one intra-op thread (at the smoke size
    thread hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
FIXTURE_BITS = [(8, 8), (5, 4), (3, 2)]
MAX_LEVEL_FLIPS = 1e-3  # share of weight levels, each off by one at most


def _cfgs(smoke: bool = True, **kw):
    ref, ours = ref_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    return dataclasses.replace(ref, **kw), dataclasses.replace(ours, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fix3():
    """The 3-layer fixture: the reference's plan (one layer at block_k 16)
    and its apply_plan result, the port's plan from the same payload, the
    float params and the carried packed words."""
    rcfg, cfg = _cfgs(n_layers=3, dtype=jnp.float32)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rplan = RP.plan_from_bits(rcfg, arch=ARCH, bits=FIXTURE_BITS, head_bits=(4, 4))
    layers = list(rplan.layers)
    layers[1] = dataclasses.replace(layers[1], block_k=16)
    rplan = dataclasses.replace(rplan, layers=layers)
    rapplied, rhead = RP.apply_plan(rp, rcfg, rplan, verbose=False)
    return dict(rcfg=rcfg, cfg=cfg, rp=rp, rplan=rplan, rapplied=rapplied, rhead=rhead,
                plan=P.DeployPlan.from_payload(rplan.to_payload()), tp=params_from_jax(_np(rp)),
                carried=params_from_jax(_np(rapplied)), chead=packed_from_jax(_np(rhead)))


# -- LUTs ------------------------------------------------------------------------


@pytest.mark.parametrize("profile,kw", [("TPU_VPU15", dict(kernel_len=1, method="runtime")),
                                        ("DSP48E2", dict(kernel_len=3)),
                                        ("DSP48E2", dict(kernel_len=3, method="hikonv")),
                                        ("TPU_MXU8", dict(kernel_len=1, method="runtime")),
                                        ("DSP48E2", dict(kernel_len=5, method="xilinx"))])
def test_lut_payload_equals_reference(profile, kw):
    ours = PK.build_lut(getattr(PK, profile), **kw)
    assert ours.to_payload() == RPK.build_lut(getattr(RPK, profile), **kw).to_payload()
    assert PK.compare_luts(ours, ours)["equal"] == len(ours.table)
    assert [PK.lut_overhead_estimate(c) for c in ours.table.values()] == [
        RPK.lut_overhead_estimate(c) for c in RPK.build_lut(getattr(RPK, profile), **kw).table.values()]


def test_cached_luts_builds_once_and_invalidates_on_profile_change(tmp_path, monkeypatch):
    path = tmp_path / "luts" / "packing_luts.json"
    luts = PK.cached_luts(path, profile=PK.TPU_VPU15, kernel_lens=(1,))
    assert 1 in luts and sorted(p.name for p in tmp_path.rglob("*")) == ["luts", "packing_luts.json"]
    calls = []
    real = opt.build_lut
    monkeypatch.setattr(opt, "build_lut", lambda *a, **k: calls.append(1) or real(*a, **k))
    assert PK.cached_luts(path, profile=PK.TPU_VPU15, kernel_lens=(1,))[1].table == luts[1].table
    assert not calls  # loaded, not rebuilt
    fake = PK.MulProfile(name="tpu_vpu15", port_big=14, port_small=14)
    PK.cached_luts(path, profile=fake, kernel_lens=(1,))
    assert calls  # the same name with other ports: rebuilt
    path.write_text("{broken json")
    assert PK.cached_luts(path, profile=PK.TPU_VPU15, kernel_lens=(1,))[1].table == luts[1].table
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["luts", "packing_luts.json"]
    lut_path = tmp_path / "one.json"
    luts[1].save(lut_path)
    assert PK.PackingLUT.load(lut_path).table == luts[1].table


def test_serving_lut_builds_in_process_under_build(tmp_path):
    """The default cache lives under the git-ignored build/ directory; a
    missing cache is built in-process and written only at the given path."""
    assert search.DEFAULT_LUT_PATH.parent == ROOT / "build"
    path = tmp_path / "luts.json"
    lut = P.serving_lut(path=path)
    assert path.exists() and lut.to_payload() == RP.serving_lut(path=tmp_path / "ref.json").to_payload()


# -- plans -----------------------------------------------------------------------


def test_plan_json_roundtrip_and_hash_stable(tmp_path):
    cfg = get_config("gemma3-1b", smoke=True)
    plan = P.search_plan(cfg, arch="gemma3-1b", budget_frac=0.85)
    h0 = plan.content_hash()
    loaded = P.DeployPlan.load(plan.save(tmp_path / "p.json"))
    assert loaded.content_hash() == h0 and loaded.bit_pairs() == plan.bit_pairs()
    assert loaded.budget == plan.budget
    assert P.DeployPlan.load(loaded.save(tmp_path / "p2.json")).content_hash() == h0
    bumped = dataclasses.replace(plan, layers=[dataclasses.replace(plan.layers[0], w_bits=8)]
                                 + plan.layers[1:])
    assert bumped.content_hash() != h0
    assert "hash=" + h0 in P.summarize(plan)


def test_plan_file_equals_reference_file(tmp_path):
    cfg, rcfg = get_config(ARCH, smoke=True), ref_get_config(ARCH, smoke=True)
    ours = P.search_plan(cfg, arch=ARCH).save(tmp_path / "ours.json")
    theirs = RP.search_plan(rcfg, arch=ARCH).save(tmp_path / "theirs.json")
    assert ours.read_bytes() == theirs.read_bytes()
    assert P.DeployPlan.load(theirs).content_hash() == RP.DeployPlan.load(ours).content_hash()


def test_committed_drift_plan_loads_with_its_hash():
    path = ROOT / "artifacts" / "plans" / "drift-mixed.json"
    assert P.PLANS_DIR / "drift-mixed.json" == path
    stored = json.loads(path.read_text())["content_hash"]
    plan = P.DeployPlan.load(path)  # raises on a hash mismatch
    assert plan.content_hash() == stored == RP.DeployPlan.load(path).content_hash()


def _corrupt(payload):
    payload["layers"][0]["w_bits"] = 3  # tampered, hash kept


def _bad_bits(payload):
    payload["layers"][0]["w_bits"] = 99
    del payload["content_hash"]


def _v1(payload):
    payload["version"] = 1
    for layer in payload["layers"]:
        del layer["overlap"]
    del payload["content_hash"]


def _bad_overlap(payload):
    payload["layers"][0]["overlap"] = 2
    del payload["content_hash"]


def _no_layers(payload):
    payload["layers"] = []
    del payload["content_hash"]


@pytest.mark.parametrize("tamper", [_corrupt, _bad_bits, _v1, _bad_overlap, _no_layers])
def test_plan_refuses_what_the_reference_refuses(tmp_path, tamper):
    cfg = get_config("gemma3-1b", smoke=True)
    payload = json.loads(P.uniform_plan(cfg, arch="gemma3-1b", w_bits=4, a_bits=4)
                         .save(tmp_path / "p.json").read_text())
    tamper(payload)
    (tmp_path / "bad.json").write_text(json.dumps(payload))
    with pytest.raises(RP.PlanError):
        RP.DeployPlan.load(tmp_path / "bad.json")
    with pytest.raises(P.PlanError):
        P.DeployPlan.load(tmp_path / "bad.json")


# -- search ----------------------------------------------------------------------


def test_full_llama_search_hash_is_chip_smokes_constant():
    """The headline plan: the reference's hash, and the constant
    ``chip_smoke.py`` phase 11 holds the card's search against."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {t.id: node.value.value for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name) and isinstance(node.value, ast.Constant)}
    rcfg, cfg = _cfgs(smoke=False)
    ours = P.search_plan(cfg, arch=ARCH, objective="footprint", budget_frac=0.85, smoke=False)
    theirs = RP.search_plan(rcfg, arch=ARCH, objective="footprint", budget_frac=0.85, smoke=False)
    assert ours.content_hash() == theirs.content_hash() == consts["PLAN_HASH"]
    assert ours.bit_pairs() == [(8, 8)] * 3 + [(5, 4)] * 3 + [(3, 2)] * 22
    assert [(l.n_seg, l.stride, l.acc_chunk, l.overlap) for l in ours.layers[3:7]] == (
        [(2, 10, 4, 1)] * 3 + [(3, 6, 6, 1)])
    assert (ours.lm_head.w_bits, ours.lm_head.a_bits, ours.lm_head.n_seg) == (8, 8, 1)


@pytest.mark.parametrize("smoke,objective,budget", [(False, "footprint", 0.7), (False, "latency", 0.85),
                                                    (False, "latency", 0.7), (True, "footprint", 0.85),
                                                    (True, "latency", 0.7)])
def test_search_equals_reference(smoke, objective, budget):
    rcfg, cfg = _cfgs(smoke=smoke)
    kw = dict(arch=ARCH, objective=objective, budget_frac=budget, smoke=smoke)
    ours, theirs = P.search_plan(cfg, **kw), RP.search_plan(rcfg, **kw)
    assert ours.to_payload() == theirs.to_payload()
    assert ours.content_hash() == theirs.content_hash()


def test_search_with_pair_times_equals_reference():
    """A fixed synthetic table of measured times (w3a2 made slow) moves the
    choice in both packages alike."""
    rcfg, cfg = _cfgs(smoke=False)
    bits = search.DEFAULT_BIT_CHOICES
    times = {(w, a): 1e-4 * (1 + w / 8 + a / 16) * (3.0 if (w, a) == (3, 2) else 1.0)
             for w in bits for a in bits}
    kw = dict(arch=ARCH, pair_times=times, smoke=False)
    ours, theirs = P.search_plan(cfg, **kw), RP.search_plan(rcfg, **kw)
    assert ours.content_hash() == theirs.content_hash()
    assert ours.budget["measured_pair_times"] and (3, 2) not in ours.bit_pairs()
    with pytest.raises(ValueError, match="missing"):
        P.search_plan(cfg, arch=ARCH, pair_times={(4, 4): 1.0}, smoke=False)


@pytest.mark.parametrize("how", ["uniform44", "uniform88", "bits", "bits_head"])
def test_uniform_and_explicit_plans_equal_reference(how):
    rcfg, cfg = _cfgs(smoke=True)
    pairs = [(2, 3), (6, 5)]
    if how.startswith("uniform"):
        w = int(how[-2])
        ours, theirs = (mod.uniform_plan(c, arch=ARCH, w_bits=w, a_bits=int(how[-1]))
                        for mod, c in ((P, cfg), (RP, rcfg)))
    else:
        head = dict(head_bits=(4, 4)) if how == "bits_head" else {}
        ours, theirs = (mod.plan_from_bits(c, arch=ARCH, bits=pairs, **head)
                        for mod, c in ((P, cfg), (RP, rcfg)))
    assert ours.to_payload() == theirs.to_payload()
    assert ours.uniform == theirs.uniform


@pytest.mark.parametrize("case", ["infeasible", "bad_bits", "objective", "n_bits"])
def test_search_refuses_as_the_reference_refuses(case):
    rcfg, cfg = _cfgs(smoke=True)

    def call(mod, c):
        if case == "infeasible":
            return mod.search_plan(c, arch=ARCH, budget_frac=0.05)
        if case == "bad_bits":
            return mod.search_plan(c, arch=ARCH, bit_choices=(2, 12))
        if case == "objective":
            return mod.search_plan(c, arch=ARCH, objective="speed")
        return mod.plan_from_bits(c, arch=ARCH, bits=[(4, 4)])

    with pytest.raises(ValueError) as theirs:
        call(RP, rcfg)
    with pytest.raises(ValueError) as ours:
        call(P, cfg)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("arch,smoke", [("qwen3-moe-30b-a3b", True), ("llama4-scout-17b-a16e", False),
                                        ("gemma3-1b", False), ("mamba2-130m", True),
                                        ("mamba2-130m", False)])
def test_layer_shapes_and_costs_equal_reference(arch, smoke):
    """MoE shapes (top_k routed, every expert stored), the SSM family's
    (``ssm_in_z``, ``ssm_in_xbc``, ``ssm_out``) and costs, and the plan
    they give."""
    rcfg, cfg = ref_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    ours, theirs = P.layer_matmul_shapes(cfg), RP.layer_matmul_shapes(rcfg)
    assert [[dataclasses.astuple(p) for p in l] for l in ours] == [
        [dataclasses.astuple(p) for p in l] for l in theirs]
    assert (P.search_plan(cfg, arch=arch, smoke=smoke).to_payload()
            == RP.search_plan(rcfg, arch=arch, smoke=smoke).to_payload())


# -- apply -----------------------------------------------------------------------


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _levels(p: PackedDenseParams) -> torch.Tensor:
    """A packed leaf's weight levels ``[..., K, N_pad]``."""
    if p.cfg is None:
        return p.w_lvl
    mask = (1 << p.cfg.stride) - 1
    segs = [(p.w_packed >> (d * p.cfg.stride)) & mask for d in range(p.cfg.n_seg)]
    return torch.stack(segs, dim=-1).flatten(-2)


def test_uniform_plan_apply_equals_global_packed(fix3):
    cfg, tp = fix3["cfg"], fix3["tp"]
    plan = P.uniform_plan(cfg, arch=ARCH, w_bits=4, a_bits=4)
    applied, head = P.apply_plan(tp, cfg, plan, device="cpu")
    want = quantize_params_packed(tp, w_bits=4, a_bits=4, device="cpu")
    assert not isinstance(applied["layers"], list)  # the stacked layout stays
    got, exp = dict(_leaves(applied)), dict(_leaves(want))
    assert got.keys() == exp.keys()
    for k, a in got.items():
        b = exp[k]
        if isinstance(a, PackedDenseParams):
            assert dataclasses.replace(a, w_packed=None) == dataclasses.replace(b, w_packed=None), k
            assert torch.equal(a.w_packed, b.w_packed), k
        else:
            assert a is b, k
    want_head = prepack_lm_head(tp["embed"], w_bits=4, a_bits=4, device="cpu")
    assert torch.equal(head.w_packed, want_head.w_packed) and head.cfg == want_head.cfg


def test_uniform_plan_apply_equals_global_packed_ssm():
    """tests/test_plan.py test_uniform_plan_apply_bitexact_vs_global_packed
    at arch="mamba2-130m": a uniform (4, 4) plan packs the stacked layers
    byte for byte as ``quantize_params_packed`` does (``in_dt`` and the
    other SSM leaves stay the same float tensors) and carries the head."""
    arch = "mamba2-130m"
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    tp = T.init_params(cfg, seed=0, device="cpu")
    applied, head = P.apply_plan(tp, cfg, P.uniform_plan(cfg, arch=arch, w_bits=4, a_bits=4), device="cpu")
    want = quantize_params_packed(tp, w_bits=4, a_bits=4, device="cpu")
    assert not isinstance(applied["layers"], list)
    got, exp = dict(_leaves(applied)), dict(_leaves(want))
    assert got.keys() == exp.keys()
    assert sorted(k for k, v in got.items() if isinstance(v, PackedDenseParams)) == [
        "/layers/in_xbc/w", "/layers/in_z/w", "/layers/out_proj/w"]
    for k, a in got.items():
        b = exp[k]
        if isinstance(a, PackedDenseParams):
            assert dataclasses.replace(a, w_packed=None) == dataclasses.replace(b, w_packed=None), k
            assert torch.equal(a.w_packed, b.w_packed), k
        else:
            assert a is b, k
    want_head = prepack_lm_head(tp["embed"], w_bits=4, a_bits=4, device="cpu")
    assert torch.equal(head.w_packed, want_head.w_packed) and head.cfg == want_head.cfg


def test_mixed_plan_apply_matches_reference_per_layer(fix3):
    """Every layer's placement and block_k equal; carried words equal the
    reference's bit for bit; the port's own prepack within
    MAX_LEVEL_FLIPS."""
    cfg, plan = fix3["cfg"], fix3["plan"]
    assert plan.content_hash() == fix3["rplan"].content_hash() and not plan.uniform
    applied, head = P.apply_plan(fix3["tp"], cfg, plan, device="cpu")
    carried = fix3["carried"]
    assert isinstance(applied["layers"], list) and isinstance(carried["layers"], list)
    ours = dict(_leaves(applied["layers"]), head=head)
    theirs = dict(_leaves(carried["layers"]), head=fix3["chead"])
    ref = dict(_leaves(_np(fix3["rapplied"])["layers"]), head=_np(fix3["rhead"]))
    packed = [k for k, v in ours.items() if isinstance(v, PackedDenseParams)]
    assert len(packed) == 7 * 3 + 1
    flips = total = 0
    for k in packed:
        a, b, r = ours[k], theirs[k], ref[k]
        layer = plan.lm_head if k == "head" else plan.layers[int(k.split("/")[1])]
        assert (a.w_bits, a.a_bits) == (b.w_bits, b.a_bits) == (layer.w_bits, layer.a_bits), k
        assert a.cfg == b.cfg and a.block_k == b.block_k == r.block_k == layer.block_k, k
        placement = tuple(a.cfg) if a.cfg else (1, 0, 1, 0)
        assert placement == (layer.n_seg, layer.stride, layer.acc_chunk, layer.overlap), k
        assert np.array_equal(b.data.numpy(), np.asarray(r.w_packed if r.cfg else r.w_lvl)), k
        assert a.n_out == b.n_out and a.data.shape == b.data.shape, k
        d = (_levels(a) - _levels(b)).abs()
        assert int(d.max()) <= 1, k
        flips, total = flips + int(d.sum()), total + d.numel()
    assert flips <= MAX_LEVEL_FLIPS * total, (flips, total)
    # the n_seg 3 layer pads wk's N = 32 to 33 and drops the padding
    wk = ours["/2/attn/wk/w"]
    assert wk.cfg.n_seg == 3 and wk.w_packed.shape[-1] * 3 == 33 and wk.n_out == 32


def _packed_leaves(tree, path=""):
    """(path, leaf) of every packed leaf of a params tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packed_leaves(v, f"{path}/{k}")
    elif hasattr(tree, "w_bits"):
        yield path, tree


def test_bridge_carries_a_mixed_plan(fix3):
    """The reference's heterogeneous apply_plan result crosses as a
    per-layer list of packed leaves with differing placements and block_k."""
    layers = fix3["carried"]["layers"]
    assert isinstance(layers, list) and len(layers) == 3
    wq = [layer["attn"]["wq"]["w"] for layer in layers]
    assert [w.cfg.n_seg if w.cfg else 1 for w in wq] == [1, 2, 3]
    assert [w.block_k for w in wq] == [None, 16, None]
    assert wq[0].w_lvl is not None and wq[0].w_packed is None


def test_apply_plan_refuses_tp_and_mismatches(fix3):
    """``tp=(2, rank)``: each mesh rank's sliced-then-packed layers and head
    equal the reference's (carried across); then the refusals."""
    cfg, plan = fix3["cfg"], fix3["plan"]
    for rank in range(2):
        ours, head = P.apply_plan(fix3["tp"], cfg, plan, verbose=False, tp=(2, rank), device="cpu")
        rparams, rhead = RP.apply_plan(fix3["rp"], fix3["rcfg"], fix3["rplan"], verbose=False, tp=(2, rank))
        carried, chead = params_from_jax(_np(rparams)), packed_from_jax(_np(rhead))
        assert torch.equal(head.data, chead.data) and head.w_scale == chead.w_scale
        for mine, theirs in zip(ours["layers"], carried["layers"]):
            for path, leaf in _packed_leaves(mine):
                other = dict(_packed_leaves(theirs))[path]
                assert torch.equal(leaf.data, other.data) and leaf.cfg == other.cfg, (rank, path)
                assert (leaf.w_scale, leaf.block_k) == (other.w_scale, other.block_k), (rank, path)
        assert torch.equal(ours["head_embed"], carried["head_embed"])
    with pytest.raises(ValueError, match="layers"):
        P.apply_plan(fix3["tp"], dataclasses.replace(cfg, n_layers=2), plan, device="cpu")
    skipped = []
    P.prepack_tree({"attn": {"wq": {"w": torch.ones(2, 2, 2, 2)}}}, w_bits=4, a_bits=4,
                   skipped=skipped, device="cpu")
    assert skipped == ["attn/wq/w"]


def test_tanh_max_tree_normalizer_matches_prepack(fix3):
    """Packing with each matrix's own tanh normalizer given explicitly
    equals packing without it."""
    tree = fix3["tp"]["layers"]["attn"]
    tmt = P.apply.tanh_max_tree(tree)
    assert tmt["wq"]["w"].shape == (3,)
    a = P.prepack_tree(tree, w_bits=5, a_bits=4, t_max_tree=tmt, device="cpu")
    b = P.prepack_tree(tree, w_bits=5, a_bits=4, device="cpu")
    assert torch.equal(a["wq"]["w"].w_packed, b["wq"]["w"].w_packed)


# -- engine ----------------------------------------------------------------------

ENGINE_KW = {
    "C1": dict(n_slots=4, page_size=8, max_len=64, chunk_tokens=1, gather_backend="kernel"),
    "chunk4-on-demand": dict(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4,
                             admit="on-demand", gather_backend="kernel"),
}


@pytest.fixture(scope="module")
def ref_runs(fix3):
    """The reference engine with the plan, once per engine config: its
    metrics, sampled rows, the engine (for tokens) and the prompts."""
    out = {}
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], fix3["cfg"].vocab)
    for name, kw in ENGINE_KW.items():
        reng = ref_build_engine(fix3["rcfg"], RefEngineConfig(**kw), params=fix3["rp"], plan=fix3["rplan"])
        rec = _recording(reng, ref=True)
        for p in prompts:
            reng.submit(p, 6)
        out[name] = (reng.run(realtime=False), rec, reng, prompts)
    return out


@pytest.mark.parametrize("words", ["plan", "carried"])
@pytest.mark.parametrize("ecfg_name", list(ENGINE_KW))
def test_plan_engine_matches_reference(fix3, ref_runs, ecfg_name, words):
    """``build_engine(plan=...)`` from the float params ("plan"), and the
    reference's applied words and head carried across ("carried"): every
    sampled row within ATOL of the reference engine's, the same steps,
    tokens fed and preemptions, no leak."""
    rm, rrec, reng, prompts = ref_runs[ecfg_name]
    ecfg = EngineConfig(**ENGINE_KW[ecfg_name])
    if words == "plan":
        eng = build_engine(fix3["cfg"], ecfg, params=fix3["tp"], plan=fix3["plan"], device="cpu")
    else:
        eng = build_engine(fix3["cfg"], ecfg, params=fix3["carried"], head=fix3["chead"], device="cpu")
    assert isinstance(eng.params["layers"], list) and eng._head.cfg.n_seg == 2
    rec = _recording(eng, ref=False)
    for p in prompts:
        eng.submit(p, 6)
    m = eng.run(realtime=False)
    assert m["statuses"] == {"ok": 3}
    assert (m["preemptions"] > 0) == (ecfg.admit == "on-demand")
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m[key] == rm[key], key
    _check_streams(reng, eng, rrec, rec)
    eng.assert_no_leaks()


def test_build_engine_plan_exclusions(fix3):
    cfg, plan = fix3["cfg"], fix3["plan"]
    with pytest.raises(ValueError, match="not both"):
        build_engine(cfg, EngineConfig(), params=fix3["tp"], plan=plan, quant="packed", device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        build_engine(cfg, EngineConfig(), params=fix3["tp"], plan=plan, head=fix3["chead"],
                     device="cpu")


# -- autotune and the timer ------------------------------------------------------


@pytest.mark.parametrize("k", [40, 64, 512, 3072, 8192])
def test_candidate_block_ks_equal_reference(k):
    assert autotune.candidate_block_ks(k) == ref_autotune.candidate_block_ks(k, interpret=False)


def test_autotune_on_the_cpu_fills_block_k_and_caches(fix3, monkeypatch):
    cfg, plan = fix3["cfg"], fix3["plan"]
    calls = []
    real = common.timed
    monkeypatch.setattr(common, "timed", lambda *a, **k: calls.append(1) or real(*a, **k))
    tuned = P.autotune_plan(plan, cfg, reps=1, device="cpu")
    shapes = P.layer_matmul_shapes(cfg, 8)
    assert calls and tuned.autotune["backend"] == "cpu"
    table = tuned.autotune["table"]
    assert sorted(table) == sorted(f"8x64x128|w{w}a{a}|cpu" for w, a in FIXTURE_BITS)
    for lp, projs in zip(tuned.layers, shapes):
        dom = max(projs, key=lambda p: p.m * p.k * p.n)
        entry = table[f"8x{dom.k}x{dom.n}|w{lp.w_bits}a{lp.a_bits}|cpu"]
        assert lp.block_k == entry["block_k"] in autotune.candidate_block_ks(dom.k)
        assert sorted(entry["timings_us"]) == sorted(map(str, autotune.candidate_block_ks(dom.k)))
    assert tuned.validate() is tuned
    n = len(calls)
    again = P.autotune_plan(tuned, cfg, reps=1, device="cpu")
    assert len(calls) == n and again.autotune["table"] == table  # nothing re-timed
    applied, _ = P.apply_plan(fix3["tp"], cfg, tuned, device="cpu")
    assert applied["layers"][1]["mlp"]["w_up"]["w"].block_k == tuned.layers[1].block_k


def test_measure_pair_times_on_the_cpu_keys_every_pair():
    cfg = get_config(ARCH, smoke=True)
    times = P.measure_pair_times(cfg, bit_choices=(2, 4, 8), n_slots=2, reps=1, device="cpu")
    assert sorted(times) == sorted((w, a) for w in (2, 4, 8) for a in (2, 4, 8))
    assert all(t > 0 for t in times.values())


def test_timer_takes_the_named_device():
    out, dt = common.timed(lambda a: a + 1, 1, device="cpu")
    assert out == 2 and dt >= 0.0
    ran = []
    unit = common.repeat(ran.append, 3, "cpu")
    unit()
    assert ran == [0, 1, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.timed(lambda: None, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.autotune_plan(P.uniform_plan(get_config(ARCH, smoke=True), arch=ARCH, w_bits=4, a_bits=4),
                            get_config(ARCH, smoke=True))


# -- compile ---------------------------------------------------------------------


def test_compile_cli_writes_the_reference_json(tmp_path):
    args = ["--arch", ARCH, "--full"]
    ref_compile.main(args + ["--out", str(tmp_path / "ref.json")])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-m", "repro_torch.plan.compile", *args, "--out",
                    str(tmp_path / "ours.json")], check=True, cwd=tmp_path, env=env,
                   capture_output=True, timeout=120)
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("args", [["--uniform", "4", "4", "--head-bits", "4", "4"],
                                  ["--layer-bits", "2,2", "5,4"], ["--objective", "latency", "--beam", "3"]])
def test_compile_options_equal_reference(tmp_path, args):
    ref_compile.main(args + ["--out", str(tmp_path / "ref.json")])
    plan_compile.main(args + ["--out", str(tmp_path / "ours.json")])
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("flag,item", [(["--from-nas", "x.json", "--trace-cost"], "do not apply to --from-nas"),
                                       (["--trace-cost"], "port queue 1, item 4")])
def test_compile_refuses_what_is_not_ported(flag, item):
    """``--trace-cost`` waits for the port's step-cost tracer; with
    ``--from-nas`` it is refused first, as the reference refuses it."""
    with pytest.raises(SystemExit, match=item):
        plan_compile.main(flag)
