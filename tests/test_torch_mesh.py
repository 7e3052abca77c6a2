"""Mesh serving in the port (``EngineConfig(mesh=MeshConfig(dp, mp))``)
against the JAX reference, on the CPU, at the smoke sizes.

The port runs a replica's ``mp`` tensor-parallel ranks in lockstep in one
process, its collectives plain functions over the ranks' tensors
(:mod:`repro_torch.launch.mesh`); every rank here sits on the CPU
(``devices=["cpu"] * n``).  The reference needs a device a rank, so it is
held three ways: its slicing and packing (no mesh needed) leaf for leaf;
its tensor-parallel step under ``jax.vmap`` with the model axis named
(``psum`` and ``all_gather`` are defined there), per rank; and its own mesh
engine in a subprocess with four forced host devices.

Tolerances.  Slices, packed words and scales are bit-equal.  Data-parallel
replicas (``mp == 1``) step the same program as the single engine, so
their tokens are bit-identical to it at bfloat16.  Under ``mp > 1`` the
block outputs are summed over the ranks, so a row differs from the single
engine's by float rounding: the engines run at float32, where the
reference gates token identity under a mesh too
(``tests/multidevice_checks.py``), and rows agree to ``ATOL``.  The
expert-sharded MoE is held to the dense oracle at ``MOE_TOL``, as the
reference's check holds its own.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import _prompts

import repro.plan as RP
from repro.configs import get_config as ref_get_config
from repro.core.quant import weight_tanh_max as ref_weight_tanh_max
from repro.models.layers import prepack_lm_head as ref_prepack_lm_head
from repro.models import moe as RX
from repro.models import transformer as RT
from repro.parallel import sharding as RS
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import MeshConfig as RefMeshConfig
from repro.serving import api as RA
from repro.serving import build_engine as ref_build_engine
from repro_torch import plan as P
from repro_torch.bridge import packed_from_jax, params_from_jax, shards_from_jax
from repro_torch.configs import get_config
from repro_torch.core.quant import weight_tanh_max
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams, choose_config, packed_dense, prepack_dense
from repro_torch.launch import mesh as LM
from repro_torch.models import moe as X
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S
from repro_torch.serving import ChaosConfig, EngineConfig, MeshConfig, build_engine
from repro_torch.serving import api as A

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-5
MOE_TOL = 2e-3
SLICE_ARCHS = ("llama3.2-3b", "qwen3-moe-30b-a3b", "mamba2-130m")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU engine on one intra-op thread (at the smoke size
    thread hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch: str, float32: bool = True, **kw):
    ref, ours = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if float32:
        ref, ours = dataclasses.replace(ref, dtype=jnp.float32), dataclasses.replace(ours, dtype=torch.float32)
    return dataclasses.replace(ref, **kw), dataclasses.replace(ours, **kw)


@functools.lru_cache(maxsize=None)
def _params(arch: str, float32: bool = True, **kw):
    """The reference's ``init_params(PRNGKey(0))`` and the port's twin
    (made once a process; no test writes into them)."""
    rcfg, cfg = _cfgs(arch, float32, **kw)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rp, params_from_jax(_np(rp))


def _same(ours, theirs, path: str = "") -> None:
    """Two port trees equal leaf for leaf: tensors in dtype, shape and bits,
    packed leaves in words and metadata."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(theirs), (path, sorted(ours), sorted(theirs))
        for k in theirs:
            _same(ours[k], theirs[k], f"{path}/{k}")
    elif isinstance(theirs, (list, tuple)):
        assert isinstance(ours, (list, tuple)) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _same(a, b, f"{path}/{i}")
    elif isinstance(theirs, PackedDenseParams):
        assert isinstance(ours, PackedDenseParams), path
        strip = lambda p: dataclasses.replace(p, w_packed=None, w_lvl=None)  # noqa: E731
        assert strip(ours) == strip(theirs), (path, strip(ours), strip(theirs))
        assert torch.equal(ours.data, theirs.data), path
    else:
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, (path, ours.dtype, ours.shape,
                                                                           theirs.dtype, theirs.shape)
        assert torch.equal(ours, theirs), path


# -- the mesh and its collectives ---------------------------------------------------


def test_make_mesh_places_ranks_and_refuses_too_few_devices():
    mesh = LM.make_mesh(2, 2, ["cpu"] * 4)
    assert mesh.shape == (2, 2) and mesh.axis_names == ("data", "model") and LM.data_axes(mesh) == ("data",)
    assert mesh.device(1, 0) == torch.device("cpu") and mesh.replica_devices(1) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match=r"needs 4 devices, 1 cpu device\(s\) visible; pass a device list"):
        LM.make_mesh(2, 2, device_type="cpu")
    assert LM.make_mesh(1, 1, device_type="cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="got 3 devices"):
        LM.make_mesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="mesh axes"):
        LM.make_mesh(0, 2, [])


def test_collectives_sum_in_rank_order_and_gather_tiled():
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 5, generator=g) * 10 ** i for i in range(4)]
    out = LM.all_reduce_sum(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(o is out[0] for o in out) and torch.equal(out[0], want)
    cat = LM.all_gather([p[:, :2] for p in parts], dim=1)
    assert torch.equal(cat, torch.cat([p[:, :2] for p in parts], dim=1))


# -- slicing and packing, leaf for leaf ------------------------------------------------


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_slice_decode_params_matches_reference(arch, mp):
    """Every rank's slice, float and int8-dict weights, equals the
    reference's; at mp 4 the attention smoke configs (2 KV heads) get 4."""
    kw = {"kv_heads": 4} if mp == 4 and arch != "mamba2-130m" else {}
    rcfg, cfg, rp, tp = _params(arch, **kw)
    ri8 = RA.quantize_params_int8(rp)
    ti8 = params_from_jax(_np(ri8))
    for rank in range(mp):
        _same(S.slice_decode_params(tp, cfg, mp, rank),
              params_from_jax(_np(RS.slice_decode_params(rp, rcfg, mp, rank))))
        if not cfg.is_moe:
            _same(S.slice_decode_params(ti8, cfg, mp, rank),
                  params_from_jax(_np(RS.slice_decode_params(ri8, rcfg, mp, rank))))
            continue
        # the reference's slice takes float experts only (indexing an int8
        # dict fails); the port slices levels and scales on the expert axis
        with pytest.raises(KeyError):
            RS.slice_decode_params(ri8, rcfg, mp, rank)
        e = cfg.n_experts // mp
        want = params_from_jax(_np(RS.slice_decode_params(
            {**ri8, "layers": {**ri8["layers"], "moe": {k: v for k, v in ri8["layers"]["moe"].items()
                                                         if k in ("router", "ln")}}}, rcfg, mp, rank)))
        want["layers"]["moe"].update({k: {n: a[:, rank * e:(rank + 1) * e] for n, a in ti8["layers"]["moe"][k].items()}
                                      for k in ("w_up", "w_gate", "w_down")})
        _same(S.slice_decode_params(ti8, cfg, mp, rank), want)


@pytest.mark.parametrize("arch,mp", [("llama3.2-3b", 4), ("qwen3-moe-30b-a3b", 4), ("llama3.2-3b", 3),
                                     ("mamba2-130m", 3), ("qwen3-moe-30b-a3b", 8)])
def test_tp_check_errors_match_reference(arch, mp):
    rcfg, cfg, rp, tp = _params(arch)
    with pytest.raises(ValueError) as theirs:
        RS.slice_decode_params(rp, rcfg, mp, 0)
    with pytest.raises(ValueError) as ours:
        S.slice_decode_params(tp, cfg, mp, 0)
    assert str(ours.value) == str(theirs.value)


def test_slice_refuses_packed_weights_and_other_families():
    rcfg, cfg, rp, tp = _params("llama3.2-3b")
    packed = A.quantize_params_packed(tp, w_bits=4, a_bits=4, device="cpu")
    with pytest.raises(ValueError, match="needs unpacked weights"):
        S.slice_decode_params(packed, cfg, 2, 0)
    with pytest.raises(NotImplementedError, match="attn/ssm families, not 'encdec'"):
        S.slice_decode_params(tp, dataclasses.replace(cfg, family="encdec"), 2, 0)


@pytest.mark.parametrize("bits", [(4, 4), (4, 8)], ids=["w4a4", "w4a8"])
@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_packed_shards_equal_reference(arch, bits):
    """``_packed_shards``: sliced, then packed against the global
    normalizers; the words and scales of every rank equal the reference's
    (carried across unstacked, ``bridge.shards_from_jax``)."""
    rcfg, cfg, rp, tp = _params(arch)
    theirs = shards_from_jax(_np(RA._packed_shards(rp, rcfg, 2, w_bits=bits[0], a_bits=bits[1])), 2)
    ours = A._packed_shards(tp, cfg, 2, w_bits=bits[0], a_bits=bits[1], device="cpu")
    assert len(ours) == 2
    for o, t in zip(ours, theirs):
        _same(o, t)
    restacked = S.unstack_decode_shards(S.stack_decode_shards(ours), 2)
    for o, t in zip(restacked, theirs):
        _same(o, t)


@pytest.mark.parametrize("bits", [(4, 4), (4, 8)], ids=["packed-words", "plain-levels"])
def test_shard_prepack_is_a_slice_of_the_global_prepack(bits):
    """A shard packed against the global tanh normalizer equals a column
    slice of the global prepack: words, scales and outputs
    (``tests/multidevice_checks.py check_prepack_shard_equality``)."""
    w_bits, a_bits = bits
    pack = choose_config(w_bits, a_bits)
    n_seg = pack.n_seg if pack is not None else 1
    K, Nl, mp = 32, 4 * n_seg, 2
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(K, mp * Nl)) * 0.4).astype(np.float32))
    x = torch.from_numpy(rng.uniform(size=(3, K)).astype(np.float32))
    full = prepack_dense(w, w_bits=w_bits, a_bits=a_bits, device="cpu")
    full_out = packed_dense(x, full)
    t_max = weight_tanh_max(w)
    words = Nl // n_seg
    for r in range(mp):
        shard = prepack_dense(w[:, r * Nl:(r + 1) * Nl], w_bits=w_bits, a_bits=a_bits, t_max=t_max, device="cpu")
        assert (shard.w_scale, shard.w_zero) == (full.w_scale, full.w_zero)
        assert torch.equal(shard.data, full.data[:, r * words:(r + 1) * words])
        assert torch.equal(packed_dense(x, shard), full_out[:, r * Nl:(r + 1) * Nl])


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "uniform"])
def test_apply_plan_tp_matches_reference(mixed):
    """``apply_plan(tp=(2, r))``: each rank's layers and head (a vocab
    slice packed at the whole embedding's normalizer) equal the reference's."""
    rcfg, cfg, rp, tp = _params("llama3.2-3b", n_layers=3)
    bits = [(8, 8), (5, 4), (3, 2)] if mixed else [(4, 4)] * 3
    rplan = RP.plan_from_bits(rcfg, arch="llama3.2-3b", bits=bits, head_bits=(4, 4))
    plan = P.DeployPlan.from_payload(rplan.to_payload())
    for rank in range(2):
        rparams, rhead = RP.apply_plan(rp, rcfg, rplan, verbose=False, tp=(2, rank))
        params, head = P.apply_plan(tp, cfg, plan, verbose=False, tp=(2, rank), device="cpu")
        _same(params, params_from_jax(_np(rparams)))
        _same(head, packed_from_jax(_np(rhead)))


# -- the tensor-parallel step against the reference's under vmap -----------------------


def _ref_tp_step(rcfg, mp, stacked, heads, state, table, tokens, pos, lens):
    """The reference's ``forward_decode_paged`` with ``axis_name="model"``,
    every rank at once under ``jax.vmap`` (the model axis named)."""
    lcfg = dataclasses.replace(rcfg, tp_shards=mp)

    def one(p, h, st):
        return RT.forward_decode_paged(p, lcfg, st, table, tokens, pos, head=h, lens=lens, axis_name="model")

    return jax.vmap(one, in_axes=(0, None if heads is None else 0, 0), axis_name="model")(stacked, heads, state)


STEP_BATCH = dict(
    lens=np.array([0, 1, 3, 4], np.int32), pos=np.array([0, 9, 6, 5], np.int32),
    table=np.array([[0, 0, 0, 0], [3, 7, 1, 5], [2, 6, 0, 0], [4, 8, 0, 0]], np.int32))


@pytest.mark.parametrize("packed", [False, True], ids=["float", "w4a4"])
@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_forward_decode_paged_tp_matches_reference_ranks(arch, packed):
    """Three steps of :func:`forward_decode_paged_tp` (chunks of 4 lanes:
    an inactive slot, a decoding one, partial and full chunks) on 2 ranks
    against the reference's vmapped mesh step: logits within ``ATOL`` and
    every rank's state (its KV groups or SSM heads) too."""
    rcfg, cfg, rp, tp = _params(arch)
    mp, C = 2, 4
    if packed:
        rshards = RA._packed_shards(rp, rcfg, mp, w_bits=4, a_bits=4)
        emb = rp["embed"]
        vs = emb.shape[0] // mp
        rheads = RS.stack_decode_shards([ref_prepack_lm_head(emb[r * vs:(r + 1) * vs], w_bits=4, a_bits=4,
                                                             t_max=ref_weight_tanh_max(emb)) for r in range(mp)])
        heads = shards_from_jax(_np(rheads), mp)
    else:
        rshards = RS.stack_decode_shards([RS.slice_decode_params(rp, rcfg, mp, r) for r in range(mp)])
        rheads, heads = None, None
    shards = [T.unstack_layers(sh, cfg.n_layers) for sh in shards_from_jax(_np(rshards), mp)]
    lcfg, rlcfg = dataclasses.replace(cfg, tp_shards=mp), dataclasses.replace(rcfg, tp_shards=mp)
    rstate = jax.tree.map(lambda a: jnp.stack([a] * mp), RT.init_paged_state(rlcfg, 4, 9, 8, dtype=jnp.float32))
    states = [T.init_paged_state(lcfg, 4, 9, 8, dtype=torch.float32, device="cpu") for _ in range(mp)]
    rng = np.random.default_rng(3)
    for step in range(3):
        tokens = rng.integers(1, cfg.vocab, (4, C)).astype(np.int32)
        b = {k: v + (step * STEP_BATCH["lens"] if k == "pos" else 0) for k, v in STEP_BATCH.items()}
        rlogits, rstate = _ref_tp_step(rcfg, mp, rshards, rheads, rstate, jnp.asarray(b["table"]),
                                       jnp.asarray(tokens), jnp.asarray(b["pos"]), jnp.asarray(b["lens"]))
        logits, _ = T.forward_decode_paged_tp(
            shards, lcfg, states, torch.from_numpy(b["table"]), torch.from_numpy(tokens),
            torch.from_numpy(b["pos"]), heads=heads, lens=torch.from_numpy(b["lens"]))
        live = b["lens"] > 0  # an inactive slot's row is never sampled
        np.testing.assert_allclose(logits.numpy()[live], np.asarray(rlogits[0])[live], rtol=0, atol=ATOL)
        for r in range(mp):
            for key, pool in states[r].items():
                theirs = np.asarray(rstate[key][r])
                ours = pool.numpy()
                if cfg.family == "attn":  # null page 0 takes the invalid lanes' writes
                    theirs, ours = theirs[:, 1:], ours[:, 1:]
                np.testing.assert_allclose(ours, theirs, rtol=0, atol=ATOL, err_msg=f"{key} rank {r} step {step}")


def test_expert_sharded_moe_matches_reference_and_dense_oracle():
    """The decode-path MoE over 2 and 4 ranks: every rank routes every
    token and runs its local experts; the ranks' shares, summed, equal the
    reference's vmapped ``_local_moe_expert_sharded`` (its psum) within
    ``ATOL`` and the dense oracle within ``MOE_TOL``
    (``tests/multidevice_checks.py check_moe_decode_psum``)."""
    rs = RX.MoESpec(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=8.0)
    s = X.MoESpec(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=8.0)
    rp = RX.moe_init(jax.random.PRNGKey(0), rs)
    tp = params_from_jax(_np(rp))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 1, 16)) * 0.5)
    want = np.asarray(RX.moe_reference(rp, rs, jnp.asarray(x)))
    for mp in (2, 4):
        e_loc = 8 // mp

        def local(p, r):
            return {k: (v[r * e_loc:(r + 1) * e_loc] if k in ("w_up", "w_gate", "w_down") else v) for k, v in p.items()}

        stacked = jax.tree.map(lambda *a: jnp.stack(a), *[local(rp, r) for r in range(mp)])
        theirs = jax.vmap(lambda p: RX._local_moe_expert_sharded(p, rs, jnp.asarray(x[:, 0]), axis_name="model"),
                          axis_name="model")(stacked)
        parts = [X._local_moe_expert_sharded(local(tp, r), s, torch.from_numpy(x[:, 0]), rank=r, mp=mp)
                 for r in range(mp)]
        got = LM.all_reduce_sum(parts)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs[0]), rtol=0, atol=ATOL)
        np.testing.assert_allclose((torch.from_numpy(x) + got[:, None]).numpy(), want, rtol=MOE_TOL, atol=MOE_TOL)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_expert_sharded_moe_drops_copies_as_the_reference(cf):
    """At capacities that drop copies (and clip onto shared bucket rows),
    every rank's share equals the reference's per-rank computation (vmapped
    without the reduction: its psum is the identity on one rank each)."""
    rs = RX.MoESpec(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=cf)
    s = X.MoESpec(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=cf)
    rp = RX.moe_init(jax.random.PRNGKey(2), rs)
    tp = params_from_jax(_np(rp))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (12, 16)))
    mp = 2
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *[
        {k: (v[r * 4:(r + 1) * 4] if k in ("w_up", "w_gate", "w_down") else v) for k, v in rp.items()}
        for r in range(mp)])
    # each rank's share alone: the reduction over the named axis of one rank a group
    theirs = jax.vmap(lambda p: RX._local_moe_expert_sharded(p, rs, jnp.asarray(x), axis_name="model"),
                      axis_name="model")(stacked)
    parts = [X._local_moe_expert_sharded({k: (v[r * 4:(r + 1) * 4] if k in ("w_up", "w_gate", "w_down") else v)
                                          for k, v in tp.items()}, s, torch.from_numpy(x), rank=r, mp=mp)
             for r in range(mp)]
    np.testing.assert_allclose(LM.all_reduce_sum(parts)[0].numpy(), np.asarray(theirs[0]), rtol=0, atol=ATOL)


# -- MeshConfig and the refusals -----------------------------------------------------


@pytest.mark.parametrize("spec", [None, "2", "2x4", "1x2", (3, 2), [1, 1]])
def test_mesh_config_parse_matches_reference(spec):
    ours, theirs = MeshConfig.parse(spec), RefMeshConfig.parse(spec)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.n_devices, ours.enabled) == (theirs.n_devices, theirs.enabled)
    same = MeshConfig(dp=2, mp=2)
    assert MeshConfig.parse(same) is same


@pytest.mark.parametrize("bad", [lambda M: M(dp=0), lambda M: M.parse("2x2x2"), lambda M: M(mp=-1)])
def test_mesh_config_errors_match_reference(bad):
    with pytest.raises(ValueError) as theirs:
        bad(RefMeshConfig)
    with pytest.raises(ValueError) as ours:
        bad(MeshConfig)
    assert str(ours.value) == str(theirs.value)


def test_mp_refuses_int8_kv_and_attribution_as_the_reference():
    rcfg, cfg, rp, tp = _params("llama3.2-3b")
    rkv8, kv8 = dataclasses.replace(rcfg, kv_dtype="int8"), dataclasses.replace(cfg, kv_dtype="int8")
    with pytest.raises(NotImplementedError) as theirs:
        ref_build_engine(rkv8, RefEngineConfig(mesh=RefMeshConfig(mp=2)), params=rp)
    with pytest.raises(NotImplementedError) as ours:
        build_engine(kv8, EngineConfig(mesh=MeshConfig(mp=2)), params=tp, device="cpu", devices=["cpu"] * 2)
    assert str(ours.value) == str(theirs.value)
    from repro.serving import ObsConfig as RefObsConfig
    from repro_torch.serving import ObsConfig

    with pytest.raises(ValueError) as theirs:
        ref_build_engine(rcfg, RefEngineConfig(obs=RefObsConfig(attrib_every=4), mesh=RefMeshConfig(2, 2)),
                         params=rp)
    with pytest.raises(ValueError) as ours:
        build_engine(cfg, EngineConfig(obs=ObsConfig(attrib_every=4), mesh=MeshConfig(2, 2)), params=tp,
                     device="cpu", devices=["cpu"] * 4)
    assert str(ours.value) == str(theirs.value)


def test_a_mesh_needs_devices_or_a_device_list():
    """More ranks than visible devices raise unless a device list places
    them; a dp-only mesh runs every replica on the engine's device."""
    rcfg, cfg, rp, tp = _params("llama3.2-3b")
    with pytest.raises(ValueError, match="needs 2 devices"):
        build_engine(cfg, EngineConfig(mesh=MeshConfig(mp=2)), params=tp, device="cpu")
    eng = build_engine(cfg, EngineConfig(mesh=MeshConfig(dp=3)), params=tp, device="cpu")
    assert eng.mesh.devices == (torch.device("cpu"),) * 3 and len(eng.replicas) == 3
    eng = build_engine(cfg, EngineConfig(mesh=MeshConfig(2, 2)), params=tp, device="cpu", devices=["cpu"] * 4)
    assert eng.mesh.shape == (2, 2) and all(len(rep.state) == 2 for rep in eng.replicas)


# -- data-parallel replicas -----------------------------------------------------------


def _replica_recording(eng) -> dict:
    """Every sampled row of a reference engine with replicas, keyed by
    (request id, token index): its step is wrapped (one call a replica, or
    one ``[dp, S, V]`` call on a mesh)."""
    rec, calls = {}, []
    inner, once = eng._step, eng._step_once

    def step(*args):
        out = inner(*args)
        calls.append(np.asarray(out[0], np.float32))
        return out

    def step_once(now_fn):
        calls.clear()
        before = {(rep.index, s): (r, len(r.out_tokens)) for rep in eng.replicas
                  for s, r in rep.scheduler.active.items()}
        out = once(now_fn)
        for (i, s), (r, t) in before.items():
            if len(r.out_tokens) > t:
                rows = calls[-1][i] if eng.mp > 1 else calls[i - eng.dp]
                rec[(r.rid, t)] = rows[s]
        return out

    eng._step, eng._step_once = step, step_once
    return rec


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-130m"])
def test_dp2_replicas_token_identical_to_single_and_reference(arch):
    """dp 2 at bfloat16: every replica steps the single engine's program on
    its own state, so each request's rows and tokens equal the single
    engine's bit for bit; the tokens, the replicas the requests went to
    and the steps equal the reference's dp 2 engine
    (``tests/test_serving.py test_dp2_replicas_token_identical_to_single``)."""
    rcfg, cfg, rp, tp = _params(arch, float32=False)
    prompts = _prompts(jax.random.PRNGKey(13), 4, [5, 7, 4, 6], cfg.vocab)
    kw = dict(n_slots=2, page_size=4, max_len=32, chunk_tokens=2)

    def run(mesh, ref=False):
        if ref:
            eng = ref_build_engine(rcfg, RefEngineConfig(**kw, mesh=RefMeshConfig(*mesh)), params=rp)
            rec = _replica_recording(eng)
        else:
            eng = build_engine(cfg, EngineConfig(**kw, mesh=MeshConfig(*mesh)), params=tp, device="cpu")
            rec = {}
            eng.on_sample = lambda rid, t, row: rec.__setitem__((rid, t), row.copy())
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        m = eng.run(realtime=False)
        eng.assert_no_leaks()
        return m, [r.out_tokens for r in reqs], [r.replica for r in reqs], rec

    m1, toks1, _, rec1 = run((1, 1))
    m2, toks2, reps2, rec2 = run((2, 1))
    rm2, rtoks2, rreps2, _ = run((2, 1), ref=True)
    assert (m1["dp"], m2["dp"], m2["mp"], m2["n_ok"]) == (1, 2, 1, 4)
    assert toks2 == toks1 and sorted(rec2) == sorted(rec1)
    assert all(rec2[k].tobytes() == rec1[k].tobytes() for k in rec1)
    assert toks2 == rtoks2 and reps2 == rreps2 == [0, 1, 0, 1]
    for key in ("steps", "fed_tokens", "preemptions", "dp", "mp", "slot_occupancy"):
        assert m2[key] == rm2[key], key


def test_dp2_broken_replica_quarantined_and_rerouted_as_the_reference():
    """A replica whose page allocator always fails is quarantined whole
    after ``watchdog_ticks`` stalled ticks and its queue re-routed; every
    request ends ``ok`` on the live replica, decisions as the reference's
    (``tests/test_serving.py test_dp2_broken_replica_quarantined_and_rerouted``)."""
    rcfg, cfg, rp, tp = _params("llama3.2-3b", float32=False)
    prompts = _prompts(jax.random.PRNGKey(8), 4, [3, 4, 3, 4], cfg.vocab)
    kw = dict(n_slots=2, page_size=4, max_len=16, watchdog_ticks=3)
    out = []
    for eng in (ref_build_engine(rcfg, RefEngineConfig(**kw, mesh=RefMeshConfig(dp=2)), params=rp),
                build_engine(cfg, EngineConfig(**kw, mesh=MeshConfig(dp=2)), params=tp, device="cpu")):
        eng.replicas[1].allocator.alloc = lambda n: None  # replica 1 wedged
        reqs = [eng.submit(p, max_new_tokens=3) for p in prompts]
        m = eng.run(realtime=False)
        assert m["replica_quarantines"] >= 1 and all(r.status == "ok" for r in reqs)
        assert {r.replica for r in reqs} == {0}
        eng.assert_no_leaks()
        assert eng.replicas[1].scheduler.all_done()
        out.append((m["replica_quarantines"], m["steps"], m["statuses"], eng.ticks,
                    [(r.out_tokens, r.t_admit, r.t_finish) for r in reqs]))
    assert out[0] == out[1]


def test_replica_leak_names_the_replica():
    rcfg, cfg, rp, tp = _params("llama3.2-3b", float32=False)
    eng = build_engine(cfg, EngineConfig(n_slots=2, page_size=4, max_len=16, mesh=MeshConfig(dp=2)), params=tp,
                       device="cpu")
    eng.replicas[1].allocator.alloc(1)
    with pytest.raises(AssertionError, match="replica 1"):
        eng.assert_no_leaks()


# -- tensor parallelism in the engine ----------------------------------------------------

# the forced-preemption workload of tests/multidevice_checks.py _serve_tokens
SERVE_KW = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand")
CHAOS = dict(seed=3, step_fault_rate=0.1, alloc_fault_rate=0.1, nan_rate=0.05)


def _serve(eng, vocab: int):
    rng = np.random.default_rng(17)
    for ln in (9, 6, 11, 9, 6, 11):
        eng.submit(rng.integers(1, vocab, size=ln).tolist(), 6, arrival=0.0)
    m = eng.run(realtime=False)
    eng.assert_no_leaks()  # every replica's pool and slots
    assert m["n_ok"] == 6, m["statuses"]
    return {r.rid: r.out_tokens for r in eng.finished}, m


@functools.lru_cache(maxsize=None)
def _ref_single(arch: str):
    """The reference's single engine on the workload, clean, at float32."""
    rcfg, cfg, rp, tp = _params(arch)
    return _serve(ref_build_engine(rcfg, RefEngineConfig(**SERVE_KW), params=rp), cfg.vocab)


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "chaos"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-130m"])
def test_mp_engine_matches_reference_under_preemption(arch, mesh, chaos):
    """mp 2 (dp 1 and 2) at float32, the undersized pool forcing
    preemption and chunked replay: the tokens equal the reference's single
    engine's, clean and under seeded chaos (step faults, allocation
    failures, NaN-poisoned rows) (``tests/multidevice_checks.py``
    ``check_mesh_serving_token_identity``, ``check_mesh_serving_under_chaos``)."""
    rcfg, cfg, rp, tp = _params(arch)
    want, m1 = _ref_single(arch)
    ecfg = EngineConfig(**SERVE_KW, mesh=MeshConfig(*mesh), chaos=ChaosConfig(**CHAOS) if chaos else ChaosConfig())
    got, m = _serve(build_engine(cfg, ecfg, params=tp, device="cpu", devices=["cpu"] * (mesh[0] * mesh[1])),
                    cfg.vocab)
    assert m1["preemptions"] > 0 and m["preemptions"] > 0
    assert (m["dp"], m["mp"]) == mesh
    if chaos:
        assert sum(m["injected"].values()) > 0
    assert got == want


@pytest.mark.parametrize("quant", [None, "int8", "packed", "plan"])
@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_build_engine_modes_on_the_mesh_match_the_single_engine(arch, quant):
    """Every weight mode under dp 2 x mp 2 (the packed head and a plan's
    head on vocab slices) against the port's single engine at float32:
    rows within ``ATOL`` (packed: the row-parallel products of a shard
    differ only by the sum order), tokens equal."""
    rcfg, cfg, rp, tp = _params(arch)
    kw = dict(n_slots=2, page_size=4, max_len=32, chunk_tokens=2, packed_head=quant == "packed", head_bits=(4, 4))
    extra = {}
    if quant == "plan":
        plan = RP.plan_from_bits(rcfg, arch=arch, bits=[(4, 4), (8, 8)], head_bits=(4, 4))
        extra = dict(plan=P.DeployPlan.from_payload(plan.to_payload()))
    elif quant is not None:
        extra = dict(quant=quant, w_bits=4, a_bits=4)
    prompts = _prompts(jax.random.PRNGKey(13), 4, [5, 7, 4, 6], cfg.vocab)
    out = []
    for mesh in ((1, 1), (2, 2)):
        eng = build_engine(cfg, EngineConfig(**kw, mesh=MeshConfig(*mesh)), params=tp, device="cpu",
                           devices=["cpu"] * (mesh[0] * mesh[1]), **extra)
        rec = {}
        eng.on_sample = lambda rid, t, row, rec=rec: rec.__setitem__((rid, t), row.copy())
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        assert eng.run(realtime=False)["n_ok"] == 4
        out.append(([r.out_tokens for r in reqs], rec))
    (toks1, rec1), (toks2, rec2) = out
    assert toks2 == toks1 and sorted(rec2) == sorted(rec1)
    for k in rec1:
        np.testing.assert_allclose(rec2[k], rec1[k], rtol=0, atol=ATOL)


def test_mesh_snapshots_restore_every_replica_and_rank():
    """A hard fault on a 2 x 2 mesh with snapshots: every rank's state of
    every replica is restored in place, and the replays give the clean
    run's tokens."""
    rcfg, cfg, rp, tp = _params("mamba2-130m")
    want, _ = _ref_single("mamba2-130m")
    ecfg = EngineConfig(**SERVE_KW, mesh=MeshConfig(2, 2), snapshot_every=2)
    eng = build_engine(cfg, ecfg, params=tp, device="cpu", devices=["cpu"] * 4)
    before = [t for rep in eng.replicas for st in rep.state for t in st.values()]
    fired = []
    inner = eng.replicas[1].program.launch

    def dying(*args):
        if eng.n_steps == 5 and not fired:
            fired.append(1)
            raise RuntimeError("planted hard fault")
        return inner(*args)

    eng.replicas[1].program.launch = dying
    got, m = _serve(eng, cfg.vocab)
    assert fired and m["hard_recoveries"] == 1 and got == want
    assert all(a is b for a, b in zip(before, [t for rep in eng.replicas for st in rep.state for t in st.values()]))


# -- the reference's own mesh engine -------------------------------------------------------

REF_MESH_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.serving import EngineConfig, MeshConfig, build_engine
import repro.serving.engine as E

assert len(jax.devices()) == 4, jax.devices()
rows = {}


class Recording:
    # numpy with an argmax that keeps every sampled row, keyed by the
    # sampling request and the index of its token
    def __getattr__(self, name):
        return getattr(np, name)

    def argmax(self, row, *a, **k):
        req = sys._getframe(1).f_locals["req"]
        rows[f"{req.rid}:{len(req.out_tokens)}"] = np.asarray(row, np.float32)
        return np.argmax(row, *a, **k)


E.np = Recording()
cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True), dtype=jnp.float32)
eng = build_engine(cfg, EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4,
                                     admit="on-demand", mesh=MeshConfig(2, 2)))
rng = np.random.default_rng(17)
for ln in (9, 6, 11, 9, 6, 11):
    eng.submit(rng.integers(1, cfg.vocab, size=ln).tolist(), 6, arrival=0.0)
m = eng.run(realtime=False)
eng.assert_no_leaks()
np.savez(sys.argv[1] + ".npz", **rows)
json.dump({"tokens": {r.rid: r.out_tokens for r in eng.finished}, "steps": m["steps"],
           "preemptions": m["preemptions"], "replicas": {r.rid: r.replica for r in eng.finished}},
          open(sys.argv[1] + ".json", "w"))
"""


def test_dp2_mp2_matches_the_reference_mesh_engine(tmp_path):
    """The reference's own dp 2 x mp 2 engine (``shard_map`` over four
    forced host devices, in a subprocess) against the port's on the
    forced-preemption workload at float32: equal tokens, replicas, steps
    and preemptions, and every sampled row within ``ATOL``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = tmp_path / "ref_mesh"
    subprocess.run([sys.executable, "-c", REF_MESH_SCRIPT, str(out)], env=env, check=True, timeout=85,
                   capture_output=True)
    theirs = json.loads(out.with_suffix(".json").read_text())
    rows = dict(np.load(out.with_suffix(".npz")))
    rcfg, cfg, rp, tp = _params("llama3.2-3b")
    eng = build_engine(cfg, EngineConfig(**SERVE_KW, mesh=MeshConfig(2, 2)), params=tp, device="cpu",
                       devices=["cpu"] * 4)
    rec = {}
    eng.on_sample = lambda rid, t, row: rec.__setitem__(f"{rid}:{t}", row.copy())
    got, m = _serve(eng, cfg.vocab)
    assert {str(k): v for k, v in got.items()} == theirs["tokens"]
    assert {str(r.rid): r.replica for r in eng.finished} == theirs["replicas"]
    assert (m["steps"], m["preemptions"]) == (theirs["steps"], theirs["preemptions"])
    assert sorted(rec) == sorted(rows)
    for k, row in rows.items():
        np.testing.assert_allclose(rec[k], row, rtol=0, atol=ATOL, err_msg=k)


def test_port_mesh_modules_use_no_process_group():
    """The mesh is one process: no module of it reaches for
    ``torch.distributed`` or NCCL."""
    src = ROOT / "src" / "repro_torch"
    for path in [src / "launch" / "mesh.py", *sorted((src / "parallel").glob("*.py"))]:
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+torch\.distributed", text, re.M), path
        assert "nccl" not in text.lower() and "dist.init_process_group" not in text, path
