"""int8 KV pools and int8 serving weights in the port against the JAX
reference, on the CPU, at the llama3.2-3b smoke size.

Both packages run on identical float weights and packed words (the
fixture of ``tests/test_torch_model.py``, carried across by
:mod:`repro_torch.bridge`) at float32.  Tolerances:

- int8 weight levels and scales are bit-exact: both packages divide in
  IEEE arithmetic and round half to even, in the same dtypes.
- ``dense`` on an int8 dict and the engines' sampled logits rows agree to
  ``ATOL`` (float32 sum order), up to a request's first token divergence,
  which is allowed only where the reference's top-2 logit gap is under
  ``TIE_BOUND`` (``tests/test_torch_model.py``).
- KV levels may differ by one where a row's float32 value sits on a
  rounding boundary of ``quantize_kv_row``; at most ``KV_FLIP_SHARE`` of
  the levels of the live pages may, and scales agree to ``SCALE_RTOL``
  relative.  Page 0 is the null page (invalid lanes and inactive slots
  write it), and is never compared.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import _prompts
from test_torch_chunked import _check_streams
from test_torch_model import ATOL, _close, _recording, shared  # noqa: F401 (shared: fixture)

from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import build_engine as ref_build_engine
from repro.serving.api import quantize_params_int8 as ref_quantize_int8
from repro_torch.bridge import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.plan import uniform_plan
from repro_torch.serving import EngineConfig, build_engine
from repro_torch.serving.api import quantize_params_int8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU engine on one intra-op thread (at the smoke size
    thread hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

KV_FLIP_SHARE = 1e-3
SCALE_RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _int8_kv(shared):
    return (dataclasses.replace(shared["rcfg"], kv_dtype="int8"),
            dataclasses.replace(shared["cfg"], kv_dtype="int8"))


def _same_bits(ours: torch.Tensor, theirs) -> None:
    theirs = np.asarray(theirs)
    assert str(ours.dtype).split(".")[-1] == theirs.dtype.name and tuple(ours.shape) == theirs.shape
    if ours.dtype == torch.bfloat16:  # numpy has no bfloat16 of its own: compare the bits
        ours, theirs = ours.view(torch.int16), theirs.view(np.int16)
    assert ours.numpy().tobytes() == theirs.tobytes()


# -- int8 serving weights -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_int8_equals_the_reference(shared, dtype):
    """Every projection's levels and scales bit for bit, stacked ``[L, K,
    N]`` with ``[L, 1, N]`` scales, the other leaves untouched; then layer
    by layer in the per-layer list form the engine walks."""
    rp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), shared["rp"])
    ref = _np(ref_quantize_int8(rp))
    ours = quantize_params_int8(params_from_jax(_np(rp)))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    n_int8 = 0
    for path, theirs in flat_ref:
        leaf = ours
        for k in path:
            leaf = leaf[k.key]
        _same_bits(leaf, theirs)
        n_int8 += theirs.dtype == np.int8
    assert n_int8 == 7  # wq, wk, wv, wo, w_up, w_gate, w_down
    wq = ours["layers"]["attn"]["wq"]["w"]
    n_layers = shared["cfg"].n_layers
    assert wq["scale"].shape == (n_layers, 1, wq["levels"].shape[-1])
    per_layer = T.unstack_layers(ours, n_layers)["layers"]
    for i, layer in enumerate(per_layer):
        for name in ("wq", "wk", "wv", "wo"):
            w = layer["attn"][name]["w"]
            _same_bits(w["levels"], ref["layers"]["attn"][name]["w"]["levels"][i])
            _same_bits(w["scale"], ref["layers"]["attn"][name]["w"]["scale"][i])
        for name in ("w_up", "w_gate", "w_down"):
            w = layer["mlp"][name]["w"]
            _same_bits(w["levels"], ref["layers"]["mlp"][name]["w"]["levels"][i])
            _same_bits(w["scale"], ref["layers"]["mlp"][name]["w"]["scale"][i])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_dense_for_serving_equals_the_reference(shared, bits):
    w = np.asarray(shared["rp"]["layers"]["mlp"]["w_down"]["w"][1])
    ref = _np(RL.quantize_dense_for_serving({"w": jnp.asarray(w)}, bits=bits))
    ours = L.quantize_dense_for_serving({"w": torch.from_numpy(w.copy())}, bits=bits)
    _same_bits(ours["w"]["levels"], ref["w"]["levels"])
    _same_bits(ours["w"]["scale"], ref["w"]["scale"])


@pytest.mark.parametrize("lead", [(3,), (2, 3)], ids=["rows", "slots-lanes"])
def test_dense_on_int8_weights_matches_the_reference(shared, lead):
    rw = ref_quantize_int8(shared["rp"])["layers"]["attn"]["wo"]["w"]
    rw = jax.tree.map(lambda a: a[0], rw)
    tw = T.layer_params(quantize_params_int8(shared["tp"])["layers"], 0)["attn"]["wo"]["w"]
    x = np.random.default_rng(11).normal(size=lead + (rw["levels"].shape[0],)).astype(np.float32)
    _close(L.dense({"w": tw}, torch.from_numpy(x)), RL.dense({"w": rw}, jnp.asarray(x)))


def test_int8_weights_and_a_plan_stay_exclusive(shared):
    plan = uniform_plan(shared["cfg"], arch="llama3.2-3b", w_bits=4, a_bits=4, smoke=True)
    with pytest.raises(ValueError, match="plan= or quant="):
        build_engine(shared["cfg"], EngineConfig(), params=shared["tp"], plan=plan, quant="int8",
                     device="cpu")


# -- int8 KV pools ------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["int8", "int8-dtype", "float32", None])
def test_init_paged_state_kv_dtype_override(shared, kv_dtype):
    """The override takes "int8", the int8 dtype or a float dtype, as the
    reference's does (``None``: the config's bf16 pools)."""
    ref_kv = {"int8": "int8", "int8-dtype": jnp.int8, "float32": jnp.float32, None: None}[kv_dtype]
    our_kv = {"int8": "int8", "int8-dtype": torch.int8, "float32": torch.float32, None: None}[kv_dtype]
    ref = RT.init_paged_state(shared["rcfg"], 3, 7, 4, dtype=jnp.bfloat16, kv_dtype=ref_kv)
    ours = T.init_paged_state(shared["cfg"], 3, 7, 4, dtype=torch.bfloat16, kv_dtype=our_kv,
                              device="cpu")
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape and str(ours[k].dtype).split(".")[-1] == v.dtype.name
        assert not ours[k].any()


def _check_pools(reng, peng) -> None:
    """The engines' final pools on the live pages: levels within one, on at
    most KV_FLIP_SHARE of them; scales to SCALE_RTOL."""
    for name in ("k", "v"):
        ours = peng.state[name][:, 1:].numpy().astype(np.int32)
        theirs = np.asarray(reng.state[name])[:, 1:].astype(np.int32)
        diff = np.abs(ours - theirs)
        assert diff.max() <= 1, name
        assert np.count_nonzero(diff) <= KV_FLIP_SHARE * diff.size, (name, np.count_nonzero(diff))
        np.testing.assert_allclose(peng.state[f"{name}_scale"][:, 1:].numpy(),
                                   np.asarray(reng.state[f"{name}_scale"])[:, 1:], rtol=SCALE_RTOL, atol=0)
    assert peng.state["k"].dtype == torch.int8 and peng.state["k_scale"].dtype == torch.float32


def _run_both(shared, kw, prompts, max_new, *, packed=False, packed_head=False, quant=None,
              kv_int8=True):
    """The reference's and the port's engine on the same weights, prompts
    and settings; returns both metrics, both engines and their sampled
    rows."""
    rcfg, cfg = _int8_kv(shared) if kv_int8 else (shared["rcfg"], shared["cfg"])
    rp, tp = (shared["rpk"], shared["tpk"]) if packed else (shared["rp"], shared["tp"])
    head_kw = dict(packed_head=packed_head, head_bits=(4, 4))
    reng = ref_build_engine(rcfg, RefEngineConfig(**kw, **head_kw), params=rp, quant=quant,
                            head=shared["rhead"] if packed_head else None)
    peng = build_engine(cfg, EngineConfig(**kw, **head_kw), params=tp, quant=quant, device="cpu",
                        head=shared["thead"] if packed_head else None)
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    ms = []
    for eng in (reng, peng):
        for p in prompts:
            eng.submit(p, max_new)
        ms.append(eng.run(realtime=False))
    rm, m = ms
    assert m["statuses"] == {"ok": len(prompts)}
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m[key] == rm[key], key
    _check_streams(reng, peng, rrec, prec)
    return rm, m, reng, peng


def _smoke_prompts(shared):
    rng = np.random.default_rng(0)
    return [rng.integers(1, shared["cfg"].vocab, int(rng.integers(3, 13))).tolist() for _ in range(6)]


@pytest.mark.parametrize("packed_head", [True, False], ids=["packed-head", "float-head"])
@pytest.mark.parametrize("gather", ["xla", "kernel"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_int8_kv_engine_matches_reference(shared, chunk, gather, packed_head):
    """w4a4 packed projections on int8 pools, reserve admission: 6 requests
    through 4 slots, one token a step or chunks of 4."""
    kw = dict(n_slots=4, page_size=8, max_len=64, chunk_tokens=chunk, gather_backend=gather)
    _, m, reng, peng = _run_both(shared, kw, _smoke_prompts(shared), 8, packed=True,
                                 packed_head=packed_head)
    assert m["preemptions"] == 0
    _check_pools(reng, peng)


@pytest.mark.parametrize("gather", ["xla", "kernel"])
def test_int8_kv_forced_preemption_matches_reference(shared, gather):
    """The reference's forced-preemption fixture (tests/test_torch_chunked.py
    test_forced_preemption_matches_reference) on int8 pools: a replayed
    request rewrites its levels and scales."""
    kw = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand",
              gather_backend=gather)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], shared["cfg"].vocab)
    _, m, reng, peng = _run_both(shared, kw, prompts, 6)
    assert m["preemptions"] > 0, "undersized pool must force preemption"
    _check_pools(reng, peng)
    peng.assert_no_leaks()


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16-config-pools", "int8-pools"])
def test_int8_weights_engine_matches_reference(shared, kv_int8):
    """``build_engine(quant="int8")`` from the same float weights, chunks of
    4 and the kernel gather, with the config's pools or int8 pools."""
    kw = dict(n_slots=4, page_size=8, max_len=64, chunk_tokens=4, gather_backend="kernel")
    _, _, reng, peng = _run_both(shared, kw, _smoke_prompts(shared), 8, quant="int8", kv_int8=kv_int8)
    w = peng.params["layers"][0]["mlp"]["w_down"]["w"]
    assert w["levels"].dtype == torch.int8 and w["scale"].dtype == torch.float32
    if kv_int8:
        _check_pools(reng, peng)
