"""The port's fixed-batch decode (``init_cache``, ``forward_decode``,
``encode_for_decode``, ``attention_decode``, ``attention_train``,
``cross_attention``, ``mlp``) against the reference's, on the CPU, at the
smoke sizes: the whisper-tiny (encdec) and zamba2-1.2b (hybrid) families,
and the attn and ssm families the paged engine also serves.

Both packages run on identical weights and packed words: the reference's
``init_params(PRNGKey(0))`` tree (and its prepacked projections, int8
levels and packed LM head) cross over through :mod:`repro_torch.bridge`.
Configs run at float32, and the decode caches too where a test makes them
(the serve CLI's bfloat16 caches are held in ``tests/test_torch_serve_cli.py``).

Tolerance: rows and cache entries agree to ``ATOL`` (float32 rounding:
RoPE's cos/sin and the sum orders of XLA and PyTorch differ in the last
bits), and every step's argmax is equal, each step fed the reference's
greedy token.  int8 cache levels are equal; the packed path's activation
levels flip on none of these seeds (a flip would show as an error of one
level step, about 0.01 to 0.1, see ``tests/test_torch_model.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as RP
from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serving.api import quantize_params_int8 as ref_quantize_int8
from repro.serving.api import quantize_params_packed as ref_quantize_packed
from repro_torch import plan as P
from repro_torch.bridge import packed_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, build_engine
from repro_torch.serving.api import quantize_params_packed

ATOL = 1e-4
B, MAX_LEN, ENC_LEN, STEPS = 2, 16, 5, 6
DECODE_ARCHS = ("llama3.2-3b", "gemma3-1b", "qwen2-vl-7b", "qwen3-moe-30b-a3b", "mamba2-130m", "whisper-tiny",
                "zamba2-1.2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (at the smoke size thread hand-offs cost more
    than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch: str, **fields):
    """Both configs at float32, ``fields`` replaced on both."""
    return (dataclasses.replace(ref_get_config(arch, smoke=True), dtype=jnp.float32, **fields),
            dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32, **fields))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    """The reference's ``init_params(PRNGKey(0))`` and their port twin."""
    rp = RT.init_params(jax.random.PRNGKey(0), _cfgs(arch)[0])
    return rp, params_from_jax(_np(rp))


def _model(arch: str, **fields):
    return (*_cfgs(arch, **fields), *_params(arch))


def _close(ours: torch.Tensor, theirs, what="") -> None:
    np.testing.assert_allclose(ours.to(torch.float32).numpy(), np.asarray(theirs, np.float32), rtol=0,
                               atol=ATOL, err_msg=what)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- layers ----------------------------------------------------------------------------------


ATTN_DECODE_CASES = {
    # case: (arch, cache dtype, window, pos)
    "bf16-cache": ("llama3.2-3b", "bfloat16", 0, 5),
    "float-cache": ("llama3.2-3b", "float32", 0, 9),
    "int8-cache": ("llama3.2-3b", "int8", 0, 7),
    "window": ("gemma3-1b", "float32", 4, 11),
    "mrope": ("qwen2-vl-7b", "float32", 0, 12),
    "past-max-len": ("llama3.2-3b", "float32", 0, MAX_LEN + 4),
    "past-max-len-window": ("gemma3-1b", "int8", 3, MAX_LEN + 2),
}


@pytest.mark.parametrize("case", list(ATTN_DECODE_CASES))
def test_attention_decode_matches_reference(case):
    """One token against a flat cache holding random earlier rows: the
    output and the updated cache (int8: levels equal, scales to ATOL).
    Past ``max_len`` the reference's ``dynamic_update_slice`` clamps the row
    to ``T - 1`` and nothing is masked but the window; the port does too."""
    arch, kind, window, pos = ATTN_DECODE_CASES[case]
    rcfg, cfg, rp, tp = _model(arch)
    p_ref = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    p = T.layer_params(tp["layers"], 0)["attn"]
    rng = np.random.default_rng(len(case))
    D = cfg.kv_heads * cfg.hd
    x = _rand(rng, B, 1, cfg.d_model)
    if kind == "int8":
        ck = rng.integers(-127, 128, (B, MAX_LEN, D)).astype(np.int8)
        cv = rng.integers(-127, 128, (B, MAX_LEN, D)).astype(np.int8)
        ks, vs = (np.abs(_rand(rng, B, MAX_LEN, 1, scale=0.01)) for _ in range(2))
        theirs = RL.attention_decode(p_ref, rcfg.attn_spec(), jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(pos, jnp.int32), window=window, cache_k_scale=jnp.asarray(ks),
                                     cache_v_scale=jnp.asarray(vs))
        ours_c = [torch.from_numpy(a.copy()) for a in (ck, cv, ks, vs)]
        out = L.attention_decode(p, cfg.attn_spec(), torch.from_numpy(x), ours_c[0], ours_c[1],
                                 torch.tensor(pos, dtype=torch.int32), window=window, cache_k_scale=ours_c[2],
                                 cache_v_scale=ours_c[3])
        for a, b in zip(ours_c[:2], theirs[1:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(ours_c[2:], theirs[3:]):
            _close(a, b)
    else:
        jdt, tdt = getattr(jnp, kind), getattr(torch, kind)
        ck, cv = _rand(rng, B, MAX_LEN, D), _rand(rng, B, MAX_LEN, D)
        theirs = RL.attention_decode(p_ref, rcfg.attn_spec(), jnp.asarray(x), jnp.asarray(ck, jdt),
                                     jnp.asarray(cv, jdt), jnp.asarray(pos, jnp.int32), window=window)
        ours_c = [torch.from_numpy(a).to(tdt) for a in (ck, cv)]
        out = L.attention_decode(p, cfg.attn_spec(), torch.from_numpy(x), ours_c[0], ours_c[1],
                                 torch.tensor(pos, dtype=torch.int32), window=window)
        for a, b in zip(ours_c, theirs[1:]):
            assert a.dtype == tdt
            _close(a, b)
    _close(out, theirs[0])
    if case.startswith("past-max-len"):  # the clamped write landed on the last row
        assert not np.array_equal(np.asarray(theirs[1])[:, -1], ck[:, -1])


@pytest.mark.parametrize("window,q_chunk", [(-1, 64), (0, 64), (3, 64), (-1, 4), (0, 4), (3, 4)],
                         ids=["bidirectional", "causal", "window", "bidirectional-chunked", "causal-chunked",
                              "window-chunked"])
def test_attention_train_matches_reference(window, q_chunk):
    """Full-sequence attention at windows -1, 0 and 3, in one query block
    and split into ``S / q_chunk`` blocks (GQA, so ``_repeat_kv`` repeats)."""
    rcfg, cfg, rp, tp = _model("llama3.2-3b")
    S = 8
    rspec = dataclasses.replace(rcfg.attn_spec(), q_chunk=q_chunk)
    spec = dataclasses.replace(cfg.attn_spec(), q_chunk=q_chunk)
    assert spec.kv_heads < spec.n_heads
    x = _rand(np.random.default_rng(window + 7), B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    theirs = RL.attention_train(jax.tree.map(lambda a: a[1], rp["layers"]["attn"]), rspec, jnp.asarray(x),
                                jnp.asarray(pos), window=window)
    ours = L.attention_train(T.layer_params(tp["layers"], 1)["attn"], spec, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), window=window)
    _close(ours, theirs)


def test_attention_train_mrope_matches_reference():
    """M-RoPE in the full-sequence attention at distinct (t, h, w) streams."""
    rcfg, cfg, rp, tp = _model("qwen2-vl-7b")
    S = 6
    pos = np.stack([np.arange(S), np.arange(S) // 2, np.arange(S) % 3], -1).astype(np.int32)
    pos = np.broadcast_to(pos[None], (B, S, 3))
    x = _rand(np.random.default_rng(3), B, S, cfg.d_model)
    theirs = RL.attention_train(jax.tree.map(lambda a: a[0], rp["layers"]["attn"]), rcfg.attn_spec(),
                                jnp.asarray(x), jnp.asarray(pos), window=0)
    ours = L.attention_train(T.layer_params(tp["layers"], 0)["attn"], cfg.attn_spec(), torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), window=0)
    _close(ours, theirs)


def test_cross_attention_matches_reference():
    rcfg, cfg, rp, tp = _model("whisper-tiny")
    rng = np.random.default_rng(4)
    x = _rand(rng, B, 1, cfg.d_model)
    ek, ev = (_rand(rng, B, ENC_LEN, cfg.kv_heads, cfg.hd) for _ in range(2))
    theirs = RL.cross_attention(jax.tree.map(lambda a: a[1], rp["xattn_layers"]["xattn"]), rcfg.attn_spec(),
                                jnp.asarray(x), (jnp.asarray(ek), jnp.asarray(ev)))
    ours = L.cross_attention(T.layer_params(tp["xattn_layers"], 1)["xattn"], cfg.attn_spec(),
                             torch.from_numpy(x), (torch.from_numpy(ek), torch.from_numpy(ev)))
    _close(ours, theirs)


@pytest.mark.parametrize("arch,kind", [("whisper-tiny", "gelu"), ("nemotron-4-340b", "squared_relu")])
def test_mlp_matches_reference(arch, kind):
    """``mlp``'s gelu branch (whisper-tiny's, jax.nn.gelu's tanh form) and
    squared_relu branch (nemotron-4-340b's) at their smoke configs."""
    rcfg, cfg, rp, tp = _model(arch)
    assert cfg.mlp_kind == kind and "w_gate" not in tp["layers"]["mlp"]
    x = _rand(np.random.default_rng(5), B, 3, cfg.d_model)
    theirs = RL.mlp(jax.tree.map(lambda a: a[0], rp["layers"]["mlp"]), rcfg.mlp_spec(), jnp.asarray(x))
    ours = L.mlp(T.layer_params(tp["layers"], 0)["mlp"], cfg.mlp_spec(), torch.from_numpy(x))
    _close(ours, theirs)


# -- params, caches and the encoder --------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-tiny", "zamba2-1.2b"])
def test_params_have_the_reference_layout(arch):
    """``init_params``: key for key and shape for shape the reference's
    (encdec: ``enc_layers`` and ``xattn_layers`` stacked; hybrid: one
    unstacked ``shared_attn``), at the reference's scales; the bridge
    carries both trees (their packed words:
    ``tests/test_torch_static_quant.py``)."""
    rcfg, cfg, rp, tp = _model(arch)
    flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape)  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    ours = T.init_params(cfg, seed=0, device="cpu")
    assert flat(jax.tree.map(lambda a: a.numpy(), ours)) == flat(_np(rp)) == flat(
        jax.tree.map(lambda a: a.numpy(), tp))
    if arch == "zamba2-1.2b":
        assert ours["shared_attn"]["attn"]["wq"]["w"].shape == (cfg.d_model, cfg.n_heads * cfg.hd)
        assert abs(float(ours["shared_attn"]["mlp"]["w_down"]["w"].std()) * cfg.d_ff ** 0.5 - 1) < 0.05
    else:
        assert ours["enc_layers"]["attn"]["wq"]["w"].shape[0] == cfg.enc_layers


@pytest.mark.parametrize("arch,kv", [("llama3.2-3b", "bf16"), ("llama3.2-3b", "int8"), ("whisper-tiny", "bf16"),
                                     ("whisper-tiny", "int8"), ("mamba2-130m", "bf16"), ("zamba2-1.2b", "bf16")])
def test_init_cache_layout_matches_reference(arch, kv):
    """Keys, shapes and dtypes of every family's cache (int8 only for attn:
    an encdec config keeps its float cache), zeroed."""
    rcfg, cfg = _cfgs(arch, kv_dtype=kv)
    for enc_len in (None, ENC_LEN):
        theirs = RT.init_cache(rcfg, B, MAX_LEN, enc_len=enc_len)
        ours = T.init_cache(cfg, B, MAX_LEN, enc_len=enc_len, device="cpu")
        assert sorted(ours) == sorted(theirs)
        for k, a in ours.items():
            assert tuple(a.shape) == theirs[k].shape and str(a.dtype).split(".")[-1] == theirs[k].dtype.name, k
            assert not a.any(), k
    if arch == "zamba2-1.2b":
        assert ours["k"].shape[0] == 1


def _check_encode(weights: str) -> None:
    """The encoder stack (bidirectional attention, gelu MLP) and each
    decoder layer's cross K/V."""
    rcfg, cfg, rp, _, tp, _ = _weights("whisper-tiny", weights)
    enc = _rand(np.random.default_rng(6), B, ENC_LEN, cfg.d_model)
    theirs = RT.encode_for_decode(rp, rcfg, jnp.asarray(enc))
    ours = T.encode_for_decode(tp, cfg, torch.from_numpy(enc))
    assert sorted(ours) == ["enc_k", "enc_v"]
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape == (cfg.n_layers, B, ENC_LEN, cfg.kv_heads * cfg.hd)
        _close(ours[k], theirs[k], k)


def test_encode_for_decode_matches_reference():
    """Float weights (packed: ``tests/test_torch_static_quant.py``)."""
    _check_encode("float")


# -- forward_decode over steps ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_step(arch: str, weights: str, kv_dtype: str = "bf16"):
    """The reference's jitted step, one per (arch, weights, KV dtype), so
    that a test that decodes twice compiles once."""
    rcfg = _model(arch, **({"kv_dtype": kv_dtype} if kv_dtype != "bf16" else {}))[0]
    return jax.jit(lambda p, c, tok, pos, h: RT.forward_decode(p, rcfg, c, tok, pos, head=h))


@functools.lru_cache(maxsize=None)
def _weights(arch: str, weights: str, **fields):
    """(rcfg, cfg, ref params, ref head, port params, port head) for a
    weights case: float, w4a4 packed with the (4, 4) head, int8 levels, or
    a mixed per-layer plan (attn: w4a4 / w2a2 at block_k 16, so K2; ssm:
    w2a2 / w5a3) with its (8, 8) head."""
    rcfg, cfg, rp, tp = _model(arch, **fields)
    rhead = head = None
    if weights == "packed":
        rp = ref_quantize_packed(rp, w_bits=4, a_bits=4, verbose=False)
        rhead = RL.prepack_lm_head(rp["embed"], w_bits=4, a_bits=4)
    elif weights == "int8":
        rp = ref_quantize_int8(rp)
    elif weights == "plan":
        bits = [(2, 2), (5, 3)] if cfg.family == "ssm" else [(4, 4), (2, 2)]
        rplan = RP.plan_from_bits(rcfg, arch=arch, bits=bits)
        plan = P.plan_from_bits(cfg, arch=arch, bits=bits)
        if cfg.family == "attn":
            rplan = dataclasses.replace(rplan, layers=[rplan.layers[0], dataclasses.replace(
                rplan.layers[1], block_k=16)])
            plan = dataclasses.replace(plan, layers=[plan.layers[0], dataclasses.replace(plan.layers[1], block_k=16)])
        assert plan.content_hash() == rplan.content_hash() and not plan.uniform
        applied, head = P.apply_plan(tp, cfg, plan, verbose=False, device="cpu")
        rp, rhead = RP.apply_plan(rp, rcfg, rplan, verbose=False)
        tp = params_from_jax(_np(rp))
        assert isinstance(tp["layers"], list) and len(tp["layers"]) == cfg.n_layers
        return rcfg, cfg, rp, rhead, tp, packed_from_jax(_np(rhead))
    if weights != "float":
        tp = params_from_jax(_np(rp))
        head = None if rhead is None else packed_from_jax(_np(rhead))
    return rcfg, cfg, rp, rhead, tp, head


def _decode_both(case, *, steps: int = STEPS, max_len: int = MAX_LEN, pos0: int = 0, seed: int = 0):
    """``steps`` decode steps on both sides from one random token a
    sequence at ``pos0``, each fed the reference's greedy token; float32
    caches (int8 where the config says).  ``case``: (arch, weights, KV
    dtype).  Raises AssertionError where a row, an argmax or (at the end) a
    cache entry differs."""
    arch, weights, kv = case
    rcfg, cfg, rp, rhead, tp, head = _weights(arch, weights, **({"kv_dtype": kv} if kv != "bf16" else {}))
    step = _ref_step(arch, weights, kv)
    rng = np.random.default_rng(seed)
    rcache = RT.init_cache(rcfg, B, max_len, dtype=jnp.float32, enc_len=ENC_LEN)
    cache = T.init_cache(cfg, B, max_len, dtype=torch.float32, enc_len=ENC_LEN, device="cpu")
    if cfg.family == "encdec":
        enc = _rand(rng, B, ENC_LEN, cfg.d_model)
        rcache.update(RT.encode_for_decode(rp, rcfg, jnp.asarray(enc)))
        cache.update(T.encode_for_decode(tp, cfg, torch.from_numpy(enc)))
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    for t in range(pos0, pos0 + steps):
        rlogits, rcache = step(rp, rcache, jnp.asarray(tok), jnp.asarray(t, jnp.int32), rhead)
        logits, cache = T.forward_decode(tp, cfg, cache, torch.from_numpy(tok), t, head=head)
        rlogits = np.asarray(rlogits)
        _close(logits, rlogits, f"step {t}")
        nxt = rlogits.argmax(-1)
        assert np.array_equal(logits.numpy().argmax(-1), nxt), t
        tok = nxt[:, None].astype(np.int32)
    assert sorted(cache) == sorted(rcache)
    for k, a in cache.items():
        assert a.dtype != torch.int8 or np.array_equal(a.numpy(), np.asarray(rcache[k])), k
        _close(a, rcache[k], f"cache {k}")
    return cache


DECODE_CASES = [(a, "float") for a in DECODE_ARCHS] + [("yi-6b", "float")]
KV_INT8 = ("llama3.2-3b", "gemma3-1b", "qwen2-vl-7b", "qwen3-moe-30b-a3b")


def _check_decode(arch: str, weights: str) -> dict:
    """Six steps of ``forward_decode`` on ``weights`` (the attn archs' int8
    weights on int8 KV caches too); returns the port's final cache."""
    kv = "int8" if weights == "int8" and arch in KV_INT8 else "bf16"
    cache = _decode_both((arch, weights, kv))
    if "k" in cache:
        assert (cache["k"].dtype == torch.int8) == (kv == "int8")
    if kv == "int8":
        assert cache["k_scale"].dtype == torch.float32 and cache["k_scale"].any()
    return cache


@pytest.mark.parametrize("arch,weights", DECODE_CASES, ids=[f"{a}-{w}" for a, w in DECODE_CASES])
def test_forward_decode_matches_reference(arch, weights):
    """Six steps of ``forward_decode`` for every family, float weights:
    rows, decisions and the caches at the end (the SSM and conv states, the
    hybrid's one shared KV cache, the encdec self-attention and cross K/V
    caches); yi-6b's smoke config among the attn archs.  Packed, int8 and
    plan weights: ``tests/test_torch_static_quant.py``."""
    _check_decode(arch, weights)


def test_forward_decode_past_max_len_matches_reference():
    """Steps from ``max_len - 2`` to ``max_len + 3``: every write past the
    end lands on the last row, as the reference's clamped update."""
    _decode_both(("llama3.2-3b", "float", "bf16"), max_len=8, pos0=6)


def test_conv_state_dtype_follows_the_reference():
    """A float32 step on the default bfloat16 cache: the reference's
    ``concatenate`` promotes the new conv state to float32 (its dtypes read
    by ``jax.eval_shape``), and so does the port's (rebound once, then
    written in place); the KV caches keep their dtype."""
    rcfg, cfg, rp, tp = _model("zamba2-1.2b")
    rcache, cache = RT.init_cache(rcfg, B, MAX_LEN), T.init_cache(cfg, B, MAX_LEN, device="cpu")
    tok = np.ones((B, 1), np.int32)
    rnew = jax.eval_shape(lambda c: RT.forward_decode(rp, rcfg, c, jnp.asarray(tok), jnp.asarray(0, jnp.int32))[1],
                          rcache)
    _, cache = T.forward_decode(tp, cfg, cache, torch.from_numpy(tok), 0)
    conv = cache["conv"]
    assert {k: str(v.dtype).split(".")[-1] for k, v in cache.items()} == {k: v.dtype.name for k, v in rnew.items()}
    assert conv.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
    _, cache = T.forward_decode(tp, cfg, cache, torch.from_numpy(tok), 1)
    assert cache["conv"] is conv


def test_hybrid_segments_match_reference():
    """zamba2-1.2b's 38 layers at k = 6: seven applications of the shared
    block, the last after a 2-layer segment."""
    for arch in ("zamba2-1.2b",):
        for smoke in (False, True):
            cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
            assert T._hybrid_segments(cfg) == RT._hybrid_segments(rcfg)
    assert T._hybrid_segments(get_config("zamba2-1.2b")) == [6] * 6 + [2]


def test_per_layer_params_refused_for_encdec_and_hybrid():
    for arch in ("whisper-tiny", "zamba2-1.2b"):
        rcfg, cfg, rp, tp = _model(arch)
        cache = T.init_cache(cfg, B, MAX_LEN, device="cpu")
        per = dict(tp, layers=[T.layer_params(tp["layers"], i) for i in range(cfg.n_layers)])
        with pytest.raises(NotImplementedError, match="per-layer"):
            T.forward_decode(per, cfg, cache, torch.zeros((B, 1), dtype=torch.int32), 0)


# -- planted faults ----------------------------------------------------------------------------


def _per_application_cache(monkeypatch, cfg):
    """Plant: each application of zamba2's shared block reads and writes a
    KV cache of its own (the reference has one, shared)."""
    inner, n_apps, calls, own = L.attention_decode, len(T._hybrid_segments(cfg)), [0], {}

    def attention_decode(params, s, x, cache_k, cache_v, pos, **kw):
        j = calls[0] % n_apps
        calls[0] += 1
        if j not in own:
            own[j] = (torch.zeros_like(cache_k), torch.zeros_like(cache_v))
        return inner(params, s, x, *own[j], pos, **kw)

    monkeypatch.setattr(L, "attention_decode", attention_decode)


def _skipped_cross_attention(monkeypatch, cfg):
    """Plant: the encdec step skips each layer's cross-attention."""
    monkeypatch.setattr(L, "cross_attention", lambda params, s, x, enc_kv, **kw: x)


@pytest.mark.parametrize("arch,plant", [("zamba2-1.2b", _per_application_cache),
                                        ("whisper-tiny", _skipped_cross_attention)],
                         ids=["per-application-hybrid-cache", "skipped-cross-attention"])
def test_planted_faults_fail_the_parity_check(monkeypatch, arch, plant):
    """The planted faults, each against the parity check that passes
    unplanted (``test_forward_decode_matches_reference``'s float case)."""
    plant(monkeypatch, _model(arch)[1])
    with pytest.raises(AssertionError):
        _decode_both((arch, "float", "bf16"))


# -- the paged engine against the unpaged loop (tests/diffcheck.py's relation) -----------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-130m"])
def test_paged_engine_stream_equals_forward_decode_loop(arch):
    """``tests/diffcheck.py``'s relation in the port: the paged engine at
    C = 1 (``build_engine``, w4a4, the (4, 4) head) gives, token for token,
    the greedy stream of the ``forward_decode`` loop fed as
    ``greedy_decode_reference`` feeds it (the prompt a token a step, then
    the argmax), on the same packed words and a cache as long as the
    engine's block table."""
    cfg = get_config(arch, smoke=True)
    page, max_len, max_new = 16, 32, 8
    params = quantize_params_packed(T.init_params(cfg, seed=0, device="cpu"), w_bits=4, a_bits=4, device="cpu")
    head = L.prepack_lm_head(params["embed"], w_bits=4, a_bits=4, device="cpu")
    prompts = np.random.default_rng(9).integers(0, cfg.vocab, (3, 5)).tolist()
    eng = build_engine(cfg, EngineConfig(n_slots=2, page_size=page, max_len=max_len), params=params, head=head,
                       device="cpu")
    for prompt in prompts:
        eng.submit(prompt, max_new)
    eng.run(realtime=False)
    streams = {r.rid: r.out_tokens for r in eng.finished}
    for rid, prompt in enumerate(prompts):
        cache = T.init_cache(cfg, 1, max_len, device="cpu")
        cur, out = prompt[0], []
        for t in range(len(prompt) + max_new - 1):
            logits, cache = T.forward_decode(params, cfg, cache, torch.tensor([[cur]], dtype=torch.int32), t,
                                             head=head)
            if t < len(prompt) - 1:
                cur = prompt[t + 1]
            else:
                cur = int(logits[0].argmax())
                out.append(cur)
        assert streams[rid] == out, rid
