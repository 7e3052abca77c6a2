"""gemma3-1b in the port against the JAX reference, on the CPU, at the
gemma3-1b smoke size: 3 layers with windows (8, 8, 0), one KV head of
width 32 for 2 query heads, the geglu MLP (tanh GELU) and a 512-word vocab.

Both packages run on identical weights and identical packed words: the
reference's params (``init_params(PRNGKey(0))``), its w4a4-packed
projections and its (4, 4) packed head cross over through
:mod:`repro_torch.bridge`.  Everything runs at float32.  Positions run
past the window of 8, so the sliding-window mask drops live keys in
layers 0 and 1 (the layer test checks that it does).

Tolerance: outputs agree to ``ATOL`` (float32 rounding: RoPE's cos/sin,
tanh and the sum orders of XLA and PyTorch differ in the last bits).
Engine logits agree to ``ATOL`` up to a request's first token divergence,
which is allowed only where the reference's top-2 logit gap is under
``TIE_BOUND`` (one activation-level flip of the packed path moves a logit
by about 0.1 at most).  KV pools after the in-place
writes are equal to the reference's returned pools: float pools to
``ATOL``, int8 levels exactly.  Page 0 is the null page, which invalid
lanes scatter onto in an unspecified order: it is never compared.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import _prompts
from test_torch_model import _recording

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import build_engine as ref_build_engine
from repro.serving.api import quantize_params_packed as ref_quantize_packed
from repro_torch.bridge import packed_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.paged_gather.kernel import paged_gather_plain
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, build_engine

ARCH = "gemma3-1b"
ATOL = 1e-4
TIE_BOUND = 0.25
WINDOW = 8  # gemma3-1b-smoke's local window (layers 0 and 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work on one intra-op thread (at the smoke size thread
    hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    ref = dataclasses.replace(ref_get_config(ARCH, smoke=True), dtype=jnp.float32, **kw)
    ours = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32, **kw)
    return ref, ours


@pytest.fixture(scope="module")
def gemma():
    """Reference params (float and w4a4-packed) and the (4, 4) packed head,
    with their port twins."""
    rcfg, cfg = _cfgs()
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rpk = ref_quantize_packed(rp, w_bits=4, a_bits=4, verbose=False)
    rhead = RL.prepack_lm_head(rp["embed"], w_bits=4, a_bits=4)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(rcfg=rcfg, cfg=cfg, rp=rp, rpk=rpk, rhead=rhead,
                tp=params_from_jax(to_np(rp)), tpk=params_from_jax(to_np(rpk)),
                thead=packed_from_jax(to_np(rhead)))


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(ours.to(torch.float32).numpy(), np.asarray(theirs, np.float32),
                               rtol=0, atol=ATOL)


def _layer(g, packed: bool, i: int):
    rl = jax.tree.map(lambda a: a[i], (g["rpk"] if packed else g["rp"])["layers"])
    return rl, T.layer_params((g["tpk"] if packed else g["tp"])["layers"], i)


def test_config_mirrors_the_reference():
    for smoke in (False, True):
        ref, ours = ref_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(ours):
            if f.name not in ("dtype", "quant"):
                assert getattr(ours, f.name) == getattr(ref, f.name), (smoke, f.name)
        assert ours.windows() == np.asarray(ref.windows()).tolist()
    assert get_config(ARCH).windows() == ([1024] * 5 + [0]) * 4 + [1024] * 2
    assert get_config(ARCH, smoke=True).windows() == [8, 8, 0]


def test_params_and_pools_have_the_reference_layout(gemma):
    """``init_params`` (w_gate included) and ``init_paged_state`` at one KV
    head of width ``hd``, key for key and shape for shape."""
    cfg, rcfg = gemma["cfg"], gemma["rcfg"]
    ours = T.init_params(cfg, seed=0, device="cpu")
    flat = lambda t: {jax.tree_util.keystr(k): v.shape  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(jax.tree.map(lambda a: a.numpy(), ours)) == flat(gemma["rp"])
    assert "w_gate" in ours["layers"]["mlp"]
    for kv in ("bf16", "int8"):
        st = T.init_paged_state(dataclasses.replace(cfg, kv_dtype=kv), 3, 7, 4, device="cpu")
        rst = RT.init_paged_state(dataclasses.replace(rcfg, kv_dtype=kv), 3, 7, 4)
        assert {k: tuple(v.shape) for k, v in st.items()} == {k: v.shape for k, v in rst.items()}
        assert st["k"].shape[-1] == cfg.kv_heads * cfg.hd == 32


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
@pytest.mark.parametrize("C", [1, 4])
def test_geglu_mlp_matches_reference(gemma, packed, C):
    rcfg, cfg = gemma["rcfg"], gemma["cfg"]
    assert cfg.mlp_spec().kind == "geglu"
    rl, tl = _layer(gemma, packed, 1)
    x = np.random.default_rng(8 + C).normal(size=(3, C, cfg.d_model)).astype(np.float32)
    _close(L.mlp(tl["mlp"], cfg.mlp_spec(), torch.from_numpy(x)),
           jax.jit(lambda p, x: RL.mlp(p, rcfg.mlp_spec(), x))(rl["mlp"], jnp.asarray(x)))


# the layer test's slots (page size 4, 8 blocks, so T = 32): slot 0 inactive
# (an all-null row); slot 1 decodes at position 20; slot 2 feeds 4 lanes at
# 13-16 across a page boundary; slot 3 feeds 3 lanes at 9-11.  Every active
# lane sits past the window of 8, so the mask drops some of its live keys.
PS, NB, P = 4, 8, 16
POS = np.array([0, 20, 13, 9], np.int32)
LENS = np.array([0, 1, 4, 3], np.int32)
TABLE = np.array([[0] * 8, [1, 2, 3, 4, 5, 6, 0, 0], [7, 8, 9, 10, 11, 0, 0, 0],
                  [12, 13, 14, 0, 0, 0, 0, 0]], np.int32)


def _layer_pools(pool: str, seed: int) -> dict:
    """numpy pools: float32 values (the bf16 pool's are its bf16 rounding)
    or int8 levels and per-row scales of them."""
    rng = np.random.default_rng(seed)
    fp = rng.normal(size=(2, P, PS, 32)).astype(np.float32)
    if pool == "int8":
        sc = (np.abs(fp).max(-1, keepdims=True) / 127 + 1e-12).astype(np.float32)
        lv = np.clip(np.round(fp / sc), -127, 127).astype(np.int8)
        return dict(pool_k=lv[0], pool_v=lv[1], pool_k_scale=sc[0], pool_v_scale=sc[1])
    return dict(pool_k=fp[0], pool_v=fp[1])


def _window_drops_live_keys(C: int, lens) -> None:
    """Every active lane's window mask drops some key its causal mask keeps."""
    pos, table = torch.from_numpy(POS), torch.from_numpy(TABLE)
    z = torch.zeros((P, PS, 32))
    masks = [paged_gather_plain(table, pos, w, z, z, chunk=C, out_dtype=torch.float32)[2]
             .reshape(len(POS), C, -1) for w in (WINDOW, 0)]
    for s in range(1, len(POS)):
        for j in range(1 if lens is None else int(lens[s])):
            win, causal = masks[0][s, j], masks[1][s, j]
            assert bool((causal & ~win).any()) and not bool((win & ~causal).any()), (s, j)


@pytest.mark.parametrize("gather", ["xla", "kernel"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("C", [1, 4])
def test_windowed_attention_decode_paged_matches_reference(gemma, gather, pool, C):
    """Layer 0 (window 8) at H/G = 2, one lane a slot (``lens=None``) or a
    chunk of 4 with per-slot ``lens``: outputs of the valid lanes and the
    pools after the in-place writes.  Float projections: the packed ones
    run in the paged forward and engine tests below."""
    rcfg, cfg = gemma["rcfg"], gemma["cfg"]
    assert cfg.windows()[0] == WINDOW and cfg.n_heads // cfg.kv_heads == 2
    rl, tl = _layer(gemma, False, 0)
    lens = None if C == 1 else LENS
    _window_drops_live_keys(C, lens)
    pools = _layer_pools(pool, seed=C)
    x = np.random.default_rng(3 + C).normal(size=(len(POS), C, cfg.d_model)).astype(np.float32)
    scale_keys = ("pool_k_scale", "pool_v_scale") if pool == "int8" else ()

    def ref_pool(k):
        a = jnp.asarray(pools[k])
        return a.astype(jnp.bfloat16) if pool == "bf16" and k in ("pool_k", "pool_v") else a

    def port_pool(k):
        t = torch.from_numpy(pools[k].copy())
        return t.to(torch.bfloat16) if pool == "bf16" and k in ("pool_k", "pool_v") else t

    res = jax.jit(lambda p, x, pools, lens: RL.attention_decode_paged(
        p, rcfg.attn_spec(), x, *pools[:2], jnp.asarray(TABLE), jnp.asarray(POS), window=WINDOW,
        gather=gather, lens=lens, **dict(zip(scale_keys, pools[2:]))))(
        rl["attn"], jnp.asarray(x), [ref_pool(k) for k in ("pool_k", "pool_v") + scale_keys],
        None if lens is None else jnp.asarray(lens))
    tpools = {k: port_pool(k) for k in pools}
    out = L.attention_decode_paged(
        tl["attn"], cfg.attn_spec(), torch.from_numpy(x), tpools["pool_k"], tpools["pool_v"],
        torch.from_numpy(TABLE), torch.from_numpy(POS), window=WINDOW, gather=gather,
        lens=None if lens is None else torch.from_numpy(lens), **{k: tpools[k] for k in scale_keys})
    for s in range(len(POS)):
        n = C if lens is None else int(lens[s])
        _close(out[s, :n], np.asarray(res[0])[s, :n])
    for name, theirs in zip(("pool_k", "pool_v") + scale_keys, res[1:]):
        ours = tpools[name][1:]
        theirs = np.asarray(theirs.astype(jnp.float32) if theirs.dtype == jnp.bfloat16 else theirs)[1:]
        if ours.dtype == torch.int8:
            np.testing.assert_array_equal(ours.numpy(), theirs)
        else:
            _close(ours, theirs)


# the paged forward's schedule (3 slots, page size 4, 6 blocks): slot 0
# prefills 11 tokens in chunks of 4, 4, 3, slot 1 12 tokens in chunks of 4,
# slot 2 stays inactive; then both decode one token a step (lens=None) to
# positions 15 and 16, past the window of 8
FWD_CHUNKS = [([0, 0, 0], [4, 4, 0]), ([4, 4, 0], [4, 4, 0]), ([8, 8, 0], [3, 4, 0])]
FWD_DECODE = [[11 + t, 12 + t, 0] for t in range(5)]


@pytest.mark.parametrize("gather,kv", [("xla", "fp"), ("kernel", "int8")])
def test_forward_decode_paged_steps_match_reference(gemma, gather, kv):
    """All 3 layers (windows 8, 8, 0) on the packed words and the packed
    head, chunked steps and then decode steps: the active slots' logits
    at every step and every live page at the end.  (The layer test covers
    the other gather-pool pairs; the engine test runs all four.)"""
    kv_kw = dict(kv_dtype="int8") if kv == "int8" else {}
    rcfg, cfg = _cfgs(**kv_kw)
    S, nb, ps = 3, 6, 4
    rstate = RT.init_paged_state(rcfg, S, S * nb + 1, ps, dtype=jnp.float32)
    state = T.init_paged_state(cfg, S, S * nb + 1, ps, dtype=torch.float32, device="cpu")
    table = np.zeros((S, nb), np.int32)
    table[0], table[1] = np.arange(1, 7), np.arange(7, 13)
    rng = np.random.default_rng(11)
    # the reference's step jitted, as its engine runs it
    ref_step = jax.jit(lambda p, head, st, tb, tok, pos, lens: RT.forward_decode_paged(
        p, rcfg, st, tb, tok, pos, head=head, lens=lens, gather=gather))
    steps = [(4, p, lens) for p, lens in FWD_CHUNKS] + [(1, p, None) for p in FWD_DECODE]
    for C, pos, lens in steps:
        tokens = rng.integers(0, cfg.vocab, (S, C)).astype(np.int32)
        pos = np.array(pos, np.int32)
        lens = None if lens is None else np.array(lens, np.int32)
        rlog, rstate = ref_step(gemma["rpk"], gemma["rhead"], rstate, jnp.asarray(table), jnp.asarray(tokens),
                                jnp.asarray(pos), None if lens is None else jnp.asarray(lens))
        logits, state = T.forward_decode_paged(
            gemma["tpk"], cfg, state, torch.from_numpy(table), torch.from_numpy(tokens),
            torch.from_numpy(pos), head=gemma["thead"],
            lens=None if lens is None else torch.from_numpy(lens), gather=gather)
        _close(logits[:2], np.asarray(rlog)[:2])
    for name in state:
        ours, theirs = state[name][:, 1:], np.asarray(rstate[name])[:, 1:]
        if ours.dtype == torch.int8:
            np.testing.assert_array_equal(ours.numpy(), theirs)
        else:
            _close(ours, theirs)


# -- the engine on the reference's sliding-window fixture -----------------------------

# tests/test_serving.py test_engine_gather_kernel_token_identical_under_preemption
# at arch="gemma3-1b": 5 usable pages of 4 tokens for 3 requests of worst case
# 4-5 pages each, so the on-demand engine preempts and replays chunked
FIXTURE = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, admit="on-demand", chunk_tokens=4)


def _check_streams(reng, peng, rrec, prec) -> None:
    ref_out = {r.rid: r.out_tokens for r in reng.finished}
    out = {r.rid: r.out_tokens for r in peng.finished}
    assert sorted(out) == sorted(ref_out)
    for rid, theirs in ref_out.items():
        ours = out[rid]
        assert len(ours) == len(theirs)
        div = next((t for t in range(len(theirs)) if ours[t] != theirs[t]), None)
        for t in range(len(theirs) if div is None else div + 1):
            np.testing.assert_allclose(prec[(rid, t)], rrec[(rid, t)], rtol=0, atol=ATOL)
        if div is not None:
            top2 = np.sort(rrec[(rid, div)])[-2:]
            assert top2[1] - top2[0] < TIE_BOUND, (rid, div, top2)


@pytest.mark.parametrize("weights,gather,kv", [
    ("float", "xla", "fp"), ("float", "kernel", "fp"), ("float", "xla", "int8"),
    ("float", "kernel", "int8"), ("packed", "kernel", "fp"), ("packed", "kernel", "int8")])
def test_engine_matches_reference_under_preemption(gemma, weights, gather, kv):
    """The reference's sliding-window fixture: prompts of 9, 6 and 11 tokens
    from ``PRNGKey(7)``, 6 new tokens each, under both gathers and on fp
    and int8 KV pools.  ``float``: float projections and the float head;
    ``packed``: w4a4 projections and the packed (4, 4) head, through the
    kernel gather as served.  Steps, tokens fed and preemptions equal the
    reference engine's, every sampled row agrees to ATOL and the tokens up
    to the tie bound."""
    kv_kw = dict(kv_dtype="int8") if kv == "int8" else {}
    rcfg, cfg = _cfgs(**kv_kw)
    packed = weights == "packed"
    kw = dict(FIXTURE, gather_backend=gather, packed_head=packed, head_bits=(4, 4))
    reng = ref_build_engine(rcfg, RefEngineConfig(**kw), params=gemma["rpk" if packed else "rp"],
                            head=gemma["rhead"] if packed else None)
    peng = build_engine(cfg, EngineConfig(**kw), params=gemma["tpk" if packed else "tp"],
                        head=gemma["thead"] if packed else None, device="cpu")
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], cfg.vocab)
    build.reset_counts()
    ms = []
    for eng in (reng, peng):
        for p in prompts:
            eng.submit(p, 6)
        ms.append(eng.run(realtime=False))
    assert build.counts() == dict.fromkeys(build.COUNTS, 0)  # the CPU runs the plain versions
    rm, m = ms
    assert m["statuses"] == {"ok": 3}
    assert m["preemptions"] > 0, "the undersized pool must force preemption"
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m[key] == rm[key], key
    assert max(len(p) for p in prompts) + 6 > WINDOW + 1  # decoding runs past the window
    _check_streams(reng, peng, rrec, prec)
    peng.assert_no_leaks()
