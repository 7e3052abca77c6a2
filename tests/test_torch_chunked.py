"""Chunked prefill and on-demand admission with preemption in the port,
against the JAX reference, on the CPU, at the llama3.2-3b smoke size.

Both packages run on identical weights and packed words (the fixture and
tolerances of ``tests/test_torch_model.py``): layer outputs and pools
agree to ``ATOL``; engine logits agree to ``ATOL`` up to a request's first
token divergence, which is allowed only where the reference's top-2 logit
gap is under ``TIE_BOUND``.  Page 0 is the null page: invalid lanes
scatter onto it in both packages, and which of several writes to one of
its rows lands is unspecified, so it is never compared.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serving import _prompts
from test_torch_model import ATOL, TIE_BOUND, _close, _recording, shared  # noqa: F401 (shared: fixture)

from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import build_engine as ref_build_engine
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, build_engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU engine on one intra-op thread (at the smoke size
    thread hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

C = 4
# slot geometry for the layer test (page size 8, 4 blocks, so T = 32):
# slot 0 inactive (lens 0, all-null row); slot 1 decodes at position 30,
# so its invalid lanes 31-33 run past the last live position and past T
# (clamped); slots 2 and 3 feed 3 and 4 lanes across a page boundary
LENS = np.array([0, 1, 3, 4], np.int32)
POS = np.array([0, 30, 6, 5], np.int32)
TABLE = np.array([[0, 0, 0, 0], [3, 7, 1, 5], [2, 6, 0, 0], [4, 8, 0, 0]], np.int32)


def _layer_pools(int8: bool, seed: int):
    rng = np.random.default_rng(seed)
    P, ps, D = 9, 8, 32
    if int8:
        return dict(pool_k=rng.integers(-127, 128, (P, ps, D)).astype(np.int8),
                    pool_v=rng.integers(-127, 128, (P, ps, D)).astype(np.int8),
                    pool_k_scale=rng.uniform(1e-3, 2e-2, (P, ps, 1)).astype(np.float32),
                    pool_v_scale=rng.uniform(1e-3, 2e-2, (P, ps, 1)).astype(np.float32))
    return dict(pool_k=rng.normal(size=(P, ps, D)).astype(np.float32),
                pool_v=rng.normal(size=(P, ps, D)).astype(np.float32))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
@pytest.mark.parametrize("gather", ["xla", "kernel"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp-pool", "int8-pool"])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_decode_paged_with_lens_matches_reference(shared, packed, gather, int8, window):
    rcfg, cfg = shared["rcfg"], shared["cfg"]
    rl = jax.tree.map(lambda a: a[0], (shared["rpk"] if packed else shared["rp"])["layers"])
    tl = T.layer_params((shared["tpk"] if packed else shared["tp"])["layers"], 0)
    pools = _layer_pools(int8, seed=window + 2 * int8)
    x = np.random.default_rng(3).normal(size=(4, C, cfg.d_model)).astype(np.float32)
    scale_keys = ("pool_k_scale", "pool_v_scale") if int8 else ()
    res = RL.attention_decode_paged(
        rl["attn"], rcfg.attn_spec(), jnp.asarray(x), jnp.asarray(pools["pool_k"]),
        jnp.asarray(pools["pool_v"]), jnp.asarray(TABLE), jnp.asarray(POS), window=window,
        lens=jnp.asarray(LENS), gather=gather, **{k: jnp.asarray(pools[k]) for k in scale_keys},
    )
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    out = L.attention_decode_paged(
        tl["attn"], cfg.attn_spec(), torch.from_numpy(x), tpools["pool_k"], tpools["pool_v"],
        torch.from_numpy(TABLE), torch.from_numpy(POS), window=window, lens=torch.from_numpy(LENS),
        gather=gather, **{k: tpools[k] for k in scale_keys},
    )
    for s, n in enumerate(LENS):  # valid lanes only
        _close(out[s, :n], np.asarray(res[0])[s, :n])
    # every live page (1..8) after the in-place writes, against the
    # reference's returned pools; the valid lanes wrote 8 rows
    names = ("pool_k", "pool_v") + scale_keys
    for name, theirs in zip(names, res[1:]):
        ours, theirs = tpools[name][1:], np.asarray(theirs)[1:]
        if name in ("pool_k", "pool_v") and int8:
            # a level may differ by one where a row's float32 value sits on
            # a rounding boundary of its int8 quantization
            assert np.abs(ours.numpy().astype(np.int32) - theirs.astype(np.int32)).max() <= 1
        else:
            _close(ours, theirs)
    changed = (tpools["pool_k"][1:] != torch.from_numpy(pools["pool_k"][1:])).any(-1)
    assert int(changed.sum()) == int(LENS.sum())


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
def test_head_paged_takes_the_last_valid_lane(shared, packed):
    rcfg, cfg = shared["rcfg"], shared["cfg"]
    x = np.random.default_rng(4).normal(size=(4, C, cfg.d_model)).astype(np.float32)
    rhead, thead = (shared["rhead"], shared["thead"]) if packed else (None, None)
    ours = T.head_paged(shared["tp"], cfg, torch.from_numpy(x), lens=torch.from_numpy(LENS), head=thead)
    _close(ours, RT.head_paged(shared["rp"], rcfg, jnp.asarray(x), lens=jnp.asarray(LENS), head=rhead))
    # lens 0 reads lane 0, like lens 1
    _close(ours[:2], T.head_paged(shared["tp"], cfg, torch.from_numpy(x[:2, :1]), head=thead))


@pytest.mark.parametrize("gather", ["xla", "kernel"])
def test_forward_decode_paged_mixed_chunks_match_reference(shared, gather):
    """Slot 0 prefills 11 tokens in chunks of 4, 4, 3 then decodes; slot 1
    decodes throughout; slot 2 stays inactive: logits of the active slots
    and every live page."""
    rcfg, cfg = shared["rcfg"], shared["cfg"]
    S, nb, ps = 3, 4, 8
    rstate = RT.init_paged_state(rcfg, S, S * nb + 1, ps, dtype=jnp.float32)
    state = T.init_paged_state(cfg, S, S * nb + 1, ps, dtype=torch.float32, device="cpu")
    table = np.zeros((S, nb), np.int32)
    table[0, :2], table[1, :2] = [1, 2], [3, 4]
    rng = np.random.default_rng(10)
    schedule = [([0, 5, 0], [4, 1, 0]), ([4, 6, 0], [4, 1, 0]), ([8, 7, 0], [3, 1, 0]),
                ([11, 8, 0], [1, 1, 0])]
    for pos, lens in schedule:
        tokens = rng.integers(0, cfg.vocab, (S, C)).astype(np.int32)
        pos, lens = np.array(pos, np.int32), np.array(lens, np.int32)
        rlog, rstate = RT.forward_decode_paged(
            shared["rpk"], rcfg, rstate, jnp.asarray(table), jnp.asarray(tokens), jnp.asarray(pos),
            head=shared["rhead"], lens=jnp.asarray(lens), gather=gather)
        logits, state = T.forward_decode_paged(
            shared["tpk"], cfg, state, torch.from_numpy(table), torch.from_numpy(tokens),
            torch.from_numpy(pos), head=shared["thead"], lens=torch.from_numpy(lens), gather=gather)
        _close(logits[:2], np.asarray(rlog)[:2])
    _close(state["k"][:, 1:], np.asarray(rstate["k"])[:, 1:])
    _close(state["v"][:, 1:], np.asarray(rstate["v"])[:, 1:])


# -- engine parity ------------------------------------------------------------------


def _check_streams(reng, peng, rrec, prec) -> None:
    """Logits rows to ATOL up to each request's first token divergence,
    which must sit on a reference top-2 gap under TIE_BOUND."""
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


def _engines(shared, kw, packed: bool, packed_head: bool):
    rp, tp = (shared["rpk"], shared["tpk"]) if packed else (shared["rp"], shared["tp"])
    reng = ref_build_engine(shared["rcfg"], RefEngineConfig(**kw, packed_head=packed_head,
                                                            head_bits=(4, 4)),
                            params=rp, head=shared["rhead"] if packed_head else None)
    peng = build_engine(shared["cfg"], EngineConfig(**kw, packed_head=packed_head, head_bits=(4, 4)),
                        params=tp, head=shared["thead"] if packed_head else None, device="cpu")
    return reng, peng


@pytest.mark.parametrize("packed_head", [True, False], ids=["packed-head", "float-head"])
def test_chunked_engine_matches_reference(shared, packed_head):
    """w4a4 packed projections, chunk_tokens=4, reserve admission, kernel
    gather: 6 requests through 4 slots."""
    kw = dict(n_slots=4, page_size=8, max_len=64, chunk_tokens=C, gather_backend="kernel")
    reng, peng = _engines(shared, kw, packed=True, packed_head=packed_head)
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, shared["cfg"].vocab, int(rng.integers(3, 13))).tolist() for _ in range(6)]
    ms = []
    for eng in (reng, peng):
        for p in prompts:
            eng.submit(p, 8)
        ms.append(eng.run(realtime=False))
    (rm, m) = ms
    assert m["statuses"] == {"ok": 6} and m["preemptions"] == 0
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m[key] == rm[key], key
    assert m["fed_tokens"] > m["steps"]  # prefill really was chunked
    _check_streams(reng, peng, rrec, prec)


@pytest.mark.parametrize("gather", ["xla", "kernel"])
def test_forced_preemption_matches_reference(shared, gather):
    """The reference's forced-preemption fixture (tests/test_serving.py
    test_forced_preemption_resumes_token_identical): 5 usable pages of 4
    tokens for 3 requests of worst case 4-5 pages each, the PRNGKey(7)
    prompts, float weights at float32."""
    kw = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=C, admit="on-demand",
              gather_backend=gather)
    reng, peng = _engines(shared, kw, packed=False, packed_head=False)
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], shared["cfg"].vocab)
    ms = []
    for eng in (reng, peng):
        for p in prompts:
            eng.submit(p, 6)
        ms.append(eng.run(realtime=False))
    rm, m = ms
    assert m["statuses"] == {"ok": 3}
    assert m["preemptions"] > 0, "undersized pool must force preemption"
    for key in ("preemptions", "steps", "fed_tokens"):
        assert m[key] == rm[key], key
    _check_streams(reng, peng, rrec, prec)
    peng.assert_no_leaks()


def _port_engine(shared, **kw):
    return build_engine(shared["cfg"], EngineConfig(**kw), params=shared["tp"], device="cpu")


def test_chunked_prefill_needs_fewer_steps(shared):
    """A 24-token prompt prefilled in chunks of 8 takes 3 steps where the
    one-token step takes 24, and samples the same tokens."""
    prompt = np.random.default_rng(3).integers(1, shared["cfg"].vocab, 24).tolist()

    def run(chunk):
        eng = _port_engine(shared, n_slots=1, page_size=4, max_len=32, chunk_tokens=chunk)
        req = eng.submit(prompt, max_new_tokens=4)
        m = eng.run(realtime=False)
        return m["steps"], m["fed_tokens"], req.out_tokens

    steps1, fed1, toks1 = run(1)
    steps8, fed8, toks8 = run(8)
    assert toks1 == toks8
    assert steps1 == len(prompt) + 4 - 1
    assert steps8 == -(-len(prompt) // 8) + 4 - 1
    assert fed1 == fed8 == len(prompt) + 4 - 1


def _max_active(eng) -> list:
    seen = [0]
    orig = eng._step_once

    def spy(now_fn):
        seen[0] = max(seen[0], len(eng.scheduler.active))
        return orig(now_fn)

    eng._step_once = spy
    return seen


def test_on_demand_admits_without_reservation(shared):
    """Reserve admits one worst-case request at a time into a tight pool;
    on-demand packs both, because their actual peak footprints fit."""
    prompts = [np.random.default_rng(1 + i).integers(1, shared["cfg"].vocab, 4).tolist() for i in range(2)]
    gens = [8, 2]  # worst cases 3 + 2 pages > pool of 4; peak actual = 4

    def run(admit):
        eng = _port_engine(shared, n_slots=2, page_size=4, max_len=16, n_pages=5, admit=admit)
        for p, g in zip(prompts, gens):
            eng.submit(p, max_new_tokens=g)
        seen = _max_active(eng)
        m = eng.run(realtime=False)
        assert m["n_requests"] == 2
        eng.assert_no_leaks()
        return seen[0], m["preemptions"]

    assert run("reserve") == (1, 0)
    assert run("on-demand") == (2, 0)


def test_step_is_skipped_when_funding_preempts_every_slot(shared):
    """An allocator that refuses the first three page grants: the first
    funding pass preempts both slots (the second, then the requester
    itself) and the step is skipped; admission places both again on the
    next loop, and the run ends with the tokens of an undisturbed run."""
    kw = dict(n_slots=2, page_size=4, max_len=16, chunk_tokens=C, admit="on-demand")
    prompts = [[5, 6, 7, 8, 9], [10, 11, 12]]
    outs, runs = [], []
    for refused in (0, 3):
        eng = _port_engine(shared, **kw)
        for p in prompts:
            eng.submit(p, 4)
        alloc, calls = eng.allocator.alloc, [0]

        def flaky(n, alloc=alloc, calls=calls, refused=refused):
            calls[0] += 1
            return None if calls[0] <= refused else alloc(n)

        eng.allocator.alloc = flaky
        once, stepped = eng._step_once, []

        def step_once(now_fn, once=once, stepped=stepped):
            stepped.append(once(now_fn))
            return stepped[-1]

        eng._step_once = step_once
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 2}
        eng.assert_no_leaks()
        outs.append([r.out_tokens for r in sorted(eng.finished, key=lambda r: r.rid)])
        runs.append((stepped.count(False), m["preemptions"], m["steps"]))
    assert outs[0] == outs[1]
    assert runs[0][:2] == (0, 0)
    assert runs[1][:2] == (1, 3)


def test_engine_config_checks(shared):
    with pytest.raises(ValueError):
        _port_engine(shared, chunk_tokens=0)
    with pytest.raises(ValueError):
        _port_engine(shared, admit="lazy")
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        _port_engine(shared, policy="gang")
    with pytest.raises(ValueError, match="static gang admission requires"):
        _port_engine(shared, policy="static", admit="on-demand")
    # int8 KV pools build: int8 levels beside float32 per-row scales
    cfg = get_config("llama3.2-3b", smoke=True)
    eng = build_engine(dataclasses.replace(cfg, kv_dtype="int8"), EngineConfig(chunk_tokens=C),
                       device="cpu")
    assert {k: v.dtype for k, v in eng.state.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32, "v_scale": torch.float32}
