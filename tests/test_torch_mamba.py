"""mamba2-130m in the port against the JAX reference, on the CPU, at the
mamba2-130m smoke size: 2 layers, d 64 (d_inner 128), state 16, 8 heads
of width 16, conv width 4 and a 512-word vocab.

Both packages run on identical weights and identical packed words: the
reference's params (``init_params(PRNGKey(0))``), its w4a4-packed
projections (``in_z``, ``in_xbc``, ``out_proj``; ``in_dt`` stays float)
and its (4, 4) packed head cross over through :mod:`repro_torch.bridge`.
Everything runs at float32 on one torch thread.

Tolerance: outputs and states agree to ``ATOL`` (float32 rounding: exp,
softplus, silu and the read-out's sum order differ between XLA and
PyTorch in the last bits).  Engine logits agree to ``ATOL`` up to a
request's first token divergence, which is allowed only where the
reference's top-2 logit gap is under ``TIE_BOUND`` (one activation-level
flip of the packed path moves a logit by about 0.1 at most).  A lane past
its slot's ``lens`` leaves that slot's state bit-identical.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_serving import _prompts
from test_torch_chunked import _check_streams
from test_torch_model import _recording

from repro import plan as RP
from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import mamba as RM
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import build_engine as ref_build_engine
from repro.serving.api import quantize_params_packed as ref_quantize_packed
from repro_torch import plan as P
from repro_torch.bridge import packed_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, EngineConfig, build_engine

ARCH = "mamba2-130m"
ATOL = 1e-4
SSM_LEAVES = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "out_norm", "in_dt")


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def mamba():
    """Reference params (float and w4a4-packed) and the (4, 4) packed head,
    with their port twins."""
    rcfg, cfg = _cfgs()
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rpk = ref_quantize_packed(rp, w_bits=4, a_bits=4, verbose=False)
    rhead = RL.prepack_lm_head(rp["embed"], w_bits=4, a_bits=4)
    return dict(rcfg=rcfg, cfg=cfg, rp=rp, rpk=rpk, rhead=rhead, tp=params_from_jax(_np(rp)),
                tpk=params_from_jax(_np(rpk)), thead=packed_from_jax(_np(rhead)))


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(ours.to(torch.float32).numpy(), np.asarray(theirs, np.float32),
                               rtol=0, atol=ATOL)


def _layer(m, packed: bool, i: int):
    rl = jax.tree.map(lambda a: a[i], (m["rpk"] if packed else m["rp"])["layers"])
    return rl, T.layer_params((m["tpk"] if packed else m["tp"])["layers"], i)


def _states(cfg, B: int, seed: int):
    s = cfg.ssm_spec()
    rng = np.random.default_rng(seed)
    st = rng.normal(size=(B, s.n_heads, s.d_state, s.head_dim)).astype(np.float32)
    cv = rng.normal(size=(B, s.conv_width - 1, s.d_inner + 2 * s.d_state)).astype(np.float32)
    return st, cv


# -- config, params, state --------------------------------------------------------


def test_config_and_spec_mirror_the_reference():
    for smoke in (False, True):
        ref, ours = ref_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(ours):
            if f.name not in ("dtype", "quant"):
                assert getattr(ours, f.name) == getattr(ref, f.name), (smoke, f.name)
        rs, s = ref.ssm_spec(), ours.ssm_spec()
        assert rs.shard_heads is None
        for f in dataclasses.fields(s):
            assert getattr(s, f.name) == getattr(rs, f.name), (smoke, f.name)
        assert (s.d_inner, s.n_heads) == (rs.d_inner, rs.n_heads)
    full = get_config(ARCH).ssm_spec()
    assert (full.d_inner, full.n_heads, full.d_state, full.head_dim) == (1536, 24, 128, 64)


def test_params_and_state_have_the_reference_layout(mamba):
    """``init_params`` key for key and shape for shape, with the reference's
    deterministic parts; ``init_paged_state`` a float32 SSM state and a conv
    state in ``dtype`` (or a float override), no K/V pools."""
    cfg, rcfg = mamba["cfg"], mamba["rcfg"]
    ours = T.init_params(cfg, seed=0, device="cpu")
    flat = lambda t: {jax.tree_util.keystr(k): v.shape  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(jax.tree.map(lambda a: a.numpy(), ours)) == flat(mamba["rp"])
    lay, rlay = ours["layers"], _np(mamba["rp"]["layers"])
    np.testing.assert_allclose(lay["a_log"].numpy(), rlay["a_log"], rtol=1e-6, atol=0)
    for k in ("conv_b", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(lay[k].numpy(), rlay[k])
    for k in ("ln", "out_norm"):
        np.testing.assert_array_equal(lay[k]["g"].numpy(), rlay[k]["g"])
    for kw in ({}, {"kv_dtype": torch.float32}, {"dtype": torch.float32}):
        st = T.init_paged_state(cfg, 3, 7, 4, device="cpu", **kw)
        rkw = {k: jnp.float32 for k in kw}
        rst = RT.init_paged_state(rcfg, 3, 7, 4, **rkw)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in st.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in rst.items()}
        assert not any(bool(v.any()) for v in st.values())


def test_bridge_carries_the_ssm_leaves_and_in_dt_stays_float(mamba):
    """``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip``,
    ``out_norm`` and ``in_dt`` cross unchanged, packed or not; packing
    leaves ``in_dt`` a float product in both packages and reports no
    projection tensor as skipped."""
    for tp, rp in ((mamba["tp"], mamba["rp"]), (mamba["tpk"], mamba["rpk"])):
        ours, theirs = tp["layers"], _np(rp["layers"])
        for k in SSM_LEAVES:
            for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), ours[k])),
                            jax.tree.leaves(theirs[k])):
                assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("in_z", "in_xbc", "out_proj"):
        assert isinstance(mamba["tpk"]["layers"][k]["w"], PackedDenseParams), k
    skipped: list = []
    packed = P.prepack_tree(mamba["tp"], w_bits=4, a_bits=4, skipped=skipped, device="cpu")
    assert skipped == []
    assert isinstance(packed["layers"]["in_dt"]["w"], torch.Tensor)
    assert not hasattr(mamba["rpk"]["layers"]["in_dt"]["w"], "w_packed")


def test_softplus_agrees_with_jax_above_20():
    """``F.softplus`` returns ``x`` above 20 where ``jax.nn.softplus``
    computes ``log1p(exp(-x)) + x``; in float32 the two are equal there,
    and within an ulp below."""
    x = np.concatenate([np.linspace(-40, 60, 4001, dtype=np.float32),
                        np.random.default_rng(0).normal(size=4096).astype(np.float32) * 8])
    ours = F.softplus(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    big = x > 20
    assert big.sum() > 1000
    np.testing.assert_array_equal(ours[big], theirs[big])
    np.testing.assert_allclose(ours, theirs, rtol=2e-7, atol=1e-30)


# -- the layer ------------------------------------------------------------------------


@pytest.mark.parametrize("dt_shift", [0.0, 25.0], ids=["dt", "dt-past-20"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
def test_mamba_decode_matches_reference(mamba, packed, dt_shift):
    """One token through layer 1: output, SSM and conv states.  ``dt-past-20``
    shifts ``dt_bias`` so that softplus runs past 20 in every head."""
    rcfg, cfg = mamba["rcfg"], mamba["cfg"]
    rl, tl = _layer(mamba, packed, 1)
    if dt_shift:
        rl = dict(rl, dt_bias=rl["dt_bias"] + dt_shift)
        tl = dict(tl, dt_bias=tl["dt_bias"] + dt_shift)
    st, cv = _states(cfg, 3, seed=4)
    x = np.random.default_rng(5).normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    res = jax.jit(lambda p, x, st, cv: RM.mamba_decode(p, rcfg.ssm_spec(), x, st, cv))(
        rl, jnp.asarray(x), jnp.asarray(st), jnp.asarray(cv))
    t_st, t_cv = torch.from_numpy(st.copy()), torch.from_numpy(cv.copy())
    out = M.mamba_decode(tl, cfg.ssm_spec(), torch.from_numpy(x), t_st, t_cv)
    for ours, theirs in zip(out, res):
        assert tuple(ours.shape) == theirs.shape
        _close(ours, theirs)
    assert np.array_equal(t_st.numpy(), st) and np.array_equal(t_cv.numpy(), cv)  # inputs not written


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
def test_mamba_decode_chunk_with_lens_matches_reference(mamba, packed):
    """A chunk of 4 lanes with lens 0 (inactive), 1 (decoding), 3 (a
    partial chunk) and 4 (a full one): every valid lane's output and the
    final states; the inactive slot's state stays bit-identical, and
    lens=None equals lens of all 4."""
    rcfg, cfg = mamba["rcfg"], mamba["cfg"]
    rl, tl = _layer(mamba, packed, 0)
    lens = np.array([0, 1, 3, 4], np.int32)
    st, cv = _states(cfg, 4, seed=6)
    x = np.random.default_rng(7).normal(size=(4, 4, cfg.d_model)).astype(np.float32)
    res = jax.jit(lambda p, x, st, cv, lens: RM.mamba_decode_chunk(
        p, rcfg.ssm_spec(), x, st, cv, lens=lens))(rl, jnp.asarray(x), jnp.asarray(st), jnp.asarray(cv),
                                                   jnp.asarray(lens))
    h, ns, nc = M.mamba_decode_chunk(tl, cfg.ssm_spec(), torch.from_numpy(x), torch.from_numpy(st),
                                     torch.from_numpy(cv), lens=torch.from_numpy(lens))
    for s, n in enumerate(lens):
        _close(h[s, :n], np.asarray(res[0])[s, :n])
    _close(ns, res[1])
    _close(nc, res[2])
    assert np.array_equal(ns[0].numpy(), st[0]) and np.array_equal(nc[0].numpy(), cv[0])
    full = M.mamba_decode_chunk(tl, cfg.ssm_spec(), torch.from_numpy(x), torch.from_numpy(st),
                                torch.from_numpy(cv))
    every = M.mamba_decode_chunk(tl, cfg.ssm_spec(), torch.from_numpy(x), torch.from_numpy(st),
                                 torch.from_numpy(cv), lens=torch.full((4,), 4, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(full, every))


def test_reset_paged_slot_matches_reference(mamba):
    rcfg, cfg = mamba["rcfg"], mamba["cfg"]
    rng = np.random.default_rng(9)
    shapes = {k: tuple(v.shape) for k, v in T.init_paged_state(cfg, 3, 5, 4, dtype=torch.float32,
                                                                 device="cpu").items()}
    vals = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    state = {k: torch.from_numpy(v.copy()) for k, v in vals.items()}
    assert T.reset_paged_slot(cfg, state, 1) is state
    rstate = RT.reset_paged_slot(rcfg, {k: jnp.asarray(v) for k, v in vals.items()}, jnp.asarray(1, jnp.int32))
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(rstate[k]))
        assert not bool(state[k][:, 1].any())
        np.testing.assert_array_equal(state[k][:, [0, 2]].numpy(), vals[k][:, [0, 2]])
    attn_cfg = dataclasses.replace(cfg, family="attn")
    pools = {"k": torch.ones(2, 3, 4, 8)}
    assert T.reset_paged_slot(attn_cfg, pools, 0) is pools and bool(pools["k"].all())


# -- the paged forward --------------------------------------------------------------

# 3 slots, 6 steps; at C = 4 each step's lens per slot (0: inactive)
FWD_LENS = [[4, 1, 0], [4, 1, 0], [3, 1, 2], [1, 1, 4], [1, 0, 4], [1, 1, 1]]


@pytest.mark.parametrize("weights", ["packed", "float"])
@pytest.mark.parametrize("C", [1, 4])
def test_forward_decode_paged_steps_match_reference(mamba, C, weights):
    """Both layers over 6 steps, at C = 1 (lens=None, every slot) or C = 4
    with per-slot lens: every slot's logits at every step and the states
    in place at the end against the reference's returned ones; a slot fed
    no lane keeps its state bit-identical.  ``packed``: w4a4 projections
    and the packed (4, 4) head."""
    rcfg, cfg = mamba["rcfg"], mamba["cfg"]
    packed = weights == "packed"
    rp, tp = (mamba["rpk"], mamba["tpk"]) if packed else (mamba["rp"], mamba["tp"])
    rhead, thead = (mamba["rhead"], mamba["thead"]) if packed else (None, None)
    S = 3
    rstate = RT.init_paged_state(rcfg, S, 5, 4, dtype=jnp.float32)
    state = T.init_paged_state(cfg, S, 5, 4, dtype=torch.float32, device="cpu")
    ssm_buf, conv_buf = state["ssm"], state["conv"]
    table = np.zeros((S, 4), np.int32)  # ignored by the SSM family
    rng = np.random.default_rng(12 + C)
    ref_step = jax.jit(lambda p, head, st, tok, pos, lens: RT.forward_decode_paged(
        p, rcfg, st, jnp.asarray(table), tok, pos, head=head, lens=lens))
    pos = np.zeros(S, np.int32)
    for lens in FWD_LENS:
        tokens = rng.integers(0, cfg.vocab, (S, C)).astype(np.int32)
        tl = None if C == 1 else np.array(lens, np.int32)
        rlog, rstate = ref_step(rp, rhead, rstate, jnp.asarray(tokens), jnp.asarray(pos),
                                None if tl is None else jnp.asarray(tl))
        before = {k: v.clone() for k, v in state.items()}
        logits, out_state = T.forward_decode_paged(
            tp, cfg, state, torch.from_numpy(table), torch.from_numpy(tokens), torch.from_numpy(pos),
            head=thead, lens=None if tl is None else torch.from_numpy(tl))
        assert out_state is state and state["ssm"] is ssm_buf and state["conv"] is conv_buf
        _close(logits, rlog)
        for s in range(S):
            if tl is not None and tl[s] == 0:
                assert all(torch.equal(state[k][:, s], before[k][:, s]) for k in state), s
        pos += C if tl is None else tl
    for k in state:
        _close(state[k], rstate[k])


# -- the engine on the reference's fixtures ------------------------------------------


def _engines(m, kw, packed: bool):
    rp, tp = (m["rpk"], m["tpk"]) if packed else (m["rp"], m["tp"])
    kw = dict(kw, packed_head=packed, head_bits=(4, 4))
    reng = ref_build_engine(m["rcfg"], RefEngineConfig(**kw), params=rp,
                            head=m["rhead"] if packed else None)
    peng = build_engine(m["cfg"], EngineConfig(**kw), params=tp, head=m["thead"] if packed else None,
                        device="cpu")
    return reng, peng


def _count_resets(eng) -> list:
    """The slots :meth:`Engine._reset_slot` zeroed, in call order."""
    calls, inner = [], eng._reset_slot

    def counted(slot):
        calls.append(slot)
        inner(slot)

    eng._reset_slot = counted
    return calls


def _serve_both(reng, peng, prompts, max_new):
    """Serve ``prompts`` (``max_new[i]`` new tokens for prompt ``i``) on the
    reference's engine and then the port's: both runs' metrics, their
    sampled rows and the port's requests."""
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    ms = []
    build.reset_counts()
    for eng in (reng, peng):
        reqs = [eng.submit(p, n) for p, n in zip(prompts, max_new)]
        ms.append(eng.run(realtime=False))
    assert build.counts() == dict.fromkeys(build.COUNTS, 0)  # the CPU runs the plain versions
    return ms, rrec, prec, reqs


def test_engine_completes_and_leaks_nothing(mamba):
    """tests/test_serving.py test_engine_completes_and_leaks_nothing at
    arch="mamba2-130m": 5 requests through 3 slots, every request ``ok``
    with its tokens, no leaks, steps equal and rows within ATOL of the
    reference engine's; every admission resets its slot."""
    kw = dict(n_slots=3, page_size=4, max_len=32)
    reng, peng = _engines(mamba, kw, packed=False)
    resets = _count_resets(peng)
    lens = [2, 5, 7, 3, 6]
    prompts = _prompts(jax.random.PRNGKey(1), len(lens), lens, mamba["cfg"].vocab)
    (rm, m), rrec, prec, reqs = _serve_both(reng, peng, prompts, [3 + i for i in range(len(lens))])
    assert m["statuses"] == {"ok": len(lens)} and m["steps"] == rm["steps"]
    for r in reqs:
        assert len(r.out_tokens) == r.max_new_tokens
        assert r.t_finish is not None and r.pages == [] and r.slot == -1
    assert len(resets) == len(lens)
    _check_streams(reng, peng, rrec, prec)
    peng.assert_no_leaks()


def test_chunked_engine_token_identical_to_greedy_reference(mamba, monkeypatch):
    """tests/test_serving.py test_chunked_engine_token_identical_to_reference
    at arch="mamba2-130m": chunked prefill (C = 4) through 2 slots emits the
    reference's unpaged greedy stream, token for token (its monolithic
    decode step jitted, as the reference's engine runs its step)."""
    import diffcheck

    rcfg, decode = mamba["rcfg"], RT.forward_decode
    jitted = jax.jit(lambda p, cache, tok, pos, head: decode(p, rcfg, cache, tok, pos, head=head))
    monkeypatch.setattr(RT, "forward_decode", lambda p, cfg, cache, tok, pos, head=None: (
        jitted(p, cache, tok, pos, head) if cfg is rcfg else decode(p, cfg, cache, tok, pos, head=head)))

    kw = dict(n_slots=2, page_size=4, max_len=32, chunk_tokens=4)
    peng = build_engine(mamba["cfg"], EngineConfig(**kw), params=mamba["tp"], device="cpu")
    prompts = _prompts(jax.random.PRNGKey(9), 3, [9, 5, 11], mamba["cfg"].vocab)
    reqs = [peng.submit(p, 5) for p in prompts]
    m = peng.run(realtime=False)
    assert m["statuses"] == {"ok": 3}
    for req, prompt in zip(reqs, prompts):
        assert req.out_tokens == diffcheck.greedy_decode_reference(mamba["rp"], mamba["rcfg"], None, prompt, 5)
    assert m["fed_tokens"] > m["steps"]  # prefill really was chunked


# tests/test_serving.py test_forced_preemption_resumes_token_identical at
# arch="mamba2-130m": 5 usable pages of 4 tokens for 3 requests of worst case
# 4-5 pages each, so the on-demand engine preempts and replays chunked
FIXTURE = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand")


@pytest.mark.parametrize("weights", ["float", "packed"])
def test_forced_preemption_matches_reference(mamba, weights):
    """The PRNGKey(7) prompts of 9, 6 and 11 tokens, 6 new each: the engine
    preempts; steps, tokens fed and preemptions equal the reference
    engine's, every sampled row agrees to ATOL and the tokens up to the tie
    bound; one reset per admission, re-admissions included.  ``packed``:
    w4a4 projections and the packed (4, 4) head."""
    reng, peng = _engines(mamba, FIXTURE, packed=weights == "packed")
    resets = _count_resets(peng)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], mamba["cfg"].vocab)
    (rm, m), rrec, prec, _ = _serve_both(reng, peng, prompts, [6] * 3)
    assert m["statuses"] == {"ok": 3}
    assert m["preemptions"] > 0, "the undersized pool must force preemption"
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m[key] == rm[key], key
    assert len(resets) == 3 + m["preemptions"]
    _check_streams(reng, peng, rrec, prec)
    peng.assert_no_leaks()


def test_a_skipped_reset_is_caught(mamba):
    """The forced-preemption run with the reset skipped on re-admission (a
    planted fault): a replayed request starts from the stale state its slot
    holds, which decays over the replayed prefix but leaves rows outside
    ATOL of the reference's, so the check of the test above rejects it."""
    reng, peng = _engines(mamba, FIXTURE, packed=False)
    seen: set = set()
    inner = peng._reset_slot

    def first_only(slot):  # re-admissions of a request skip their reset
        rid = next(r.rid for r in peng.scheduler.active.values() if r.slot == slot)
        if rid not in seen:
            seen.add(rid)
            inner(slot)

    peng._reset_slot = first_only
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], mamba["cfg"].vocab)
    (_, m), rrec, prec, _ = _serve_both(reng, peng, prompts, [6] * 3)
    assert m["preemptions"] > 0
    with pytest.raises(AssertionError):
        _check_streams(reng, peng, rrec, prec)


# -- a mixed deployment plan ----------------------------------------------------------


def test_mixed_plan_serves_and_matches_reference(mamba):
    """tests/test_plan.py test_mixed_plan_ssm_family_serves_and_matches_monolithic
    through the port: a (2, 2) / (5, 3) plan; the port's ``apply_plan``
    gives the reference's per-layer placements and bits, with levels within
    one of the reference's; on the reference's applied words the paged
    forward matches the reference's for 5 steps and the engine completes
    the reference's 2 requests with the reference engine's rows."""
    rcfg, cfg = mamba["rcfg"], mamba["cfg"]
    rplan = RP.plan_from_bits(rcfg, arch=ARCH, bits=[(2, 2), (5, 3)])
    plan = P.plan_from_bits(cfg, arch=ARCH, bits=[(2, 2), (5, 3)])
    assert plan.content_hash() == rplan.content_hash() and not plan.uniform
    applied, head = P.apply_plan(mamba["tp"], cfg, plan, device="cpu")
    rapplied, rhead = RP.apply_plan(mamba["rp"], rcfg, rplan, verbose=False)
    carried, chead = params_from_jax(_np(rapplied)), packed_from_jax(_np(rhead))
    assert isinstance(applied["layers"], list) and isinstance(carried["layers"], list)
    for i, lp in enumerate(plan.layers):
        for k in ("in_z", "in_xbc", "out_proj"):
            a, b = applied["layers"][i][k]["w"], carried["layers"][i][k]["w"]
            assert (a.w_bits, a.a_bits) == (b.w_bits, b.a_bits) == (lp.w_bits, lp.a_bits), (i, k)
            assert a.cfg == b.cfg and a.block_k == b.block_k and a.data.shape == b.data.shape, (i, k)
        assert isinstance(applied["layers"][i]["in_dt"]["w"], torch.Tensor)
    assert (head.w_bits, head.a_bits, head.cfg) == (chead.w_bits, chead.a_bits, chead.cfg)
    # the paged forward on the carried words, 5 steps at C = 1
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    rstate = RT.init_paged_state(rcfg, 2, 9, 4, dtype=jnp.float32)
    state = T.init_paged_state(cfg, 2, 9, 4, dtype=torch.float32, device="cpu")
    tbl = np.zeros((2, 4), np.int32)
    ref_step = jax.jit(lambda p, st, tok, pos: RT.forward_decode_paged(p, rcfg, st, jnp.asarray(tbl), tok, pos))
    for t in range(toks.shape[1]):
        pos = np.full((2,), t, np.int32)
        rlog, rstate = ref_step(rapplied, rstate, jnp.asarray(toks[:, t : t + 1]), jnp.asarray(pos))
        logits, _ = T.forward_decode_paged(carried, cfg, state, torch.from_numpy(tbl),
                                           torch.from_numpy(toks[:, t : t + 1]), torch.from_numpy(pos))
        _close(logits, rlog)
    kw = dict(n_slots=2, page_size=4, max_len=16)
    reng = ref_build_engine(rcfg, RefEngineConfig(**kw), params=rapplied, head=rhead)
    peng = Engine(cfg, carried, EngineConfig(**kw), head=chead, device="cpu")
    prompts = [jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(1), i), (n,), 1, cfg.vocab).tolist()
               for i, n in enumerate((3, 4))]
    (rm, m), rrec, prec, _ = _serve_both(reng, peng, prompts, [2, 2])
    assert m["n_requests"] == 2 and m["generated_tokens"] == 4 and m["steps"] == rm["steps"]
    _check_streams(reng, peng, rrec, prec)
