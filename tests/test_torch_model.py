"""The port's decode layers, paged forward and serving engine against the
JAX reference, on the CPU, at the llama3.2-3b smoke size.

Both packages run on identical weights and identical packed words: the
reference's params (and its prepacked projections and LM head) cross
over through :mod:`repro_torch.bridge`.  Layers compare at float32.

Tolerance: outputs agree to ``ATOL`` (float32 rounding: RoPE's cos/sin
and the sum orders of XLA and PyTorch differ in the last bits).  The one
allowed source of a larger error is an activation level flip: the packed
path quantizes ``sigmoid(x)`` to 4-bit levels, and an ulp difference of
``sigmoid``/``tanh`` between XLA and PyTorch moves a value across a
rounding boundary only when it sits within an ulp of it, which these
seeds do not hit; a flip would show as an error of one level step
(``w_scale * a_scale`` times a weight level, about 0.01 to 0.1).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.paged_gather import ref as ref_pg
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import build_engine as ref_build_engine
from repro.serving.api import quantize_params_packed as ref_quantize_packed
from repro_torch.bridge import packed_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, build_engine

ATOL = 1e-4
ARCH = "llama3.2-3b"


def _cfgs(dtype: str):
    ref = dataclasses.replace(ref_get_config(ARCH, smoke=True), dtype=getattr(jnp, dtype))
    ours = dataclasses.replace(get_config(ARCH, smoke=True), dtype=getattr(torch, dtype))
    return ref, ours


@pytest.fixture(scope="module")
def shared():
    """Reference params (float and w4a4-packed) and the (4, 4) packed head,
    with their port twins."""
    rcfg, cfg = _cfgs("float32")
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rpk = ref_quantize_packed(rp, w_bits=4, a_bits=4, verbose=False)
    rhead = RL.prepack_lm_head(rp["embed"], w_bits=4, a_bits=4)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(
        rcfg=rcfg, cfg=cfg, rp=rp, rpk=rpk, rhead=rhead,
        tp=params_from_jax(to_np(rp)), tpk=params_from_jax(to_np(rpk)),
        thead=packed_from_jax(to_np(rhead)),
    )


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(ours.to(torch.float32).numpy(), np.asarray(theirs, np.float32),
                               rtol=0, atol=ATOL)


def _gather_ops(int8: bool, window: int):
    case = ref_pg.GatherCase(n_slots=4, n_blocks=4, page_size=8, width=32, window=window,
                             int8=int8, inactive_slots=1, seed=window + int8)
    return ref_pg.make_operands(case)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
@pytest.mark.parametrize("gather", ["xla", "kernel"])
@pytest.mark.parametrize("int8,window", [(False, 0), (False, 5), (True, 0)])
def test_attention_decode_paged_matches_reference(shared, packed, gather, int8, window):
    rcfg, cfg = shared["rcfg"], shared["cfg"]
    rl = jax.tree.map(lambda a: a[0], (shared["rpk"] if packed else shared["rp"])["layers"])
    tl = T.layer_params((shared["tpk"] if packed else shared["tp"])["layers"], 0)
    ops = _gather_ops(int8, window)
    x = np.random.default_rng(7).normal(size=(4, 1, cfg.d_model)).astype(np.float32)
    scales = {}
    if int8:
        scales = dict(pool_k_scale=ops["k_scale"], pool_v_scale=ops["v_scale"])
    res = RL.attention_decode_paged(
        rl["attn"], rcfg.attn_spec(), jnp.asarray(x), jnp.asarray(ops["pool_k"]),
        jnp.asarray(ops["pool_v"]), jnp.asarray(ops["block_table"]), jnp.asarray(ops["pos"]),
        window=window, gather=gather, **{k: jnp.asarray(v) for k, v in scales.items()},
    )
    pools = {k: torch.from_numpy(np.array(ops[k])) for k in ("pool_k", "pool_v")}
    tscales = {k: torch.from_numpy(np.array(v)) for k, v in scales.items()}
    out = L.attention_decode_paged(
        tl["attn"], cfg.attn_spec(), torch.from_numpy(x), pools["pool_k"], pools["pool_v"],
        torch.from_numpy(ops["block_table"]), torch.from_numpy(ops["pos"]), window=window,
        gather=gather, **tscales,
    )
    _close(out, res[0])
    # the in-place pool writes equal the reference's returned pools
    if int8:
        # a level may differ by one where a row's float32 value sits on a
        # rounding boundary of its int8 quantization
        for ours, theirs in zip((pools["pool_k"], pools["pool_v"]), res[1:3]):
            diff = np.abs(ours.numpy().astype(np.int32) - np.asarray(theirs, np.int32))
            assert diff.max() <= 1
        _close(tscales["pool_k_scale"], res[3])
        _close(tscales["pool_v_scale"], res[4])
    else:
        _close(pools["pool_k"], res[1])
        _close(pools["pool_v"], res[2])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
def test_mlp_and_head_match_reference(shared, packed):
    rcfg, cfg = shared["rcfg"], shared["cfg"]
    rl = jax.tree.map(lambda a: a[1], (shared["rpk"] if packed else shared["rp"])["layers"])
    tl = T.layer_params((shared["tpk"] if packed else shared["tp"])["layers"], 1)
    x = np.random.default_rng(8).normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    _close(L.mlp(tl["mlp"], cfg.mlp_spec(), torch.from_numpy(x)),
           RL.mlp(rl["mlp"], rcfg.mlp_spec(), jnp.asarray(x)))
    rhead, thead = (shared["rhead"], shared["thead"]) if packed else (None, None)
    _close(T.head_paged(shared["tp"], cfg, torch.from_numpy(x), head=thead),
           RT.head_paged(shared["rp"], rcfg, jnp.asarray(x), head=rhead))


@pytest.mark.parametrize("gather", ["xla", "kernel"])
def test_forward_decode_paged_steps_match_reference(shared, gather):
    """A few decode steps on identical packed words: logits and pools."""
    rcfg, cfg = shared["rcfg"], shared["cfg"]
    S, nb, ps = 3, 4, 8
    rstate = RT.init_paged_state(rcfg, S, S * nb + 1, ps, dtype=jnp.float32)
    state = T.init_paged_state(cfg, S, S * nb + 1, ps, dtype=torch.float32, device="cpu")
    table = np.zeros((S, nb), np.int32)
    table[0, :2], table[1, :1] = [1, 2], [3]  # slot 2 stays inactive (null page)
    rng = np.random.default_rng(9)
    for step in range(4):
        tokens = rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32)
        pos = np.array([step + 5, step, 0], np.int32)
        rlog, rstate = RT.forward_decode_paged(
            shared["rpk"], rcfg, rstate, jnp.asarray(table), jnp.asarray(tokens), jnp.asarray(pos),
            head=shared["rhead"], gather=gather)
        logits, state = T.forward_decode_paged(
            shared["tpk"], cfg, state, torch.from_numpy(table), torch.from_numpy(tokens),
            torch.from_numpy(pos), head=shared["thead"], gather=gather)
        _close(logits, rlog)
    _close(state["k"][:, 1:], np.asarray(rstate["k"])[:, 1:])  # page 0 holds garbage
    _close(state["v"][:, 1:], np.asarray(rstate["v"])[:, 1:])


# -- engine parity --------------------------------------------------------------

# a reference top-2 logit gap under this bound may flip the greedy token:
# logits agree to ATOL unless an activation level flips (see the module
# docstring), and one flip moves a logit by at most about 0.1
TIE_BOUND = 0.25


def _recording(eng, ref: bool):
    """Keep every sampled logits row of an engine's run, keyed by (request
    id, index of the sampled token).  The port's engine hands them to its
    ``on_sample`` hook; the reference's step is wrapped: a request sampled
    in a step when its token count grew, from the row of the slot it held
    in its replica (a step calls ``_step`` once a replica, or once with
    every replica's ``[dp, S, V]`` logits on a mesh)."""
    rec = {}
    if not ref:
        eng.on_sample = lambda rid, t, row: rec.__setitem__((rid, t), row.copy())
        return rec
    calls = []
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


@pytest.mark.parametrize("packed_head", [True, False], ids=["packed-head", "float-head"])
def test_engine_token_streams_match_reference(shared, packed_head):
    """w4a4 packed projections, (4, 4) packed head or the float head,
    gather_backend="kernel", 6 requests through 4 slots."""
    rcfg, cfg = shared["rcfg"], shared["cfg"]
    kw = dict(n_slots=4, page_size=8, max_len=64, packed_head=packed_head,
              head_bits=(4, 4), gather_backend="kernel")
    reng = ref_build_engine(rcfg, RefEngineConfig(**kw), params=shared["rpk"],
                            head=shared["rhead"] if packed_head else None)
    peng = build_engine(cfg, EngineConfig(**kw), params=shared["tpk"],
                        head=shared["thead"] if packed_head else None, device="cpu")
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, int(rng.integers(3, 13))).tolist() for _ in range(6)]
    build.reset_counts()
    for eng in (reng, peng):
        for p in prompts:
            eng.submit(p, 8)
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 6}
    assert build.counts() == dict.fromkeys(build.COUNTS, 0)
    ref_out = {r.rid: r.out_tokens for r in reng.finished}
    out = {r.rid: r.out_tokens for r in peng.finished}
    for rid, theirs in ref_out.items():
        ours = out[rid]
        div = next((t for t in range(len(theirs)) if ours[t] != theirs[t]), None)
        for t in range(len(theirs) if div is None else div + 1):
            np.testing.assert_allclose(prec[(rid, t)], rrec[(rid, t)], rtol=0, atol=ATOL)
        if div is not None:
            top2 = np.sort(rrec[(rid, div)])[-2:]
            assert top2[1] - top2[0] < TIE_BOUND, (rid, div, top2)
