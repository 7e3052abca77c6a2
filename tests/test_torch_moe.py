"""MoE with packed experts in the port against the JAX reference, on the
CPU: qwen3-moe-30b-a3b and llama4-scout-17b-a16e at their smoke sizes
(d 64, 8 experts top-2 and 4 experts top-1), and ``MoESpec`` layers of
the reference's tests (d 16, 8 experts).

Both packages run on identical weights and identical packed words: the
reference's params (``init_params(PRNGKey(0))`` or ``moe_init``), its
w4a4-packed experts (``[L, E, K, Np]`` words) and its (4, 4) packed head
cross over through :mod:`repro_torch.bridge`.  Everything runs at float32
on one torch thread.

Tolerances: a MoE layer agrees to ``MOE_ATOL`` (float32 rounding of the
norm, softmax and silu; the routing is exact); the paged forward and the
engine's logits to ``ATOL``, with a request's first token divergence
allowed only on a reference top-2 gap under ``TIE_BOUND``
(``tests/test_torch_chunked.py``).  Integer kernel outputs are bit-exact.

Two behaviours of the reference's dispatch are reproduced and checked
with planted faults: ``jax.lax.top_k``'s order among equal gates (which
``torch.topk`` does not give), and the bucket scatter whose last writer
wins where rows collide (a dispatch without collisions differs).
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
from test_torch_model import _recording

from repro.configs import get_config as ref_get_config
from repro.kernels.packed_matmul import kernel as ref_kernel
from repro.kernels.packed_matmul.ops import choose_config as ref_choose_config
from repro.kernels.packed_matmul.ops import prepack_dense as ref_prepack
from repro.models import layers as RL
from repro.models import moe as RX
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import build_engine as ref_build_engine
from repro.serving.api import quantize_params_int8 as ref_quantize_int8
from repro.serving.api import quantize_params_packed as ref_quantize_packed
from repro_torch.bridge import packed_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.packed_matmul import kernel as K
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.models import moe as X
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, build_engine
from repro_torch.serving.api import quantize_params_int8

ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
ATOL = 1e-4
MOE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work on one intra-op thread (at the smoke size thread
    hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch: str):
    ref = dataclasses.replace(ref_get_config(arch, smoke=True), dtype=jnp.float32)
    ours = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    return ref, ours


@pytest.fixture(scope="module")
def moe_models():
    """Per smoke MoE arch: reference params (float and w4a4-packed, experts
    included) and the (4, 4) packed head, with their port twins."""
    out = {}
    for arch in ARCHS:
        rcfg, cfg = _cfgs(arch)
        rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
        rpk = ref_quantize_packed(rp, w_bits=4, a_bits=4, verbose=False)
        rhead = RL.prepack_lm_head(rp["embed"], w_bits=4, a_bits=4)
        out[arch] = dict(rcfg=rcfg, cfg=cfg, rp=rp, rpk=rpk, rhead=rhead, tp=params_from_jax(_np(rp)),
                         tpk=params_from_jax(_np(rpk)), thead=packed_from_jax(_np(rhead)))
    return out


def _close(ours: torch.Tensor, theirs, atol: float = ATOL) -> None:
    np.testing.assert_allclose(ours.to(torch.float32).numpy(), np.asarray(theirs, np.float32),
                               rtol=0, atol=atol)


def _spec_pair(**kw):
    return RX.MoESpec(16, 32, **kw), X.MoESpec(16, 32, **kw)


# -- config, spec, params -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_moe_spec_mirror_the_reference(arch):
    for smoke in (False, True):
        ref, ours = ref_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        for f in dataclasses.fields(ours):
            if f.name not in ("dtype", "quant"):
                assert getattr(ours, f.name) == getattr(ref, f.name), (smoke, f.name)
        rs, s = ref.moe_spec(), ours.moe_spec()
        assert dataclasses.asdict(s) == dataclasses.asdict(rs), smoke
    full = get_config("qwen3-moe-30b-a3b").moe_spec()
    assert (full.d_model, full.d_ff, full.n_experts, full.top_k, full.capacity_factor) == (
        2048, 768, 128, 8, 1.25)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_layout(moe_models, arch):
    """``init_params``: key for key and shape for shape the reference's
    (``moe`` in place of ``mlp``, stacked ``[L, ...]``), the norm gains
    ones and each tensor at the reference's scale (std 1/sqrt(fan-in))."""
    m = moe_models[arch]
    ours = T.init_params(m["cfg"], seed=0, device="cpu")
    flat = lambda t: {jax.tree_util.keystr(k): v.shape  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(jax.tree.map(lambda a: a.numpy(), ours)) == flat(m["rp"])
    moe, s = ours["layers"]["moe"], m["cfg"].moe_spec()
    assert "mlp" not in ours["layers"] and torch.equal(moe["ln"]["g"], torch.ones(m["cfg"].n_layers, s.d_model))
    for key, fan_in in (("w_up", s.d_model), ("w_gate", s.d_model), ("w_down", s.d_ff)):
        assert abs(float(moe[key].std()) * fan_in ** 0.5 - 1) < 0.05, key
    assert abs(float(moe["router"]["w"].std()) * s.d_model ** 0.5 - 1) < 0.1
    with pytest.raises(NotImplementedError, match="continuous batching supports attn/ssm families"):
        T.init_paged_state(get_config("zamba2-1.2b", smoke=True), 2, 4, 4, device="cpu")


# -- routing ----------------------------------------------------------------------------


def test_top_k_takes_jax_order_among_ties():
    """Planted ties and bf16-rounded router gates (as serving computes
    them): the indices and their order equal ``jax.lax.top_k``'s, which
    ``torch.topk`` does not give (the planted fault this test rejects)."""
    rng = np.random.default_rng(0)
    rows = [np.array([[1, 2, 2, 1, 2, 0.5, 0, 2]], np.float32),
            np.array([[3, 3, 3, 3, 3, 3, 3, 3]], np.float32),
            np.array(jnp.asarray(rng.normal(size=(512, 128)), jnp.bfloat16).astype(jnp.float32))]
    torch_topk_differs = False
    for g in rows:
        k = min(8, g.shape[1] - 1)
        rv, ri = jax.lax.top_k(jnp.asarray(g), k)
        v, i = X.top_k(torch.from_numpy(g), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        torch_topk_differs |= not np.array_equal(torch.topk(torch.from_numpy(g), k).indices.numpy(),
                                                 np.asarray(ri))
    assert torch_topk_differs, "the tie cases no longer tell torch.topk from jax.lax.top_k"


# cases of _local_moe: (capacity factor, tokens); 1.25 at 8 tokens is the
# overflow case: expert 7 full, so its last bucket row is overwritten by
# the later zero rows and the copy kept there reads ffn(0)
LOCAL_CASES = [(8.0, 24), (0.5, 24), (1.25, 8)]


def _local_pair(cf: float, tokens: int):
    rs, s = _spec_pair(n_experts=8, top_k=2, capacity_factor=cf)
    rp = RX.moe_init(jax.random.PRNGKey(0), rs)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (tokens, 16)))
    ref = jax.jit(lambda p, x: RX._local_moe(p, rs, x, axis_name=None, quant=RX.NO_QUANT))(rp, jnp.asarray(x))
    return s, params_from_jax(_np(rp)), x, np.asarray(ref)


@pytest.mark.parametrize("cf,tokens", LOCAL_CASES, ids=["uncapped", "drops", "overflow"])
def test_local_moe_and_moe_apply_match_reference(cf, tokens):
    s, tp, x, ref = _local_pair(cf, tokens)
    _close(X._local_moe(tp, s, torch.from_numpy(x)), ref, MOE_ATOL)
    rs = RX.MoESpec(16, 32, n_experts=8, top_k=2, capacity_factor=cf)
    rp = RX.moe_init(jax.random.PRNGKey(0), rs)
    x3 = x.reshape(2, tokens // 2, 16)
    _close(X.moe_apply(tp, s, torch.from_numpy(x3)),
           jax.jit(lambda p, x: RX.moe_apply(p, rs, x))(rp, jnp.asarray(x3)), MOE_ATOL)
    with pytest.raises(TypeError, match="per-rank lists"):  # the all_to_all path takes every rank's tokens
        X.moe_apply(tp, s, torch.from_numpy(x3), axis_name="model")


def test_a_dispatch_without_collisions_is_caught(monkeypatch):
    """The overflow case with the first writer winning each bucket row (a
    dispatch in which the kept copy is never overwritten): the check above
    rejects it, since the reference's kept copy reads ffn(0)."""
    s, tp, x, ref = _local_pair(1.25, 8)

    def first_wins(n_rows, slot, values, fill):
        pos = torch.arange(slot.shape[0])
        writer = torch.full((n_rows,), slot.shape[0], dtype=torch.long)
        writer = writer.scatter_reduce(0, slot, pos, "amin", include_self=True)
        has = (writer < slot.shape[0]).reshape((n_rows,) + (1,) * (values.ndim - 1))
        return torch.where(has, values[writer.clamp(max=slot.shape[0] - 1)], fill)

    monkeypatch.setattr(X, "_scatter_last", first_wins)
    out = X._local_moe(tp, s, torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() > 0.1
    with pytest.raises(AssertionError):
        _close(torch.from_numpy(out), ref, MOE_ATOL)


def test_moe_reference_matches_uncapped_apply():
    """tests/test_models.py test_moe_matches_reference_when_uncapped in the
    port, and the port's dense oracle against the reference's."""
    rs, s = _spec_pair(n_experts=8, top_k=2, capacity_factor=8.0)
    rp = RX.moe_init(jax.random.PRNGKey(0), rs)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 12, 16)) * 0.5)
    tp, tx = params_from_jax(_np(rp)), torch.from_numpy(x)
    dense = X.moe_reference(tp, s, tx)
    np.testing.assert_allclose(dense.numpy(), X.moe_apply(tp, s, tx).numpy(), rtol=1e-3, atol=1e-4)
    _close(dense, RX.moe_reference(rp, rs, jnp.asarray(x)), MOE_ATOL)


# -- packed experts: the batched kernels' plain versions -----------------------------------


@pytest.mark.parametrize("pair,block_k", [((4, 4), None), ((4, 4), 16), ((3, 2), 24), ((8, 8), None)],
                         ids=["w4a4-K1", "w4a4-K2", "w3a2-K2", "w8a8-plain"])
def test_packed_experts_match_reference_bit_exact(pair, block_k):
    """Expert weights ``[E, K, N]`` prepacked by the reference: the port's
    batched plain K1 (whole K) and K2 (``block_k < K``) against the
    reference's kernels vmapped over experts, integer for integer, and
    ``_expert_matmul``'s float output against the reference's, exactly;
    w8a8 has no placement and takes the batched plain integer matmul."""
    E, C, Kd, N = 4, 3, 40, 24
    rng = np.random.default_rng(sum(pair))
    w = rng.normal(size=(E, Kd, N)).astype(np.float32) / Kd ** 0.5
    x = rng.normal(size=(E, C, Kd)).astype(np.float32)
    rw = ref_prepack(jnp.asarray(w), w_bits=pair[0], a_bits=pair[1], block_k=block_k)
    tw = packed_from_jax(_np(rw))
    assert isinstance(tw, PackedDenseParams) and tw.data.shape[0] == E
    _close(X._expert_matmul(torch.from_numpy(x), tw, torch.float32),
           RX._expert_matmul(jnp.asarray(x), rw, jnp.float32), 0)
    c = ref_choose_config(*pair)
    if c is None:
        assert tw.cfg is None and tw.w_lvl.shape == (E, Kd, N)
        return
    kw = dict(n_seg=c.n_seg, stride=c.stride, acc_chunk=c.acc_chunk, overlap=c.overlap)
    xs = np.array(jax.nn.sigmoid(x))
    if block_k is None:
        ref_acc, ref_sum = jax.vmap(lambda a, b: ref_kernel.packed_dense_fused_raw(
            a, b, a_bits=pair[1], interpret=True, **kw))(jnp.asarray(xs), rw.w_packed)
        acc, a_sum = K.packed_dense_fused_raw(torch.from_numpy(xs), tw.w_packed, a_bits=pair[1], **kw)
        np.testing.assert_array_equal(a_sum.numpy(), np.asarray(ref_sum))
    else:
        lvl = np.round(np.clip(xs, 0, 1) * ((1 << pair[1]) - 1)).astype(np.int32)
        ref_acc = jax.vmap(lambda a, b: ref_kernel.packed_matmul_raw(
            a, b, block_k=block_k, interpret=True, **kw))(jnp.asarray(lvl), rw.w_packed)
        acc = K.packed_matmul_raw(torch.from_numpy(lvl), tw.w_packed, block_k=block_k, **kw)
    assert acc.shape == (E, C, tw.w_packed.shape[-1] * c.n_seg)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))
    # each expert's slice equals the 2-D call on that expert alone
    if block_k is None:
        one, _ = K.packed_dense_fused_raw(torch.from_numpy(xs[2]), tw.w_packed[2], a_bits=pair[1], **kw)
        assert torch.equal(one, acc[2])


@pytest.mark.parametrize("E,M,Kd,Np", [(128, 12, 2048, 192), (128, 1, 768, 512), (16, 1, 5120, 4096),
                                        (16, 12, 5120, 4096), (1, 8, 3072, 1536)])
def test_grid_plan_counts_every_expert_tile(E, M, Kd, Np):
    """``grid_plan`` over E experts counts E x tiles: it splits K only while
    they fill fewer blocks than the counter slot holds (2 x 132 on the
    H100), so every split launch's per-tile counters fit the slot."""
    splits, kps = K.grid_plan(M, Kd, Np, 132, batch=E)
    tiles = E * -(-M // K.BM) * -(-Np // K.BN)
    assert splits * kps >= Kd and (splits - 1) * kps < Kd
    assert (splits > 1) == (tiles < K.BLOCKS_PER_SM * 132)
    assert K.grid_plan(M, Kd, Np, 132) == K.grid_plan(M, Kd, Np, 132, batch=1)


def test_quantize_params_int8_covers_experts(moe_models):
    """``quantize_params_int8`` on the stacked ``[L, E, K, N]`` experts:
    levels and scales bit-exact against the reference's; the router stays
    float as there."""
    m = moe_models["qwen3-moe-30b-a3b"]
    ours = quantize_params_int8(m["tp"])["layers"]["moe"]
    theirs = _np(ref_quantize_int8(m["rp"])["layers"]["moe"])
    for k in ("w_up", "w_gate", "w_down"):
        np.testing.assert_array_equal(ours[k]["levels"].numpy(), theirs[k]["levels"])
        np.testing.assert_array_equal(ours[k]["scale"].numpy(), theirs[k]["scale"])
    assert isinstance(ours["router"]["w"], torch.Tensor) and not isinstance(theirs["router"]["w"], dict)


# -- the paged forward ----------------------------------------------------------------------

# 3 slots, 6 steps; at C = 4 each step's lens per slot (0: inactive)
FWD_LENS = [[4, 1, 0], [4, 1, 0], [3, 1, 2], [1, 1, 4], [1, 0, 4], [1, 1, 1]]


@pytest.mark.parametrize("weights", ["packed", "float"])
@pytest.mark.parametrize("C", [1, 4])
def test_forward_decode_paged_steps_match_reference(moe_models, C, weights):
    """qwen3-moe at its smoke size, both layers over 6 steps, at C = 1
    (lens=None) or C = 4 with per-slot lens: the logits of every slot fed
    a lane at every step, and the K/V pools in place at the end (page 0
    aside).  ``packed``: w4a4 projections and experts, the (4, 4) head."""
    m = moe_models["qwen3-moe-30b-a3b"]
    rcfg, cfg = m["rcfg"], m["cfg"]
    packed = weights == "packed"
    rp, tp = (m["rpk"], m["tpk"]) if packed else (m["rp"], m["tp"])
    rhead, thead = (m["rhead"], m["thead"]) if packed else (None, None)
    S, nb, ps = 3, 8, 4
    rstate = RT.init_paged_state(rcfg, S, S * nb + 1, ps, dtype=jnp.float32)
    state = T.init_paged_state(cfg, S, S * nb + 1, ps, dtype=torch.float32, device="cpu")
    table = 1 + np.arange(S * nb, dtype=np.int32).reshape(S, nb)
    rng = np.random.default_rng(20 + C)
    ref_step = jax.jit(lambda p, head, st, tok, pos, lens: RT.forward_decode_paged(
        p, rcfg, st, jnp.asarray(table), tok, pos, head=head, lens=lens))
    pos = np.zeros(S, np.int32)
    for lens in FWD_LENS:
        tokens = rng.integers(0, cfg.vocab, (S, C)).astype(np.int32)
        tl = None if C == 1 else np.array(lens, np.int32)
        rlog, rstate = ref_step(rp, rhead, rstate, jnp.asarray(tokens), jnp.asarray(pos),
                                None if tl is None else jnp.asarray(tl))
        logits, _ = T.forward_decode_paged(
            tp, cfg, state, torch.from_numpy(table), torch.from_numpy(tokens), torch.from_numpy(pos),
            head=thead, lens=None if tl is None else torch.from_numpy(tl))
        live = np.ones(S, bool) if tl is None else tl > 0
        _close(logits[torch.from_numpy(live)], np.asarray(rlog)[live])
        pos += C if tl is None else tl
    for k in ("k", "v"):
        _close(state[k][:, 1:], np.asarray(rstate[k])[:, 1:])


# -- the engine on the reference's fixtures --------------------------------------------------

# tests/test_serving.py test_forced_preemption_resumes_token_identical's
# fixture: 5 usable pages of 4 tokens for 3 requests of worst case 4-5
# pages each, so the on-demand engine preempts and replays chunked
FIXTURE = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand")


@pytest.mark.parametrize("weights", ["packed", "float"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_under_preemption(moe_models, arch, weights):
    """The PRNGKey(7) prompts of 9, 6 and 11 tokens, 6 new each, on both
    smoke MoE configs: steps, tokens fed and preemptions equal the
    reference engine's, every sampled row agrees to ATOL and the tokens up
    to the tie bound, and no page leaks.  ``packed``: w4a4 projections and
    experts and the packed (4, 4) head."""
    m = moe_models[arch]
    packed = weights == "packed"
    kw = dict(FIXTURE, packed_head=packed, head_bits=(4, 4))
    reng = ref_build_engine(m["rcfg"], RefEngineConfig(**kw), params=m["rpk"] if packed else m["rp"],
                            head=m["rhead"] if packed else None)
    peng = build_engine(m["cfg"], EngineConfig(**kw), params=m["tpk"] if packed else m["tp"],
                        head=m["thead"] if packed else None, device="cpu")
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], m["cfg"].vocab)
    ms = []
    build.reset_counts()
    for eng in (reng, peng):
        for p in prompts:
            eng.submit(p, 6)
        ms.append(eng.run(realtime=False))
    assert build.counts() == dict.fromkeys(build.COUNTS, 0)  # the CPU runs the plain versions
    rm, pm = ms
    assert pm["statuses"] == {"ok": 3} and pm["preemptions"] > 0
    for key in ("steps", "fed_tokens", "preemptions"):
        assert pm[key] == rm[key], key
    _check_streams(reng, peng, rrec, prec)
    peng.assert_no_leaks()
