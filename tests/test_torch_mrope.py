"""qwen2-vl-7b's M-RoPE in the port against the JAX reference, on the CPU,
at the qwen2-vl-7b smoke size (2 layers, d 64, 4 heads of 16, 2 KV heads).

``mrope`` splits the half-dim frequency bands by ``sections`` across the
(temporal, height, width) position streams.  It is held against
``repro.models.layers.mrope`` at distinct streams (t up to 2047, h and w
small, as a vision token's grid position), where a wrong band split or a
wrong stream per band shows:

* **bit for bit** with both sides given the same float32 frequencies
  (the reference's), cosines and sines (numpy in float64, rounded to
  float32): everything but the transcendental functions, which is the
  band split, the stream selection, the rotation and the dtype casts, is
  exact;
* **to ``ATOL``** with each side's own functions: XLA's and PyTorch's
  float32 ``pow``, ``cos`` and ``sin`` differ in the last bit at a few
  entries, and a frequency one ulp off moves the angle by up to
  ``position x 2**-24`` radians (1.2e-4 at position 2047); at head dim
  128 the outputs differ by up to 3.1e-5, at 12 and 16 by 1-2 ulps.

With three equal streams ``mrope`` is the port's ``rope`` bit for bit, so
the paged decode (which feeds one position to all three streams, as the
reference's) cannot tell them apart: the layer, forward and engine tests
below hold the decode path against the reference, and the distinct-stream
tests above hold the band split.

Everything else runs at float32 on the reference's weights and packed
words (:mod:`repro_torch.bridge`): outputs agree to ``ATOL`` (the sum
orders and the rotary functions of XLA and PyTorch differ in the last
bits); engine logits agree to ``ATOL`` up to a request's first token
divergence, which is allowed only where the reference's top-2 gap is
under ``TIE_BOUND`` (one activation-level flip of the packed path moves a
logit by about 0.1 at most).
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
from test_torch_model import ATOL, _recording

from repro.configs import get_config as ref_get_config
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

ARCH = "qwen2-vl-7b"
THETA = 1_000_000.0  # qwen2-vl-7b's rope_theta
SECTIONS = [(2, 1, 1), (3, 2, 2)]  # the default, and an uneven split (the last band takes the rest)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work on one intra-op thread (at the smoke size thread
    hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    ref = dataclasses.replace(ref_get_config(ARCH, smoke=True), dtype=jnp.float32)
    ours = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
    return ref, ours


@pytest.fixture(scope="module")
def qwen():
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


def _close(ours: torch.Tensor, theirs, atol: float = ATOL) -> None:
    np.testing.assert_allclose(ours.to(torch.float32).numpy(), np.asarray(theirs, np.float32),
                               rtol=0, atol=atol)


# -- mrope at distinct streams ------------------------------------------------------------


def _streams(hd: int, seed: int):
    """x [2, 5, 3, hd] and distinct streams [2, 5, 3]: t in [0, 2048), h and
    w in [0, 64)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, 3, hd)).astype(np.float32)
    pos3 = np.stack([rng.integers(0, 2048, (2, 5)), rng.integers(0, 64, (2, 5)),
                     rng.integers(0, 64, (2, 5))], axis=-1).astype(np.int32)
    assert (pos3[..., 0] != pos3[..., 1]).any() and (pos3[..., 1] != pos3[..., 2]).any()
    return x, pos3


def _shared_tables(monkeypatch, half: int, theta: float) -> None:
    """One float32 table of frequencies, cosines and sines for both
    packages: the reference's own frequencies (handed to the port's
    ``rope_freqs``), and cosines and sines from numpy in float64, rounded to
    float32, on both sides."""
    freqs = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half))

    def cos64(a):
        return np.cos(np.asarray(a, np.float64)).astype(np.float32)

    def sin64(a):
        return np.sin(np.asarray(a, np.float64)).astype(np.float32)

    monkeypatch.setattr(jnp, "cos", lambda a: jnp.asarray(cos64(a)))
    monkeypatch.setattr(jnp, "sin", lambda a: jnp.asarray(sin64(a)))
    monkeypatch.setattr(L, "rope_freqs", lambda h, t, device: torch.from_numpy(freqs.copy()))
    monkeypatch.setattr(torch, "cos", lambda a: torch.from_numpy(cos64(a.numpy())))
    monkeypatch.setattr(torch, "sin", lambda a: torch.from_numpy(sin64(a.numpy())))


@pytest.mark.parametrize("sections", SECTIONS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("hd", [12, 16, 128])
def test_mrope_bit_exact_on_shared_tables(monkeypatch, hd, sections):
    """Distinct streams, the same float32 frequencies, cosines and sines on
    both sides: the port's mrope equals the reference's bit for bit."""
    x, pos3 = _streams(hd, seed=hd)
    _shared_tables(monkeypatch, hd // 2, THETA)
    theirs = np.asarray(RL.mrope(jnp.asarray(x), jnp.asarray(pos3), theta=THETA, sections=sections))
    ours = L.mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta=THETA, sections=sections).numpy()
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("sections", SECTIONS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("hd", [12, 16, 128])
def test_mrope_matches_reference(hd, sections):
    """Distinct streams, each side's own pow, cos and sin: to ATOL.
    A planted fault, ``rope`` on the temporal stream in place of ``mrope``,
    misses the reference by far more than the tolerance."""
    x, pos3 = _streams(hd, seed=hd)
    theirs = np.asarray(RL.mrope(jnp.asarray(x), jnp.asarray(pos3), theta=THETA, sections=sections))
    ours = L.mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta=THETA, sections=sections)
    _close(ours, theirs)
    planted = L.rope(torch.from_numpy(x), torch.from_numpy(pos3[..., 0].copy()), theta=THETA).numpy()
    assert np.abs(planted - theirs).max() > 100 * ATOL


def test_mrope_band_bounds_match_reference_split():
    """The band split itself: with the streams (0, 0, 1) only the width
    band rotates, so the unrotated lanes show where each band starts."""
    for hd, sections, want in ((12, (2, 1, 1), (3, 1, 2)), (12, (3, 2, 2), (2, 1, 3)),
                               (128, (2, 1, 1), (32, 16, 16)), (16, (3, 2, 2), (3, 2, 3))):
        half = hd // 2
        x = torch.ones((1, 1, 1, hd))
        for i in range(3):
            pos3 = torch.zeros((1, 1, 3), dtype=torch.int32)
            pos3[..., i] = 1
            moved = L.mrope(x, pos3, theta=THETA, sections=sections)[0, 0, 0, :half] != 1
            r = np.asarray(RL.mrope(jnp.ones((1, 1, 1, hd)), jnp.asarray(pos3.numpy()), theta=THETA,
                                    sections=sections))[0, 0, 0, :half] != 1
            np.testing.assert_array_equal(moved.numpy(), r)
            assert int(moved.sum()) == want[i], (hd, sections, i)


def test_mrope_sections_differ():
    """The reference's tests/test_models.py test_mrope_sections_differ on
    the port, beside the reference's outputs (the same key's x)."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, 4, 1, 12)))
    p_same = np.tile(np.arange(4)[None, :, None], (1, 1, 3)).astype(np.int32)
    p_diff = p_same.copy()
    p_diff[..., 1] = 0
    a = L.mrope(torch.from_numpy(x), torch.from_numpy(p_same))
    b = L.mrope(torch.from_numpy(x), torch.from_numpy(p_diff))
    assert not np.allclose(a.numpy(), b.numpy())
    _close(a, RL.mrope(jnp.asarray(x), jnp.asarray(p_same)))
    _close(b, RL.mrope(jnp.asarray(x), jnp.asarray(p_diff)))


@pytest.mark.parametrize("hd", [12, 16, 128])
def test_mrope_at_equal_streams_is_rope(hd):
    """Three equal streams: mrope is the port's rope bit for bit (so a
    decode-only test, whose streams are equal, cannot tell them apart)."""
    x, pos3 = _streams(hd, seed=100 + hd)
    pos = torch.from_numpy(pos3[..., 0].copy())
    eq = pos[..., None].expand(*pos.shape, 3)
    for sections in SECTIONS:
        assert torch.equal(L.mrope(torch.from_numpy(x), eq, theta=THETA, sections=sections),
                           L.rope(torch.from_numpy(x), pos, theta=THETA))
    # in bf16 too: cos and sin are cast before the rotation, in both
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(L.mrope(xb, eq, theta=THETA), L.rope(xb, pos, theta=THETA))


# -- the decode path ---------------------------------------------------------------------

POS = np.array([5, 17, 29], np.int32)  # slot 0 inside its first page, slot 2 in its fourth
TABLE = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 9]], np.int32)  # 4 blocks of 8
LENS = np.array([4, 1, 3], np.int32)


def _layer(q, packed: bool, i: int):
    rl = jax.tree.map(lambda a: a[i], (q["rpk"] if packed else q["rp"])["layers"])
    return rl, T.layer_params((q["tpk"] if packed else q["tp"])["layers"], i)


def test_config_and_spec_mirror_the_reference(qwen):
    rcfg, cfg = qwen["rcfg"], qwen["cfg"]
    assert cfg.use_mrope and cfg.attn_spec().use_mrope
    for f in dataclasses.fields(cfg.attn_spec()):
        assert getattr(cfg.attn_spec(), f.name) == getattr(rcfg.attn_spec(), f.name), f.name
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.kv_heads, full.hd, full.d_ff, full.vocab) == (
        28, 3584, 28, 4, 128, 18944, 152064)
    assert full.use_mrope and full.rope_theta == THETA


@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
@pytest.mark.parametrize("C", [1, 4])
def test_attention_decode_paged_matches_reference(qwen, packed, C):
    """Layer 0 at C = 1 (``lens=None``) and a chunk of 4 with per-slot
    ``lens``: the valid lanes' outputs and the pools after the in-place
    writes (page 0, which invalid lanes scatter onto, is not compared)."""
    rcfg, cfg = qwen["rcfg"], qwen["cfg"]
    rl, tl = _layer(qwen, packed, 0)
    rng = np.random.default_rng(20 + C)
    D = cfg.kv_heads * cfg.hd
    pools = {k: rng.normal(size=(10, 8, D)).astype(np.float32) for k in ("pool_k", "pool_v")}
    x = rng.normal(size=(3, C, cfg.d_model)).astype(np.float32)
    lens = None if C == 1 else LENS
    res = jax.jit(lambda p, x, pk, pv, lens: RL.attention_decode_paged(
        p, rcfg.attn_spec(), x, pk, pv, jnp.asarray(TABLE), jnp.asarray(POS), lens=lens))(
        rl["attn"], jnp.asarray(x), jnp.asarray(pools["pool_k"]), jnp.asarray(pools["pool_v"]),
        None if lens is None else jnp.asarray(lens))
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    out = L.attention_decode_paged(
        tl["attn"], cfg.attn_spec(), torch.from_numpy(x), tpools["pool_k"], tpools["pool_v"],
        torch.from_numpy(TABLE), torch.from_numpy(POS), lens=None if lens is None else torch.from_numpy(lens))
    for s in range(3):
        n = C if lens is None else int(lens[s])
        _close(out[s, :n], np.asarray(res[0])[s, :n])
    _close(tpools["pool_k"][1:], np.asarray(res[1])[1:])
    _close(tpools["pool_v"][1:], np.asarray(res[2])[1:])


# slot 0 prefills 11 tokens in chunks of 4, 4, 3, slot 1 12 in chunks of 4,
# slot 2 stays inactive; then both decode a token a step (lens=None)
FWD_CHUNKS = [([0, 0, 0], [4, 4, 0]), ([4, 4, 0], [4, 4, 0]), ([8, 8, 0], [3, 4, 0])]
FWD_DECODE = [[11 + t, 12 + t, 0] for t in range(5)]


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
def test_forward_decode_paged_matches_reference(qwen, packed, C):
    """Both layers, float weights with the float head or w4a4 packed words
    with the packed (4, 4) head: at C = 4 the chunked prefill steps and then
    decode steps, at C = 1 one token a step from position 0; the active
    slots' logits at every step and every live page at the end."""
    rcfg, cfg = qwen["rcfg"], qwen["cfg"]
    S, nb, ps = 3, 6, 4
    rstate = RT.init_paged_state(rcfg, S, S * nb + 1, ps, dtype=jnp.float32)
    state = T.init_paged_state(cfg, S, S * nb + 1, ps, dtype=torch.float32, device="cpu")
    table = np.zeros((S, nb), np.int32)
    table[0], table[1] = np.arange(1, 7), np.arange(7, 13)
    rng = np.random.default_rng(31 + C)
    rp, tp = (qwen["rpk"], qwen["tpk"]) if packed else (qwen["rp"], qwen["tp"])
    rhead, thead = (qwen["rhead"], qwen["thead"]) if packed else (None, None)
    ref_step = jax.jit(lambda p, head, st, tb, tok, pos, lens: RT.forward_decode_paged(
        p, rcfg, st, tb, tok, pos, head=head, lens=lens))
    if C == 4:
        steps = [(4, p, lens) for p, lens in FWD_CHUNKS] + [(1, p, None) for p in FWD_DECODE]
    else:
        steps = [(1, [t, t + 3, 0], None) for t in range(8)]
    for C_, pos, lens in steps:
        tokens = rng.integers(0, cfg.vocab, (S, C_)).astype(np.int32)
        pos = np.array(pos, np.int32)
        lens = None if lens is None else np.array(lens, np.int32)
        rlog, rstate = ref_step(rp, rhead, rstate, jnp.asarray(table), jnp.asarray(tokens),
                                jnp.asarray(pos), None if lens is None else jnp.asarray(lens))
        logits, state = T.forward_decode_paged(
            tp, cfg, state, torch.from_numpy(table), torch.from_numpy(tokens), torch.from_numpy(pos),
            head=thead, lens=None if lens is None else torch.from_numpy(lens))
        _close(logits[:2], np.asarray(rlog)[:2])
    for name in state:
        _close(state[name][:, 1:], np.asarray(rstate[name])[:, 1:])


# -- the engine on the reference's forced-preemption fixture ---------------------------

# tests/test_serving.py test_forced_preemption_resumes_token_identical: 5
# usable pages of 4 tokens for 3 requests of worst case 4-5 pages each
FIXTURE = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, admit="on-demand", chunk_tokens=4)


@pytest.mark.parametrize("weights", ["float", "packed"])
def test_engine_matches_reference_under_preemption(qwen, weights):
    """The fixture's prompts of 9, 6 and 11 tokens from ``PRNGKey(7)``, 8
    new tokens each, C = 4, on demand.  ``float``: float projections and
    the float head; ``packed``: the reference's w4a4 packed words and its
    packed (4, 4) head.  Steps, tokens fed and preemptions equal the
    reference engine's, every sampled row agrees to ATOL and the tokens up
    to the tie bound."""
    rcfg, cfg = qwen["rcfg"], qwen["cfg"]
    packed = weights == "packed"
    kw = dict(FIXTURE, packed_head=packed, head_bits=(4, 4))
    reng = ref_build_engine(rcfg, RefEngineConfig(**kw), params=qwen["rpk" if packed else "rp"],
                            head=qwen["rhead"] if packed else None)
    peng = build_engine(cfg, EngineConfig(**kw), params=qwen["tpk" if packed else "tp"],
                        head=qwen["thead"] if packed else None, device="cpu")
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], cfg.vocab)
    build.reset_counts()
    ms = []
    for eng in (reng, peng):
        for p in prompts:
            eng.submit(p, 8)
        ms.append(eng.run(realtime=False))
    assert build.counts() == dict.fromkeys(build.COUNTS, 0)  # the CPU runs the plain versions
    rm, m = ms
    assert m["statuses"] == {"ok": 3}
    assert m["preemptions"] > 0, "the undersized pool must force preemption"
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m[key] == rm[key], key
    _check_streams(reng, peng, rrec, prec)
    peng.assert_no_leaks()
