"""The port's training forward against the reference's, on the CPU: the
QAT quantizers (``fake_quant_weight``, ``fake_quant_act``, ``ste_round``),
QAT ``dense``, ``mamba_train``, ``ce_loss_chunked`` and ``forward_train``
with every gradient leaf, for all 10 archs at their smoke sizes.

Both packages run on identical weights: the reference's
``init_params(PRNGKey(0))`` tree crosses over through
:mod:`repro_torch.bridge`; configs run at float32 and batches are made
with numpy from a seed.

Tolerances: losses within ``LOSS_RTOL`` relative; each gradient leaf
within ``GRAD_RTOL`` relative L2, except a leaf whose reference gradient
is below ``NOISE_SHARE`` of the whole gradient's norm: analytically zero
(a top-1 router's gates renormalize to exactly 1), it is rounding noise
of a cancellation on both sides and is held within ``NOISE_SHARE`` of the
whole gradient's norm, absolute.

QAT: a 4-bit activation level is decided by ``round(15 sigmoid(x))``, and
XLA's and PyTorch's float32 sums differ in the last bits, so where
``15 sigmoid(x)`` falls within rounding of a half-integer the two
packages pick different levels (a flip), and every later layer sees it.
The QAT cases therefore record the reference's quantizer inputs (a
``jax.debug.callback``) and feed each to the port's quantizer at the
matching call (a straight-through substitution: the value is the
reference's, the gradient the port's), so that both sides quantize the
same activations;
each port input must lie within ``ACT_ATOL`` of the reference's, and
each level the port's own input would have chosen differently must sit
within ``BOUNDARY`` of a level boundary.  Weight levels are the port's
own (no substitution).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.core import quant as RQ
from repro.models import mamba as RM
from repro.models import moe as RX
from repro.models import transformer as RT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import quant as Q
from repro_torch.core.quant import fake_quant as FQ
from repro_torch.launch import mesh as LM
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as X
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as PS

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
NOISE_SHARE = 1e-6
ACT_ATOL = 1e-5
BOUNDARY = 1e-4
B, S = 2, 16
PROJ = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_up", "mlp_gate", "mlp_down", "ssm_in", "ssm_dt", "ssm_out",
        "xattn_q", "xattn_k", "xattn_v", "xattn_o")
W4A4 = {name: (4, 4) for name in PROJ}


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


def _cfgs(arch: str, qat: bool = False, **fields):
    """Both configs at float32 (QAT at w4a4 on every projection), ``fields``
    replaced on both."""
    return (dataclasses.replace(ref_get_config(arch, smoke=True), dtype=jnp.float32,
                                quant=RL.QuantConfig(bits=W4A4) if qat else RL.NO_QUANT, **fields),
            dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32,
                                quant=L.QuantConfig(bits=W4A4) if qat else L.NO_QUANT, **fields))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return _np(RT.init_params(jax.random.PRNGKey(0), _cfgs(arch)[0]))


def _batch(cfg, seed: int = 0, s: int = S) -> dict:
    g = np.random.default_rng(seed)
    b = {"tokens": g.integers(0, cfg.vocab, (B, s)).astype(np.int32),
         "labels": g.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.use_mrope:  # three distinct streams
        pos = np.stack([np.arange(s), np.arange(s) // 2, np.arange(s) % 3], axis=-1)
        b["positions"] = np.broadcast_to(pos[None], (B, s, 3)).astype(np.int32).copy()
    if cfg.family == "encdec":
        b["enc_embeds"] = g.normal(size=(B, s // 2, cfg.d_model)).astype(np.float32)
    return b


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def ref_loss_grads(rcfg, rp, batch, record: list | None = None):
    """The reference's loss and gradients (jitted); with ``record``, each
    ``fake_quant_act`` input in call order (forward only)."""
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if record is None:
        loss, grads = jax.jit(jax.value_and_grad(lambda p: RT.forward_train(p, rcfg, batch)))(rp)
        return float(loss), _flat(_np(grads))
    inner = RL.fake_quant_act

    def recording(x, bits):
        jax.debug.callback(lambda v: record.append(np.array(v)), x, ordered=True)
        return inner(x, bits)

    RL.fake_quant_act = recording
    try:
        loss, grads = jax.jit(jax.value_and_grad(lambda p: RT.forward_train(p, rcfg, batch)))(rp)
        jax.effects_barrier()
    finally:
        RL.fake_quant_act = inner
    return float(loss), _flat(_np(grads))


def port_loss_grads(cfg, rp, batch, ref_acts: list | None = None, own: list | None = None):
    """The port's loss and gradients on the bridged ``rp``; with
    ``ref_acts``, each ``fake_quant_act`` call quantizes the reference's
    input at that call (its own input is appended to ``own``)."""
    params = params_from_jax(rp)
    for leaf in _flat(params).values():
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    inner = L.fake_quant_act
    if ref_acts is not None:
        def substituted(x, bits):
            mine = x.detach().numpy().copy()
            r = min((r for r in ref_acts if r.shape == mine.shape), key=lambda r: np.abs(r - mine).max())
            own.append((r, mine))
            return inner(x + (torch.from_numpy(r) - x).detach(), bits)

        L.fake_quant_act = substituted
    try:
        loss = T.forward_train(params, cfg, tb)
        loss.backward()
    finally:
        L.fake_quant_act = inner
    return float(loss), {k: v.grad.numpy() for k, v in _flat(params).items()}


def check_loss_grads(rl: float, rg: dict, pl: float, pg: dict) -> None:
    assert abs(pl - rl) <= LOSS_RTOL * abs(rl), (pl, rl)
    assert set(pg) == set(rg)
    total = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in rg.values()))
    for k, g in rg.items():
        ref_norm, err = np.linalg.norm(g), np.linalg.norm(pg[k] - g)
        if ref_norm < NOISE_SHARE * total:
            assert err <= NOISE_SHARE * total, (k, err, ref_norm, total)
        else:
            assert err <= GRAD_RTOL * ref_norm, (k, err / ref_norm)


def check_act_levels(ref_acts: list, own: list, bits: int = 4) -> int:
    """Every port quantizer input within ACT_ATOL of the reference's input
    at the same call, and each level flip at a boundary; returns the
    flips."""
    assert len(own) >= len(ref_acts) > 0
    n, flips = (1 << bits) - 1, 0
    for r, p in own:
        assert np.abs(r - p).max() <= ACT_ATOL
        rv, pv = np.clip(r, 0, 1) * n, np.clip(p, 0, 1) * n
        differ = np.round(rv) != np.round(pv)
        flips += int(differ.sum())
        assert np.all(np.abs(rv[differ] - np.floor(rv[differ]) - 0.5) <= BOUNDARY)
    return flips


def _train_case(arch: str, qat: bool, **fields):
    """(reference loss, grads), (port loss, grads) and the flips of one
    forward_train + backward.  QAT runs with remat off (the substitution
    feeds the quantizer calls in forward order; remat is held apart)."""
    rcfg, cfg = _cfgs(arch, qat, **({"remat": False} if qat else {}), **fields)
    rp, batch = _ref_params(arch), _batch(rcfg)
    if not qat:
        return ref_loss_grads(rcfg, rp, batch), port_loss_grads(cfg, rp, batch), 0
    ref_acts, own = [], []
    ref = ref_loss_grads(rcfg, rp, batch, record=ref_acts)
    port = port_loss_grads(cfg, rp, batch, ref_acts=ref_acts, own=own)
    return ref, port, check_act_levels(ref_acts, own)


# -- quantizers ------------------------------------------------------------------------


def ref_vjp(fn, primals: tuple, cot):
    """The reference's ``fn(*primals)`` and its cotangents for ``cot``, jitted."""
    def run(primals, cot):
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(cot)

    return jax.jit(run)(primals, jnp.asarray(cot))


def _ref_value_grad(fn, x, cot):
    """Eager (op by op): under jit XLA turns ``/ n`` into ``* (1 / n)``,
    one ulp off the eager value that the port's quantizer reproduces."""
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(cot))[0])


def _port_value_grad(fn, x, cot):
    t = torch.from_numpy(x).requires_grad_(True)
    y = fn(t)
    y.backward(torch.from_numpy(cot))
    return y.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("bits", [2, 4, 8, 32])
def test_fake_quant_act_values_and_gradients(bits):
    """Values and straight-through gradients, with inputs at exactly 0 and
    1, where ``jnp.clip`` passes half the gradient (``torch.clamp`` would
    pass all of it), past both ends, and at level midpoints."""
    g = np.random.default_rng(bits)
    x = np.concatenate([[0.0, 1.0, -0.5, 1.5, 0.5 / 15, 7.5 / 15],
                        g.uniform(-0.2, 1.2, 250)]).astype(np.float32)
    cot = g.normal(size=x.shape).astype(np.float32)
    ry, rgrad = _ref_value_grad(lambda v: RQ.fake_quant_act(v, bits), x, cot)
    py, pgrad = _port_value_grad(lambda v: Q.fake_quant_act(v, bits), x, cot)
    np.testing.assert_array_equal(py, ry)
    np.testing.assert_array_equal(pgrad, rgrad)
    if bits < 32:
        np.testing.assert_allclose(pgrad[:4], [0.5 * cot[0], 0.5 * cot[1], 0.0, 0.0], rtol=1e-6)


@pytest.mark.parametrize("bits", [2, 3, 4, 8, 32])
def test_fake_quant_weight_values_and_gradients(bits):
    g = np.random.default_rng(10 + bits)
    w = (g.normal(size=(48, 40)) * 0.3).astype(np.float32)
    cot = g.normal(size=w.shape).astype(np.float32)
    ry, rgrad = _ref_value_grad(lambda v: RQ.fake_quant_weight(v, bits), w, cot)
    py, pgrad = _port_value_grad(lambda v: Q.fake_quant_weight(v, bits), w, cot)
    np.testing.assert_allclose(py, ry, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pgrad, rgrad, rtol=1e-5, atol=1e-6)


def test_tied_max_splits_its_gradient_as_the_reference():
    """``max|tanh(w)|`` tied at three entries (two signs): the gradient
    through the normalizer is split evenly among them in both packages."""
    w = np.array([0.3, 1.25, 1.25, -1.25, 0.0, -0.7], np.float32)
    cot = np.array([1.0, -2.0, 0.5, 3.0, 1.0, -1.0], np.float32)
    for bits in (3, 8):
        ry, rgrad = _ref_value_grad(lambda v: RQ.fake_quant_weight(v, bits), w, cot)
        py, pgrad = _port_value_grad(lambda v: Q.fake_quant_weight(v, bits), w, cot)
        np.testing.assert_allclose(py, ry, rtol=0, atol=1e-7)
        np.testing.assert_allclose(pgrad, rgrad, rtol=1e-6, atol=1e-7)
    # the full-reduction max splits ties evenly (a per-dim amax picks one)
    t = torch.tensor([1.0, 3.0, 3.0, -3.0], requires_grad=True)
    torch.max(torch.abs(t)).backward()
    np.testing.assert_allclose(t.grad.numpy(), [0, 1 / 3, 1 / 3, -1 / 3], rtol=1e-6)


def test_ste_round_is_identity_in_the_backward():
    x = torch.tensor([0.2, 0.5, 1.5, 2.7], requires_grad=True)
    y = Q.ste_round(x)
    y.backward(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    np.testing.assert_array_equal(y.detach().numpy(), [0.0, 0.0, 2.0, 3.0])  # half to even
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, 2.0, 3.0, 4.0])
    np.testing.assert_array_equal(Q.quantize_unit(torch.tensor([0.5, 1 / 30]), 4).numpy(),
                                  np.asarray(RQ.quantize_unit(jnp.asarray([0.5, 1 / 30], jnp.float32), 4)))


@pytest.mark.parametrize("wb,ab", [(4, 4), (2, 3), (8, 8)])
def test_qat_dense_matches_reference(wb, ab):
    g = np.random.default_rng(wb * 10 + ab)
    w = (g.normal(size=(40, 24)) / np.sqrt(40)).astype(np.float32)
    x = g.normal(size=(3, 5, 40)).astype(np.float32)
    cot = g.normal(size=(3, 5, 24)).astype(np.float32)
    rq, q = RL.QuantConfig(bits={"mlp_up": (wb, ab)}), L.QuantConfig(bits={"mlp_up": (wb, ab)})
    r_out, (rw, rx) = ref_vjp(lambda w_, x_: RL.dense({"w": w_}, x_, name="mlp_up", quant=rq),
                              (jnp.asarray(w), jnp.asarray(x)), cot)
    tw, tx = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(x).requires_grad_(True)
    out = L.dense({"w": tw}, tx, name="mlp_up", quant=q)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(r_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(rw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rx), rtol=1e-5, atol=1e-5)
    # a projection the config does not name stays float
    plain = L.dense({"w": torch.from_numpy(w)}, torch.from_numpy(x), name="attn_q", quant=q)
    np.testing.assert_allclose(plain.numpy(), x @ w, rtol=1e-5, atol=1e-5)


# -- mamba_train ----------------------------------------------------------------------


def _mamba_pair(seq: int, chunk: int, seed: int = 0, a_log_shift: float = 0.0):
    rs = RM.MambaSpec(d_model=32, d_state=8, head_dim=8, chunk=chunk)
    s = M.MambaSpec(d_model=32, d_state=8, head_dim=8, chunk=chunk)
    rp = _np(RM.mamba_init(jax.random.PRNGKey(seed), rs))
    rp["a_log"] = (rp["a_log"] + a_log_shift).astype(np.float32)
    x = np.random.default_rng(seed).normal(size=(2, seq, 32)).astype(np.float32)
    return rs, s, rp, x


def _mamba_port(s, rp, x, cot):
    params = params_from_jax(rp)
    for leaf in _flat(params).values():
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = M.mamba_train(params, s, tx)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), tx.grad.numpy(), {k: v.grad.numpy() for k, v in _flat(params).items()}


@pytest.mark.parametrize("seq,chunk", [(16, 8), (16, 16), (24, 8), (8, 256)])
def test_mamba_train_matches_reference(seq, chunk):
    rs, s, rp, x = _mamba_pair(seq, chunk)
    cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    out, (rgp, rgx) = ref_vjp(lambda p, v: RM.mamba_train(p, rs, v), (rp, jnp.asarray(x)), cot)
    pout, pgx, pgp = _mamba_port(s, rp, x, cot)
    np.testing.assert_allclose(pout, np.asarray(out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pgx, np.asarray(rgx), rtol=1e-4, atol=1e-5)
    for k, g in _flat(_np(rgp)).items():
        assert np.linalg.norm(pgp[k] - g) <= GRAD_RTOL * np.linalg.norm(g) + 1e-7, k


def test_mamba_train_chunk_sizes_agree():
    """The chunked scan is exact algebra: chunks of 4, 8 and 16 give the
    same outputs and gradients up to float32 rounding."""
    outs = []
    for chunk in (4, 8, 16):
        _, s, rp, x = _mamba_pair(16, chunk)
        cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
        outs.append(_mamba_port(s, rp, x, cot))
    for out, gx, gp in outs[1:]:
        np.testing.assert_allclose(out, outs[0][0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(gx, outs[0][1], rtol=1e-4, atol=1e-5)
        for k, g in outs[0][2].items():
            assert np.linalg.norm(gp[k] - g) <= 1e-4 * np.linalg.norm(g) + 1e-7, k
    with pytest.raises(AssertionError, match="divide"):
        _, s, rp, x = _mamba_pair(12, 8)
        M.mamba_train(params_from_jax(rp), s, torch.from_numpy(x))


def test_mamba_train_backward_is_finite_where_the_segment_sums_overflow():
    """A steep decay (``a_log`` + 6: |log a| up to 6400 a token) makes the
    upper triangle's ``exp(seg)`` overflow float32; masking it before the
    ``exp`` keeps the backward free of NaN, as the reference's."""
    rs, s, rp, x = _mamba_pair(32, 32, a_log_shift=6.0)
    cot = np.ones(x.shape, np.float32)
    tp = params_from_jax(rp)
    a = torch.exp(tp["a_log"])
    assert float(a.max()) * 2 > 88.7  # exp of the largest upper-triangle segment would be inf
    pout, pgx, pgp = _mamba_port(s, rp, x, cot)
    assert np.isfinite(pout).all() and np.isfinite(pgx).all()
    assert all(np.isfinite(g).all() for g in pgp.values())
    _, (_, rgx) = ref_vjp(lambda p, v: RM.mamba_train(p, rs, v), (rp, jnp.asarray(x)), cot)
    np.testing.assert_allclose(pgx, np.asarray(rgx), rtol=1e-4, atol=1e-4)


def test_conv1d_causal_matches_reference():
    g = np.random.default_rng(3)
    w, b = g.normal(size=(4, 24)).astype(np.float32), g.normal(size=(24,)).astype(np.float32)
    x = g.normal(size=(2, 9, 24)).astype(np.float32)
    ref = np.asarray(RM._conv1d_causal(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x)))
    out = M._conv1d_causal(torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# -- ce_loss_chunked ------------------------------------------------------------------


@pytest.mark.parametrize("seq,chunk", [(24, 512), (24, 8), (23, 5), (7, 3)])
def test_ce_loss_chunked_matches_reference(seq, chunk):
    """At 23 tokens in chunks of 5 the chunking does not divide: 4 chunks
    of 5 tokens, the last 3 in the divisor only, as in the reference."""
    g = np.random.default_rng(seq + chunk)
    x = g.normal(size=(2, seq, 16)).astype(np.float32)
    emb = (g.normal(size=(40, 16)) * 0.3).astype(np.float32)
    labels = g.integers(0, 40, (2, seq)).astype(np.int32)
    rl, (rgx, rge) = ref_vjp(lambda x_, e_: RT.ce_loss_chunked(x_, e_, jnp.asarray(labels), chunk=chunk),
                             (jnp.asarray(x), jnp.asarray(emb)), np.float32(1.0))
    tx, te = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(emb).requires_grad_(True)
    loss = T.ce_loss_chunked(tx, te, torch.from_numpy(labels), chunk=chunk)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(rl)) <= LOSS_RTOL * abs(float(rl))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rgx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(rge), rtol=1e-5, atol=1e-7)
    n = max(1, seq // min(chunk, seq))
    tail = seq - n * (seq // n)  # tokens past the last chunk: no gradient
    if tail:
        assert np.all(tx.grad.numpy()[:, -tail:] == 0)


# -- forward_train for every arch -----------------------------------------------------


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat-w4a4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_reference(arch, qat):
    """tests/test_archs.py::test_smoke_train_step on both packages: the
    loss and every gradient leaf, float (remat on, the configs' default)
    and with QAT at w4a4 on every projection."""
    ref, port, flips = _train_case(arch, qat)
    check_loss_grads(*ref, *port)
    assert np.isfinite(port[0]) and all(np.isfinite(g).all() for g in port[1].values())


def test_a_dropped_straight_through_term_fails(monkeypatch):
    """A planted fault: ``ste_round`` without its straight-through term,
    so every quantized weight and activation passes no gradient.  The
    loss is unchanged, the gradient check must reject it."""
    monkeypatch.setattr(FQ, "ste_round", lambda x: torch.round(x))
    ref, port, _ = _train_case("llama3.2-3b", qat=True)
    assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    with pytest.raises(AssertionError):
        check_loss_grads(*ref, *port)
    assert np.all(port[1]["layers/attn/wq/w"] == 0)


@pytest.mark.parametrize("arch,remat_block", [("llama3.2-3b", 1), ("llama3.2-3b", 2), ("mamba2-130m", 2),
                                              ("whisper-tiny", 1), ("zamba2-1.2b", 1)])
def test_remat_on_equals_remat_off_bit_for_bit(arch, remat_block):
    """Recomputing each layer (or each group of ``remat_block`` layers) in
    the backward changes no bit of the loss or the gradients on the CPU."""
    _, on = _cfgs(arch, remat=True, remat_block=remat_block)
    _, off = _cfgs(arch, remat=False)
    rp, batch = _ref_params(arch), _batch(on)
    l_on, g_on = port_loss_grads(on, rp, batch)
    l_off, g_off = port_loss_grads(off, rp, batch)
    assert l_on == l_off
    for k in g_off:
        np.testing.assert_array_equal(g_on[k], g_off[k], err_msg=k)


def test_forward_train_refuses_the_mesh_and_needs_the_batch_extras():
    """``zero3_regather`` without a mesh changes nothing (the reference's
    regather is a no-op there); sharded params without mesh rules, and the
    encdec family under them, are refused; the batch extras are needed."""
    _, cfg = _cfgs("llama3.2-3b")
    params = params_from_jax(_ref_params("llama3.2-3b"))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    assert torch.equal(T.forward_train(params, dataclasses.replace(cfg, zero3_regather=True), batch),
                       T.forward_train(params, cfg, batch))
    mesh = LM.make_mesh(2, 2, ["cpu"] * 4)
    rules = PS.ShardingRules(mesh=mesh, batch="data")
    with pytest.raises(TypeError, match="use_rules"):
        T.forward_train(LM.shard_tree(params, PS.param_shardings(params, rules), mesh), cfg, batch)
    _, wcfg = _cfgs("whisper-tiny")
    wparams = params_from_jax(_ref_params("whisper-tiny"))
    with pytest.raises(NotImplementedError, match="port queue 1, item 2"), PS.use_rules(rules):
        T.forward_train(LM.shard_tree(wparams, PS.param_shardings(wparams, rules), mesh), wcfg,
                        {k: torch.from_numpy(v) for k, v in _batch(wcfg).items()})
    for arch, key in (("qwen2-vl-7b", "positions"), ("whisper-tiny", "enc_embeds")):
        _, cfg = _cfgs(arch)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items() if k != key}
        with pytest.raises(KeyError, match=key):
            T.forward_train(params_from_jax(_ref_params(arch)), cfg, batch)


# -- MoE: the overflow case's gradients ------------------------------------------------


def test_moe_overflow_gradients_match_reference():
    """``_local_moe`` at capacity 1.25 over 8 tokens: expert 7's last bucket
    row is overwritten by later zero rows (the reference's serial
    scatter), so the copy kept there passes no gradient; the gradients of
    the tokens and of every expert param equal the reference's (JAX's
    scatter differentiates only the winning writer)."""
    rs = RX.MoESpec(16, 32, n_experts=8, top_k=2, capacity_factor=1.25)
    s = X.MoESpec(16, 32, n_experts=8, top_k=2, capacity_factor=1.25)
    rp = _np(RX.moe_init(jax.random.PRNGKey(0), rs))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 16)))
    cot = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    _, (rgp, rgx) = ref_vjp(lambda p, v: RX._local_moe(p, rs, v, axis_name=None, quant=RX.NO_QUANT),
                            (rp, jnp.asarray(x)), cot)
    params = params_from_jax(rp)
    for leaf in _flat(params).values():
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    X._local_moe(params, s, tx).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rgx), rtol=1e-4, atol=1e-6)
    for k, g in _flat(_np(rgp)).items():
        np.testing.assert_allclose(_flat(params)[k].grad.numpy(), g, rtol=1e-4, atol=1e-6, err_msg=k)
    # the overwritten row's expert sees no gradient from it: expert 7's
    # last bucket row holds ffn(0), whose w_down gradient row is zero
    assert np.abs(_flat(params)["w_down"].grad.numpy()).sum() > 0


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0], ids=["drops", "overflow", "uncapped"])
def test_moe_forward_train_matches_reference_when_copies_drop(cf):
    """qwen3-moe-30b-a3b's smoke forward_train with copies dropped (0.5),
    the overflow capacity (1.25) and none dropped (8.0)."""
    rcfg, cfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=cf)
    rp = _ref_params("qwen3-moe-30b-a3b")
    batch = _batch(rcfg, seed=4)
    check_loss_grads(*ref_loss_grads(rcfg, rp, batch), *port_loss_grads(cfg, rp, batch))
