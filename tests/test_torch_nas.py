"""The port's convnet NAS path against the reference, on the CPU: the
synthetic sets and batches (``data/synthetic.py``), the convnets
(``models/convnets.py``: ``apply`` at fp32 and mixed bits, the detection
head, ``iou``), the super-net (``core/nas/supernet.py``: composite
quantizers, both complexity proxies, ``select_bits``), one search step
with every gradient leaf, ``search`` and ``finetune`` over 5 steps, and
``int_conv_equivalence`` through the plain ``packed_conv1d``.

Both packages run on identical weights: the reference's
``init_params(PRNGKey(.))`` tree crosses over through
``repro_torch.bridge.convnet_params_from_jax`` (HWIO to OIHW), inputs
from NHWC to NCHW.  Small input sizes (VGG-Tiny at 16x16, UltraNet and
SkyNet at 32x64), published widths.

Discrete decisions: XLA's and PyTorch's float32 ``tanh`` and sums differ
in the last bits, so a weight or activation lying within rounding of a
level boundary can take another level (a flip; at 8 bits the levels are
1/255 apart), and a pre-activation within rounding of 0 can pass the
ReLU on one side only (which moves that element's gradient, and a
cancelling weight gradient by percents); every later layer sees either.
So every test records the reference's decisions in call order (each
``fake_quant_act`` input, ``fake_quant_weight`` output and ReLU input; a
``jax.debug.callback``) and hands them to the port at the same call (a
straight-through substitution: the value is the reference's, the gradient
the port's own).  The port's own activation
inputs must lie within ``ACT_ATOL`` of the reference's where either lies
in the quantizer's range [0, 1] (beyond it, both clip; at 8 bits a level
is 40 times as wide), with every level it would choose differently
within that distance of a level boundary; its own weight levels may
differ in at most ``WEIGHT_FLIP_SHARE`` of the elements, one level apart;
its own ReLU mask flips are counted.

Tolerances: losses within ``LOSS_RTOL`` relative, outputs within
``OUT_RTOL`` relative L2, each gradient leaf within ``GRAD_RTOL``
relative L2 (``GRAD_ATOL`` absolute where the reference's leaf is
exactly zero), the architecture logits' within ``ALPHA_GRAD_RTOL``: each
is a softmax Jacobian's difference of whole-tensor sums, seven branches
that nearly cancel; synthetic labels and detection images bit-equal,
classification images bit-equal up to ``hw`` 48 and within ``RESIZE_ATOL``
at 64 (XLA's CPU dot changes its inner loop with the size).
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import nas as RNS
import repro.core.nas.supernet as RS
from repro.core.packing import DSP48E2 as RDSP48E2
from repro.core.packing import build_lut as ref_build_lut
from repro.core.quant import fake_quant as RFQ
from repro.data import synthetic as RD
from repro.models import convnets as RC
from repro_torch.bridge import convnet_params_from_jax, images_from_jax
from repro_torch.core import nas as N
from repro_torch.core.nas import supernet as S
from repro_torch.core.packing import DSP48E2, build_lut
from repro_torch.core.quant import fake_quant as FQ
from repro_torch.core.quant import fake_quant_act, fake_quant_weight
from repro_torch.data import synthetic as D
from repro_torch.kernels.filter_conv.ops import choose_filter_config, packed_conv1d
from repro_torch.models import convnets as C

LOSS_RTOL = 1e-5
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ALPHA_GRAD_RTOL = 1e-3
GRAD_ATOL = 1e-7
ACT_ATOL = 1e-4
WEIGHT_FLIP_SHARE = 1e-3
# finetune's 5 steps at 2-4 bits: Adam's first updates normalise gradients
# that are rounding noise (a channel whose units are all clipped or dead:
# g / (|g| + eps) turns 1e-12 into one learning rate), so the port's own
# params, and with them its own quantizer inputs, move apart between
# steps; a 2-bit activation level is 1/3 wide
ACT_ATOL_STEPS = 2e-2
STEPS_RTOL = 1e-4  # losses, history rows and logits after 5 steps
WEIGHT_FLIP_SHARE_STEPS = 5e-3
RESIZE_ATOL = 1e-6
SIZES = {"vgg_tiny": (16, 16), "ultranet": (32, 64), "skynet": (32, 64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (at these sizes thread hand-offs cost more than
    the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def luts():
    return {k: build_lut(DSP48E2, kernel_len=k, seq_len=32) for k in (1, 3)}


@pytest.fixture(scope="module")
def ref_luts():
    return {k: ref_build_lut(RDSP48E2, kernel_len=k, seq_len=32) for k in (1, 3)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _specs(name: str, hw=None):
    hw = hw or SIZES[name]
    return getattr(RC, name)(in_hw=hw), getattr(C, name)(in_hw=hw)


def _ref_params(rspec, seed: int = 0):
    return _np(RC.init_params(jax.random.PRNGKey(seed), rspec))


def _images(rspec, n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, *rspec.in_hw, 3)).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().numpy().transpose(2, 3, 1, 0)


# -- the tape of discrete decisions ------------------------------------------------------

_JAX_RELU = jax.nn.relu


def _recorders(tape: dict):
    """Reference quantizers and ReLU that record each activation input,
    weight output and ReLU input in call order (under jit too)."""

    def record(kind, v):
        jax.debug.callback(lambda a: tape[kind].append(np.array(a)), v, ordered=True)
        return v

    def quant_a(x, bits):
        return RFQ.fake_quant_act(record("act", x), bits)

    def quant_w(w, bits):
        return record("weight", RFQ.fake_quant_weight(w, bits))

    def relu(x):
        return _JAX_RELU(record("relu", x))

    return quant_w, quant_a, relu


def _substitutes(tape: dict, own: dict):
    """The port's quantizers and ReLU on the reference's recorded values at
    the same call (straight-through: the port's gradient); its own values
    kept in ``own`` beside them.  The ReLU is ``F.relu`` as it stands when
    this is called (a planted fault patches it first)."""
    acts, weights, relus = iter(tape["act"]), iter(tape["weight"]), iter(tape["relu"])
    relu_fn = F.relu

    def quant_a(x, bits):
        r = torch.from_numpy(next(acts)).permute(0, 3, 1, 2)
        own["act"].append((r.numpy(), x.detach().numpy().copy(), bits))
        return fake_quant_act(x + (r - x).detach(), bits)

    def quant_w(w, bits):
        out = fake_quant_weight(w, bits)
        r = torch.from_numpy(next(weights)).permute(3, 2, 0, 1)
        own["weight"].append((r.numpy(), out.detach().numpy().copy(), bits))
        return out + (r - out).detach()

    def relu(x):
        r = torch.from_numpy(next(relus)).permute(0, 3, 1, 2)
        own["relu"].append((int(((x.detach() > 0) != (r > 0)).sum()), x.numel()))
        return relu_fn(x + (r - x).detach())

    return quant_w, quant_a, relu


def _tapes():
    return {"act": [], "weight": [], "relu": []}, {"act": [], "weight": [], "relu": []}


@contextlib.contextmanager
def _taped(tape: dict, own: dict | None = None):
    """The reference's discrete decisions recorded (``own`` None) or the
    port's substituted: each package's ReLU and its super-net's quantizers
    patched; yields ``(quant_w, quant_a)`` for ``apply``'s injection
    points."""
    qw, qa, relu = _recorders(tape) if own is None else _substitutes(tape, own)
    module, functional = (RS, jax.nn) if own is None else (S, F)
    with _patched(module, fake_quant_weight=qw, fake_quant_act=qa), _patched(functional, relu=relu):
        yield qw, qa


def check_levels(tape: dict, own: dict, act_atol: float = ACT_ATOL,
                 weight_share: float = WEIGHT_FLIP_SHARE) -> dict:
    """Every call consumed; the port's own activation inputs within
    ``act_atol`` with flips at boundaries; its own weight levels one level
    off in at most ``weight_share`` of the elements; its own ReLU masks
    counted.  Returns the flips."""
    assert all(len(own[k]) == len(tape[k]) for k in tape), {k: (len(own[k]), len(tape[k])) for k in tape}
    assert tape["weight"] and tape["relu"], "no quantizer or ReLU ran"
    flips = {"act": 0, "weight": 0, "weight_n": 0, "relu": sum(f for f, _ in own["relu"])}
    for r, p, bits in own["act"]:
        if bits >= 32:
            continue
        n = (1 << bits) - 1
        rv, pv = np.clip(r, 0, 1), np.clip(p, 0, 1)
        flips["act_max_abs"] = max(flips.get("act_max_abs", 0.0), float(np.abs(rv - pv).max()))
        assert np.abs(rv - pv).max() <= act_atol
        rv, pv = rv * n, pv * n
        differ = np.round(rv) != np.round(pv)
        flips["act"] += int(differ.sum())
        assert np.all(np.abs(rv[differ] - np.floor(rv[differ]) - 0.5) <= act_atol * n)
    for r, p, bits in own["weight"]:
        step = 2.0 / ((1 << bits) - 1)
        off = np.abs(r - p)
        assert off.max() <= step * 1.01
        flips["weight"] += int((off > step / 2).sum())
        flips["weight_n"] += r.size
    assert flips["weight"] <= weight_share * max(flips["weight_n"], 1), flips
    return flips


@contextlib.contextmanager
def _patched(module, **attrs):
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


# -- synthetic data -------------------------------------------------------------------


@pytest.mark.parametrize("hw", [8, 16, 32, 48, 64])
def test_classification_set_equals_reference(hw):
    rx, ry = RD.classification_set(3, 40, hw=hw)
    x, y = D.classification_set(3, 40, hw=hw)
    assert x.shape == (40, 3, hw, hw) and x.dtype == torch.float32 and y.dtype == torch.int32
    assert np.array_equal(y.numpy(), np.asarray(ry))
    want = np.asarray(rx).transpose(0, 3, 1, 2)
    if hw <= 48:
        assert np.array_equal(x.numpy(), want)
    else:
        assert np.abs(x.numpy() - want).max() <= RESIZE_ATOL


@pytest.mark.parametrize("hw", [(32, 64), (160, 320)])
def test_detection_set_equals_reference(hw):
    n = 24 if hw[0] > 100 else 64
    rx, ry = RD.detection_set(5, n, hw=hw)
    x, y = D.detection_set(5, n, hw=hw)
    assert np.array_equal(x.numpy(), np.asarray(rx).transpose(0, 3, 1, 2))
    assert np.array_equal(y.numpy(), np.asarray(ry))


def test_batches_follow_the_reference_permutation():
    rx, ry = RD.classification_set(0, 70, hw=8)
    x, y = D.classification_set(0, 70, hw=8)
    ref = list(RD.batches(rx, ry, 16, seed=4, epochs=3))
    ours = list(D.batches(x, y, 16, seed=4, epochs=3))
    assert len(ours) == len(ref) == 3 * 4  # the remainder of 70 dropped each epoch
    for (a, b), (c, d) in zip(ref, ours):
        assert np.array_equal(np.asarray(a).transpose(0, 3, 1, 2), c.numpy())
        assert np.array_equal(np.asarray(b), d.numpy())


# -- convnets ---------------------------------------------------------------------------


def test_specs_equal_reference():
    for name in ("ultranet", "skynet", "vgg_tiny"):
        r, p = RC.CONVNETS[name](), C.CONVNETS[name]()
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
        assert [r.op_mul(i) for i in range(len(r.layers))] == [p.op_mul(i) for i in range(len(p.layers))]
    shapes = {k: tuple(v["w"].shape) for k, v in C.init_params(0, C.skynet(), device="cpu").items()}
    ref = {k: v["w"].shape for k, v in jax.eval_shape(lambda k: RC.init_params(k, RC.skynet()), jax.random.PRNGKey(0)).items()}
    assert shapes == {k: (s[3], s[2], s[0], s[1]) for k, s in ref.items()}


@pytest.mark.parametrize("stride,size", [(1, 9), (2, 9), (2, 10), (3, 11)])
def test_conv_pads_as_xla_same(stride, size):
    """XLA's SAME arithmetic at strides ConvSpec admits (the specs use 1)."""
    g = np.random.default_rng(stride)
    x = g.normal(size=(2, size, size + 1, 4)).astype(np.float32)
    w = g.normal(size=(3, 3, 4, 5)).astype(np.float32)
    spec = C.ConvSpec(4, 5, kernel=3, stride=stride)
    ref = RC._conv(jnp.asarray(x), jnp.asarray(w), RC.ConvSpec(4, 5, kernel=3, stride=stride))
    ours = C._conv(images_from_jax(x), torch.from_numpy(w).permute(3, 2, 0, 1), spec)
    assert ours.shape[2:] == ref.shape[1:3]
    assert _rel(ours.numpy().transpose(0, 2, 3, 1), ref) <= OUT_RTOL


@pytest.mark.parametrize("name", list(SIZES))
@pytest.mark.parametrize("mixed", [False, True])
def test_apply_equals_reference(name, mixed):
    rspec, spec = _specs(name)
    rp = _ref_params(rspec)
    x = _images(rspec, 3)
    bits = None
    if mixed:
        cycle = [(8, 8), (4, 3), (2, 2), (5, 4), (3, 6)]
        bits = [cycle[i % len(cycle)] for i in range(len(spec.layers))]
    tape, own = _tapes()
    with _taped(tape) as (qw, qa):
        ref = np.asarray(jax.jit(lambda p, v: RC.apply(p, rspec, v, bits, quant_w=qw, quant_a=qa))(rp, x))
        jax.effects_barrier()
    with _taped(tape, own) as (qw, qa):
        ours = C.apply(convnet_params_from_jax(rp), spec, images_from_jax(x), bits, quant_w=qw, quant_a=qa)
    assert ours.shape == ref.shape == ((3, 10) if name == "vgg_tiny" else (3, 4))
    assert _rel(ours.numpy(), ref) <= OUT_RTOL
    if mixed:
        check_levels(tape, own)
    assert len(own["act"]) == (len(spec.layers) - 1 if mixed else 0)  # the first layer's input stays raw


def test_detection_head_and_iou_equal_reference():
    """The grid head reads channel 0 over (h, w) row-major and channels 1:5
    a cell; a head that reshapes NCHW without the permute fails."""
    g = np.random.default_rng(2)
    feat = g.normal(size=(3, 4, 6, 5)).astype(np.float32)  # NHWC, the last layer's output
    obj = jax.nn.softmax(feat[..., 0].reshape(3, -1), axis=-1)
    coords = jax.nn.sigmoid(feat[..., 1:5]).reshape(3, -1, 4)
    ref = np.asarray(jnp.einsum("bg,bgc->bc", obj, coords))
    spec = C.ConvNetSpec("id", (4, 6), 5, (C.ConvSpec(5, 5, kernel=1, act=False),), "detect", 5)
    eye = {"layer0": {"w": torch.eye(5)[:, :, None, None], "scale": torch.ones(5), "bias": torch.zeros(5)}}
    x = images_from_jax(feat)
    assert _rel(C.apply(eye, spec, x).numpy(), ref) <= OUT_RTOL
    wrong = torch.sigmoid(x[:, 1:5]).reshape(3, -1, 4)
    bad = torch.einsum("bg,bgc->bc", torch.softmax(x[:, 0].reshape(3, -1), -1), wrong)
    assert _rel(bad.numpy(), ref) > 1e-2
    a = g.uniform(0.05, 0.95, (64, 4)).astype(np.float32)
    b = g.uniform(0.05, 0.95, (64, 4)).astype(np.float32)
    a[0] = b[0]
    a[1] = (0.1, 0.1, 0.05, 0.05)
    b[1] = (0.9, 0.9, 0.05, 0.05)  # disjoint
    assert abs(float(C.iou(torch.from_numpy(a), torch.from_numpy(b))) - float(RC.iou(a, b))) <= 1e-7
    assert float(C.iou(torch.from_numpy(b), torch.from_numpy(b))) == pytest.approx(1.0)
    logits, labels = g.normal(size=(40, 10)).astype(np.float32), g.integers(0, 10, 40).astype(np.int32)
    assert float(C.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))) == float(RC.accuracy(logits, labels))
    for head, pred, lab in (("classify", logits, labels), ("detect", a, b)):
        ours = float(C.task_loss(torch.from_numpy(pred), torch.from_numpy(lab), head))
        assert ours == pytest.approx(float(RC.task_loss(pred, lab, head)), rel=LOSS_RTOL)


# -- super-net -----------------------------------------------------------------------------


def _alphas(n_layers: int, n: int, seed: int) -> dict:
    g = np.random.default_rng(seed)
    return {f"layer{i}": {"w": g.normal(size=n).astype(np.float32), "a": g.normal(size=n).astype(np.float32)}
            for i in range(n_layers)}


def _trainable(tree: dict) -> dict:
    return {k: {kk: torch.from_numpy(np.array(v)).requires_grad_(True) for kk, v in d.items()}
            for k, d in tree.items()}


def check_grads(ref: dict, ours: dict, conv: bool) -> float:
    """Every leaf of ``ref`` (numpy, the reference's layout) against the
    port's ``.grad`` (OIHW weights where ``conv``, else the architecture
    logits); returns the worst."""
    worst, rtol = 0.0, GRAD_RTOL if conv else ALPHA_GRAD_RTOL
    for layer, leaves in ref.items():
        for k, g in leaves.items():
            p = ours[layer][k].grad
            p = np.zeros_like(g) if p is None else (_hwio(p) if conv and k == "w" else p.numpy())
            if not np.any(g):
                assert np.abs(p).max() <= GRAD_ATOL, (layer, k)
                continue
            worst = max(worst, _rel(p, g))
            assert _rel(p, g) <= rtol, (layer, k, _rel(p, g))
    return worst


def _ref_search_step(rspec, space, tables, ops, eta, proxy, tape):
    """The reference search step's loss terms and gradients (jitted)."""

    def loss_fn(params, alphas, x, y):
        pred = RS.supernet_apply(params, alphas, rspec, x, space)
        acc = RC.task_loss(pred, y, rspec.head)
        comp = RS.complexity_loss(alphas, tables, ops, proxy=proxy, bit_choices=space.bit_choices)
        return acc + eta * comp, (acc, comp)

    def run(params, alphas, x, y):
        with _taped(tape):
            out = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(params, alphas, x, y)
            jax.effects_barrier()
        return out

    return run


def _port_search_loss(spec, space, tables, ops, eta, proxy, params, alphas, x, y):
    pred = S.supernet_apply(params, alphas, spec, x, space)
    acc = C.task_loss(pred, y, spec.head)
    comp = S.complexity_loss(alphas, tables, ops, proxy=proxy, bit_choices=space.bit_choices)
    return acc + eta * comp, acc, comp


@pytest.mark.parametrize("name,proxy", [("vgg_tiny", "dsp"), ("ultranet", "dsp"), ("skynet", "edmips")])
def test_search_step_loss_and_every_gradient(name, proxy, luts, ref_luts):
    """One step of ``search``'s loss (Eq. 9) at every bit choice, on random
    alphas: the loss, its task and complexity terms and every gradient leaf
    of params and alphas."""
    rspec, spec = _specs(name)
    space, rspace = S.SearchSpace(), RS.SearchSpace()
    rp, ra = _ref_params(rspec), _alphas(len(spec.layers), space.n, 3)
    if name == "vgg_tiny":
        x, y = RD.classification_set(2, 8, hw=16)
    else:
        x, y = RD.detection_set(2, 8, hw=rspec.in_hw)
    rt, rops = RS.t_mul_tables(rspec, ref_luts, rspace), RS.op_muls(rspec)
    tape, own = _tapes()
    (rloss, (racc, rcomp)), (rgp, rga) = _ref_search_step(rspec, rspace, rt, rops, 0.25, proxy, tape)(
        rp, jax.tree.map(jnp.asarray, ra), x, y)
    params, alphas = _trainable(convnet_params_from_jax(rp)), _trainable(ra)
    tables, ops = S.t_mul_tables(spec, luts, space, device="cpu"), S.op_muls(spec, device="cpu")
    assert np.array_equal(tables.numpy(), np.asarray(rt)) and np.array_equal(ops.numpy(), np.asarray(rops))
    with _taped(tape, own):
        loss, acc, comp = _port_search_loss(spec, space, tables, ops, 0.25, proxy, params, alphas,
                                            images_from_jax(np.asarray(x)), torch.from_numpy(np.array(y)))
    loss.backward()
    check_levels(tape, own)
    for a, b in ((loss, rloss), (acc, racc), (comp, rcomp)):
        assert float(a.detach()) == pytest.approx(float(b), rel=LOSS_RTOL)
    check_grads(_np(rgp), params, conv=True)
    check_grads(_np(rga), alphas, conv=False)


@pytest.mark.parametrize("proxy", ["dsp", "edmips"])
def test_complexity_loss_and_gradients_equal_reference(proxy, luts, ref_luts):
    rspec, spec = _specs("ultranet")
    space = S.SearchSpace()
    ra = _alphas(len(spec.layers), space.n, 5)
    rt, rops = RS.t_mul_tables(rspec, ref_luts, RS.SearchSpace()), RS.op_muls(rspec)
    rl, rg = jax.value_and_grad(lambda a: RS.complexity_loss(a, rt, rops, proxy=proxy))(
        jax.tree.map(jnp.asarray, ra))
    alphas = _trainable(ra)
    loss = S.complexity_loss(alphas, S.t_mul_tables(spec, luts, space, device="cpu"),
                             S.op_muls(spec, device="cpu"), proxy=proxy)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(rl), rel=LOSS_RTOL)
    check_grads(_np(rg), alphas, conv=False)
    with pytest.raises(ValueError):
        S.complexity_loss(alphas, S.t_mul_tables(spec, luts, space, device="cpu"),
                          S.op_muls(spec, device="cpu"), proxy="bits")


def test_select_bits_takes_the_first_of_a_tie():
    spec, space = C.ultranet(), S.SearchSpace()
    uniform = S.init_alphas(spec, space, device="cpu")
    assert S.select_bits(uniform, space) == [(2, 2)] * len(spec.layers)
    ref = RS.select_bits(RS.init_alphas(RC.ultranet(), RS.SearchSpace()), RS.SearchSpace())
    assert S.select_bits(uniform, space) == ref
    tied = _alphas(len(spec.layers), space.n, 7)
    for i, d in enumerate(tied.values()):
        d["w"][[1, 4]] = 9.0  # tie between 3 and 6 bits: 3 wins
        d["a"][[i % 7, 6]] = 9.0
    ours = S.select_bits({k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in tied.items()}, space)
    assert ours == RS.select_bits(tied, RS.SearchSpace())
    assert all(w == 3 for w, _ in ours)


def test_op_dsp_equals_reference(luts, ref_luts):
    for name in ("ultranet", "skynet", "vgg_tiny"):
        for bits in ((4, 4), (2, 3), (8, 8)):
            rspec, spec = RC.CONVNETS[name](), C.CONVNETS[name]()
            b = [bits] * len(spec.layers)
            assert S.op_dsp(spec, b, luts) == RS.op_dsp(rspec, b, ref_luts)


def _drop_softmax(quant, alpha, v, space):
    """Planted: the composite quantizer without its softmax."""
    return torch.tensordot(alpha, torch.stack([quant(v, b) for b in space.bit_choices]), dims=1)


def test_planted_faults_are_rejected(luts, ref_luts):
    """A composite without its softmax, and ``torch.maximum(x, 0)`` for the
    ReLU (it passes half the gradient at 0, ``jax.nn.relu`` none), must
    fail the checks.  Exact zeros before a ReLU need a window of zeros:
    the batch's images carry a zero block (bias 0, so the first layer's
    outputs there are exactly 0)."""
    rspec, spec = _specs("vgg_tiny")
    space, rspace = S.SearchSpace(), RS.SearchSpace()
    rp, ra = _ref_params(rspec), _alphas(len(spec.layers), space.n, 3)
    x, y = RD.classification_set(2, 8, hw=16)
    x = np.asarray(x).copy()
    x[:, 4:12, 4:12] = 0.0
    rt, rops = RS.t_mul_tables(rspec, ref_luts, rspace), RS.op_muls(rspec)
    tape, _ = _tapes()
    (rloss, _), (rgp, rga) = _ref_search_step(rspec, rspace, rt, rops, 0.25, "dsp", tape)(
        rp, jax.tree.map(jnp.asarray, ra), x, y)
    tables, ops = S.t_mul_tables(spec, luts, space, device="cpu"), S.op_muls(spec, device="cpu")

    def port(plant):
        params, alphas = _trainable(convnet_params_from_jax(rp)), _trainable(ra)
        own = _tapes()[1]
        with plant(), _taped(tape, own):
            loss, _, _ = _port_search_loss(spec, space, tables, ops, 0.25, "dsp", params, alphas,
                                           images_from_jax(x), torch.from_numpy(np.array(y)))
        loss.backward()
        check_levels(tape, own)
        assert float(loss.detach()) == pytest.approx(float(rloss), rel=LOSS_RTOL)
        check_grads(_np(rgp), params, conv=True)
        check_grads(_np(rga), alphas, conv=False)

    port(contextlib.nullcontext)  # the clean run passes on this batch
    with pytest.raises(AssertionError):
        port(lambda: _patched(S, _composite=_drop_softmax))
    with pytest.raises(AssertionError, match=r"\('layer0', 'bias'"):  # half a gradient at 0
        port(lambda: _patched(C.F, relu=lambda v: torch.maximum(v, torch.zeros_like(v))))


# -- search and finetune over 5 steps ---------------------------------------------------


@pytest.fixture
def shared_init(monkeypatch):
    """The port's ``convnets.init_params`` returns the reference's weights
    for the same seed, carried across."""

    def init(key, spec, *, device="cuda"):
        rspec = getattr(RC, spec.name)(in_hw=spec.in_hw)
        return convnet_params_from_jax(_ref_params(rspec, key), device)

    monkeypatch.setattr(C, "init_params", init)


def _kwdefault_tape(monkeypatch, fn, tape, own=None):
    """``fn``'s default quantizers (``convnets.apply``'s ``quant_w`` and
    ``quant_a``) and its package's ReLU recording or substituting."""
    qw, qa, relu = _recorders(tape) if own is None else _substitutes(tape, own)
    monkeypatch.setitem(fn.__kwdefaults__, "quant_w", qw)
    monkeypatch.setitem(fn.__kwdefaults__, "quant_a", qa)
    monkeypatch.setattr(jax.nn if own is None else F, "relu", relu)


def test_search_over_5_steps_equals_reference(luts, ref_luts, shared_init):
    """VGG-Tiny: ``search``'s history, architecture logits, bits and final
    readings."""
    rspec, spec = _specs("vgg_tiny")
    kw = dict(eta=0.25, steps=5, batch=8, n_data=16, seed=0)
    tape, own = _tapes()
    with _taped(tape):
        ref = RNS.search(rspec, ref_luts, **kw)
        jax.effects_barrier()
    with _taped(tape, own):
        ours = N.search(spec, luts, device="cpu", **kw)
    check_levels(tape, own)
    assert [h["step"] for h in ours.history] == [h["step"] for h in ref.history] == [0, 1, 2, 3, 4]
    for h, r in zip(ours.history, ref.history):
        for k in ("loss", "task", "comp"):
            assert h[k] == pytest.approx(r[k], rel=STEPS_RTOL), (h, r)
    for layer, d in _np(ref.alphas).items():
        for k, v in d.items():
            assert np.abs(ours.alphas[layer][k].numpy() - v).max() <= STEPS_RTOL, (layer, k)
    assert ours.bits == ref.bits
    assert ours.op_dsp == ref.op_dsp
    assert ours.final_task_loss == pytest.approx(ref.final_task_loss, rel=STEPS_RTOL)
    assert ours.final_metric == pytest.approx(ref.final_metric, abs=1e-6)


def test_finetune_over_5_steps_equals_reference(shared_init, monkeypatch):
    """UltraNet at a (4, 4) / (3, 2) mix: ``finetune``'s losses and IOU."""
    rspec, spec = _specs("ultranet")
    bits = ([(4, 4), (3, 2)] * len(spec.layers))[: len(spec.layers)]
    tape, own = _tapes()
    _kwdefault_tape(monkeypatch, RC.apply, tape)
    rft = RNS.finetune(rspec, bits, steps=5, batch=8, n_data=16, seed=0)
    jax.effects_barrier()
    _kwdefault_tape(monkeypatch, C.apply, tape, own)
    ft = N.finetune(spec, bits, steps=5, batch=8, n_data=16, seed=0, device="cpu")
    check_levels(tape, own, ACT_ATOL_STEPS, WEIGHT_FLIP_SHARE_STEPS)
    for k in ("train_loss", "test_loss"):
        assert ft[k] == pytest.approx(rft[k], rel=STEPS_RTOL)
    assert ft["metric"] == pytest.approx(rft["metric"], abs=1e-3)


def test_finetune_copies_the_params_it_is_given(luts):
    spec = C.vgg_tiny(in_hw=(8, 8))
    params = C.init_params(0, spec, device="cpu")
    before = {k: v["w"].clone() for k, v in params.items()}
    out = N.finetune(spec, [(4, 4)] * len(spec.layers), steps=2, batch=8, n_data=16, params=params, device="cpu")
    assert all(torch.equal(params[k]["w"], w) for k, w in before.items())
    assert not torch.equal(out["params"]["layer1"]["w"], before["layer1"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = C.vgg_tiny(in_hw=(8, 8))
    for call in (lambda: C.init_params(0, spec), lambda: S.init_alphas(spec, S.SearchSpace()),
                 lambda: N.search(spec, {1: None}, steps=1), lambda: N.finetune(spec, [(4, 4)] * 7, steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- int_conv_equivalence with the plain packed_conv1d --------------------------------


def test_int_conv_equivalence_through_packed_conv1d():
    """A 3x3 UltraNet layer (64 to 64 at 10x20) as row convolutions of its
    levels through ``packed_conv1d`` (plain on the CPU): the integer sums
    equal a float64 ``conv2d`` of the levels, and folded by
    ``int_conv_equivalence`` they match ``conv2d`` of the fake-quant
    tensors."""
    from repro.core.quant.fake_quant import int_conv_equivalence as ref_fn
    from repro_torch.core import quant as Q

    assert not hasattr(Q, "int_conv_equivalence")  # kept out of the package's exports, as the reference

    g = torch.Generator().manual_seed(5)
    w = torch.randn((64, 64, 3, 3), generator=g) / 24.0
    x = torch.rand((1, 64, 10, 20), generator=g) * 1.2 - 0.1
    wb, ab = 4, 4
    assert choose_filter_config(wb, ab, 3) is not None
    w_lvl, s_w, z_w = FQ.weight_to_int_levels(w, wb)
    a_lvl, s_a = FQ.act_to_int_levels(x, ab)
    (wi, ai), scale, zero = FQ.int_conv_equivalence(w_lvl, a_lvl, s_w, z_w, s_a)
    (rwi, rai), rscale, rzero = ref_fn(jnp.asarray(w_lvl.numpy()), jnp.asarray(a_lvl.numpy()), s_w, z_w, s_a)
    assert np.array_equal(wi.numpy(), np.asarray(rwi)) and np.array_equal(ai.numpy(), np.asarray(rai))
    assert (scale, zero) == (rscale, rzero) and wi.dtype == ai.dtype == torch.int32
    ints = _rows_conv(wi, ai[0], wb, ab)
    want = F.conv2d(ai.to(torch.float64), wi.to(torch.float64), padding=1)[0]
    assert torch.equal(ints.to(torch.float64), want)
    ones = F.conv2d(ai.to(torch.float64), torch.ones((1, 64, 3, 3), dtype=torch.float64), padding=1)[0]
    folded = scale * (ints.to(torch.float64) - zero * ones)
    fq = F.conv2d(fake_quant_act(x, ab), fake_quant_weight(w, wb), padding=1)[0]
    assert _rel(folded.numpy(), fq.numpy()) <= OUT_RTOL


def _rows_conv(w_lvl: torch.Tensor, a_lvl: torch.Tensor, wb: int, ab: int) -> torch.Tensor:
    """A 3x3 SAME convolution [cout, cin, 3, 3] x [cin, H, W] of levels as
    three row convolutions an output channel through ``packed_conv1d``:
    batch = output rows, channels = cin, sequence = W (phase 7's split of
    UltraNet's layers)."""
    cout, cin, k, _ = w_lvl.shape
    h, wd = a_lvl.shape[1:]
    padded = F.pad(a_lvl, (0, 0, 1, 1))  # rows above and below
    out = torch.zeros((cout, h, wd), dtype=torch.int64)
    for o in range(cout):
        for dy in range(k):
            s = padded[:, dy : dy + h].permute(1, 0, 2).contiguous()  # [H, cin, W]
            f = torch.flip(w_lvl[o, :, dy], (1,)).contiguous()  # [cin, 3], a convolution's taps
            out[o] += packed_conv1d(s, f, w_bits=wb, a_bits=ab)[:, 1 : wd + 1].to(torch.int64)
    return out
