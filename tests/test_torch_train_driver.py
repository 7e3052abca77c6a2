"""The port's training CLI and what it runs on against the reference's, on
the CPU: the optimizer, gradient compression and token stream
(``tests/test_substrates.py`` on the port, and each against the
reference), the fault-tolerant runner (``tests/test_fault_tolerance.py``
on the port), ``make_train_step`` and ``python -m repro_torch.launch.train``.

Both packages start from identical weights and optimizer state (the
reference's ``init_params(PRNGKey(0))`` and ``AdamW.init`` carried across
by :mod:`repro_torch.bridge`) and identical batches (the token stream is
numpy in both).  Configs run at float32 (each CLI's ``get_config`` is
patched to return its config at float32, as ``tests/test_torch_serve_cli.py``
does).  Tolerances: losses ``LOSS_RTOL`` relative (per step of a CLI run:
``CLI_RTOL``, the float32 differences compounding over steps); the
optimizer alone on shared gradients ``STATE_RTOL``-tight; a train step's
update as ``test_make_train_step_matches_reference`` states.
"""
from __future__ import annotations

import dataclasses
import pathlib
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as ref_train
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.data.tokens import TokenStream as RefTokenStream
from repro.launch import steps as RS
from repro.models import transformer as RT
from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import global_norm as ref_global_norm
from repro.optim.compression import compress_tree as ref_compress_tree
from repro.optim.compression import quantize_int8 as ref_quantize_int8
from repro.optim.compression import topk_mask as ref_topk_mask
from repro.parallel.sharding import ShardingRules
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.promcheck import check_exposition
from repro_torch.optim import AdamW, AdamWState, GradAccumulator, cosine_schedule, global_norm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.compression import compress_tree, quantize_int8, topk_mask
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig

LOSS_RTOL = 1e-5
CLI_RTOL = 1e-4
STATE_RTOL = 1e-5
UPDATE_RTOL = 2e-3
INT8_MOVED = 0.05


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


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def _close_tree(ours, theirs, rtol: float = STATE_RTOL) -> None:
    o, t = _flat(ours), _flat(_np(theirs))
    assert set(o) == set(t)
    for k, ref in t.items():
        mine = o[k].detach().to(torch.float32).numpy()
        ref = np.asarray(ref, np.float32)
        assert np.linalg.norm(mine - ref) <= rtol * np.linalg.norm(ref) + 1e-12, (k, np.linalg.norm(mine - ref))


# -- optimizer (tests/test_substrates.py on the port) --------------------------------


def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(150):
        params["x"].requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(params["x"] ** 2), params["x"])
        params, state = opt.update({"x": g}, state, params)
    assert float(params["x"].abs().max()) < 1e-2


def test_grad_clipping_bounds_norm():
    opt = AdamW(lr=1.0, grad_clip_norm=1.0)
    params = {"x": torch.zeros(4)}
    state = opt.init(params)
    new, _ = opt.update({"x": torch.full((4,), 100.0)}, state, params)
    # the first Adam step is bounded by lr whatever the raw gradient
    assert float(new["x"].abs().max()) <= 1.0 + 1e-6


def test_cosine_schedule_shape():
    f = cosine_schedule(1.0, warmup=10, total=100)
    assert float(f(torch.tensor(0))) == 0.0
    assert abs(float(f(torch.tensor(10))) - 1.0) < 1e-6
    assert float(f(torch.tensor(100))) < 1e-3
    rf = ref_cosine(0.3, warmup=7, total=50, floor=0.1)
    pf = cosine_schedule(0.3, warmup=7, total=50, floor=0.1)
    for step in (0, 3, 7, 20, 49, 60):
        assert float(pf(torch.tensor(step, dtype=torch.int32))) == pytest.approx(
            float(rf(jnp.asarray(step, jnp.int32))), rel=1e-6, abs=1e-9)


def test_grad_accumulator_mean():
    acc = GradAccumulator.init({"w": torch.zeros(3)})
    acc = acc.add({"w": torch.ones(3)})
    acc = acc.add({"w": 3 * torch.ones(3)})
    np.testing.assert_allclose(acc.mean()["w"].numpy(), 2.0)


def _tree(seed: int, scale: float = 1.0):
    g = np.random.default_rng(seed)
    return {"b": {"w": (g.normal(size=(6, 5)) * scale).astype(np.float32)},
            "a": (g.normal(size=(7,)) * scale).astype(np.float32),
            "c": [(g.normal(size=(2, 3, 4)) * scale).astype(np.float32)]}


@pytest.mark.parametrize("case", ["plain", "clip-wd", "cosine", "bf16-moments"])
def test_adamw_steps_match_reference(case):
    """Four steps of each optimizer on one tree of params and gradients:
    params, moments and step equal the reference's (float32 arithmetic,
    bias corrections with ``b ** step`` in float32)."""
    kw = {"plain": {}, "clip-wd": dict(grad_clip_norm=0.5, weight_decay=0.01, lr=3e-3),
          "cosine": dict(grad_clip_norm=1.0),
          "bf16-moments": dict(grad_clip_norm=1.0, weight_decay=0.01)}[case]
    rkw, pkw = dict(kw), dict(kw)
    if case == "cosine":
        rkw["lr"], pkw["lr"] = ref_cosine(1e-2, warmup=2, total=6), cosine_schedule(1e-2, warmup=2, total=6)
    if case == "bf16-moments":
        rkw["moment_dtype"], pkw["moment_dtype"] = jnp.bfloat16, torch.bfloat16
    ropt, opt = RefAdamW(**rkw), AdamW(**pkw)
    rparams = jax.tree.map(jnp.asarray, _tree(0))
    rstate = ropt.init(rparams)
    params = params_from_jax(_np(rparams))
    state = params_from_jax(_np(rstate))
    assert isinstance(state, AdamWState)
    for step in range(4):
        grads = _tree(10 + step, scale=3.0)
        rparams, rstate = ropt.update(jax.tree.map(jnp.asarray, grads), rstate, rparams)
        params, state = opt.update(params_from_jax(grads), state, params)
    _close_tree(params, rparams, 1e-6)
    _close_tree(state.mu, rstate.mu, 1e-2 if case == "bf16-moments" else 1e-6)
    _close_tree(state.nu, rstate.nu, 1e-2 if case == "bf16-moments" else 1e-6)
    assert int(state.step) == int(rstate.step) == 4
    assert all(m.dtype == (torch.bfloat16 if case == "bf16-moments" else torch.float32)
               for m in tree_leaves(state.mu))


def test_global_norm_matches_reference():
    tree = _tree(3)
    assert float(global_norm(params_from_jax(tree))) == pytest.approx(
        float(ref_global_norm(jax.tree.map(jnp.asarray, tree))), rel=1e-6)


def test_adamw_updates_a_stacked_leaf_past_the_slice_in_place(monkeypatch):
    """A leaf past the slice bound is updated a layer at a time, in place,
    with the same bits as the whole-leaf update."""
    from repro_torch.optim import adamw

    g = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 8, 8)).astype(np.float32))
    opt = AdamW(lr=1e-2, grad_clip_norm=1.0, weight_decay=0.01)
    outs = []
    for slice_bound in (1 << 26, 16):
        monkeypatch.setattr(adamw, "_SLICE", slice_bound)
        p = {"w": torch.ones(3, 8, 8)}
        ptr = p["w"].data_ptr()
        st = opt.init(p)
        p, st = opt.update({"w": g.clone()}, st, p)
        assert p["w"].data_ptr() == ptr
        outs.append((p["w"], st.mu["w"], st.nu["w"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- gradient compression -------------------------------------------------------------


def test_int8_compression_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)).astype(np.float32))
    q = quantize_int8(g)
    assert float((q - g).abs().max()) <= float(g.abs().max()) / 127.0 + 1e-6
    np.testing.assert_allclose(q.numpy(), np.asarray(ref_quantize_int8(jnp.asarray(g.numpy()))), rtol=1e-6)


def test_topk_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.2, 4.0, -0.05, 0.3, 1.0, -2.0] * 4)
    m = topk_mask(g, frac=0.25)
    kept = m.numpy() != 0
    assert kept.sum() >= 8
    assert bool(kept[1]) and bool(kept[3])  # the largest magnitudes survive
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_topk_mask(jnp.asarray(g.numpy()), frac=0.25)))
    small = torch.arange(16.0)  # 16 elements or fewer pass through
    assert topk_mask(small, 0.1) is small


def test_compress_tree_structure():
    tree = {"a": torch.ones((8, 8)), "b": {"c": torch.ones(17)}}
    for method in ("int8", "topk"):
        out = compress_tree(tree, method=method)
        assert out.keys() == tree.keys() and out["b"].keys() == tree["b"].keys()
        ref = ref_compress_tree({"a": jnp.ones((8, 8)), "b": {"c": jnp.ones(17)}}, method=method)
        _close_tree(out, ref, 1e-6)
    with pytest.raises(ValueError):
        compress_tree(tree, method="fp4")


# -- the token stream -----------------------------------------------------------------


def test_token_stream_deterministic_and_sharded():
    a = TokenStream(vocab=1024, seq_len=32, global_batch=8, seed=5, n_hosts=2, host_id=0)
    b = TokenStream(vocab=1024, seq_len=32, global_batch=8, seed=5, n_hosts=2, host_id=1)
    x0, x1 = a.batch(11), b.batch(11)
    assert x0["tokens"].shape == (4, 32)
    assert not np.array_equal(x0["tokens"], x1["tokens"])  # distinct host slices
    np.testing.assert_array_equal(a.batch(11)["tokens"], x0["tokens"])  # replayable
    np.testing.assert_array_equal(x0["labels"][:, :-1], x0["tokens"][:, 1:])  # next-token shifted


@pytest.mark.parametrize("kw", [dict(vocab=512, seq_len=16, global_batch=4),
                                dict(vocab=50_432, seq_len=256, global_batch=8, seed=3, n_hosts=2, host_id=1)])
def test_token_stream_equals_the_reference(kw):
    for step in (0, 7, 20):
        ours, theirs = TokenStream(**kw).batch(step), RefTokenStream(**kw).batch(step)
        for k in ("tokens", "labels"):
            assert ours[k].dtype == theirs[k].dtype == np.int32
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_token_stream_learnable_structure():
    """A bigram model beats uniform entropy on this stream."""
    b = TokenStream(vocab=64, seq_len=512, global_batch=4, seed=0).batch(0)
    toks, labs = b["tokens"].ravel(), b["labels"].ravel()
    counts = np.ones((64, 64))
    for t, l in zip(toks[:1500], labs[:1500]):
        counts[t, l] += 1
    probs = counts / counts.sum(1, keepdims=True)
    assert -np.mean(np.log(probs[toks[1500:], labs[1500:]])) < np.log(64) * 0.9


# -- the fault-tolerant runner (tests/test_fault_tolerance.py on the port) ------------


def _counting_step(state, batch):
    state = {"x": state["x"] + 1}
    return state["x"].to(torch.float32), state


def test_failure_before_first_checkpoint_resumes_from_initial_state(tmp_path):
    fails = {"left": 2}

    def injector(step):
        if step == 0 and fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("host died before the first checkpoint")

    runner = FaultTolerantRunner(_counting_step, CheckpointManager(tmp_path), RunnerConfig(ckpt_every=100))
    state, stats = runner.run({"x": torch.tensor(0, dtype=torch.int32)}, lambda i: i, 5, failure_injector=injector)
    assert stats.restarts == 2 and stats.steps == 5
    assert int(state["x"]) == 5  # every step applied once despite two retries of step 0


def test_max_retries_exhaustion_reraises(tmp_path):
    def always_dies(step):
        raise RuntimeError("persistent failure")

    runner = FaultTolerantRunner(_counting_step, CheckpointManager(tmp_path),
                                 RunnerConfig(ckpt_every=100, max_retries=2))
    with pytest.raises(RuntimeError, match="persistent failure"):
        runner.run({"x": torch.tensor(0, dtype=torch.int32)}, lambda i: i, 5, failure_injector=always_dies)
    assert runner.stats.restarts == 3 and runner.stats.steps == 0


def test_straggler_ewma_fires_callback(tmp_path):
    seen: list = []
    runner = FaultTolerantRunner(_counting_step, CheckpointManager(tmp_path),
                                 RunnerConfig(straggler_factor=3.0, ewma_alpha=0.2),
                                 on_straggler=lambda step, dt: seen.append((step, dt)))
    runner._straggler_check(0, 1.0)  # seeds the EWMA, can never fire
    assert runner.stats.stragglers == 0 and runner._ewma == 1.0
    runner._straggler_check(1, 2.0)
    assert runner.stats.stragglers == 0
    ewma = runner._ewma
    runner._straggler_check(2, 10.0)
    assert runner.stats.stragglers == 1 and seen == [(2, 10.0)]
    assert runner._ewma == pytest.approx(0.8 * ewma + 0.2 * 10.0)


def test_runner_routes_counters_through_shared_registry(tmp_path):
    reg = MetricsRegistry()
    reg.counter("repro_steps_total", "serving steps").inc(4)
    fails = {"left": 1}

    def injector(step):
        if step == 1 and fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("injected")

    runner = FaultTolerantRunner(_counting_step, CheckpointManager(tmp_path), RunnerConfig(ckpt_every=100),
                                 registry=reg)
    _, stats = runner.run({"x": torch.tensor(0, dtype=torch.int32)}, lambda i: i, 3, failure_injector=injector)
    assert reg.counter("repro_train_steps_total").value() == stats.steps == 3
    assert reg.counter("repro_train_restarts_total").value() == stats.restarts == 1
    assert reg.counter("repro_train_stragglers_total").value() == stats.stragglers
    h = reg.histogram("repro_train_step_seconds")
    assert h.count == 3 and h.sum > 0
    text = reg.prometheus_text()
    assert "repro_steps_total" in text and "repro_train_steps_total" in text
    assert check_exposition(text) == []
    solo = FaultTolerantRunner(_counting_step, CheckpointManager(tmp_path / "b"))
    solo.run({"x": torch.tensor(0, dtype=torch.int32)}, lambda i: i, 2)
    assert solo.registry.counter("repro_train_steps_total").value() == 2


def test_fault_tolerant_runner_recovers(tmp_path):
    """Failures at steps 7 and 13: the runner restores and ends on the same
    state as an uninterrupted run."""
    opt = AdamW(lr=0.05)

    def step(state, batch):
        params, opt_state = state
        w = params["w"].requires_grad_(True)
        loss = torch.mean((w * batch["x"] - batch["y"]) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        params, opt_state = opt.update({"w": g}, opt_state, params)
        return loss.detach(), (params, opt_state)

    def batches(i):
        x = torch.from_numpy(np.random.default_rng(i).normal(size=(8,)).astype(np.float32))
        return {"x": x, "y": 3.0 * x}

    def init():
        params = {"w": torch.zeros(8)}
        return params, opt.init(params)

    state_ref, _ = FaultTolerantRunner(step, CheckpointManager(tmp_path / "ref"), RunnerConfig(ckpt_every=4)).run(
        init(), batches, 20)
    died = set()

    def injector(i):
        if i in (7, 13) and i not in died:
            died.add(i)
            raise RuntimeError("simulated host failure")

    ft = FaultTolerantRunner(step, CheckpointManager(tmp_path / "ft"), RunnerConfig(ckpt_every=4))
    state_ft, stats = ft.run(init(), batches, 20, failure_injector=injector)
    assert stats.restarts == 2
    np.testing.assert_allclose(state_ref[0]["w"].detach().numpy(), state_ft[0]["w"].detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_straggler_detection(tmp_path):
    calls = []

    def slow_step(state, batch):
        time.sleep(0.25 if batch == 5 else 0.01)
        return torch.zeros(()), state

    ft = FaultTolerantRunner(slow_step, CheckpointManager(tmp_path), RunnerConfig(ckpt_every=1000,
                             straggler_factor=3.0), on_straggler=lambda s, dt: calls.append((s, dt)))
    ft.run(None, lambda s: s, 10)
    assert ft.stats.stragglers >= 1 and any(s == 5 for s, _ in calls)


def test_resume_refuses_shardings(tmp_path):
    """Without a checkpoint ``resume_or_init`` returns the initial state;
    with one, a restore sharding must be a ``NamedSharding`` (None leaves
    the leaf on its template's device); restores onto meshes are
    ``tests/test_torch_mesh_train.py``'s."""
    runner = FaultTolerantRunner(_counting_step, CheckpointManager(tmp_path))
    assert runner.resume_or_init({"x": torch.tensor(7)}, shardings={"x": None}) == (0, {"x": torch.tensor(7)})
    runner.ckpt.save(3, {"x": torch.tensor(5)})
    assert runner.resume_or_init({"x": torch.tensor(7)}, shardings={"x": None}) == (3, {"x": torch.tensor(5)})
    with pytest.raises(TypeError, match="NamedSharding"):
        runner.resume_or_init({"x": torch.tensor(0)}, shardings={"x": ("data",)})


# -- make_train_step ------------------------------------------------------------------


def _cfgs(arch: str, **fields):
    return (dataclasses.replace(ref_get_config(arch, smoke=True), dtype=jnp.float32, **fields),
            dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32, **fields))


@pytest.mark.parametrize("arch,kw", [
    ("llama3.2-3b", dict(n_micro=1)),
    ("llama3.2-3b", dict(n_micro=2)),
    ("llama3.2-3b", dict(n_micro=2, param_dtype="bf16")),
    ("llama3.2-3b", dict(n_micro=2, compress_grads="int8")),
    ("llama3.2-3b", dict(n_micro=1, compress_grads="topk")),
    ("llama3.2-3b", dict(n_micro=2, moment_dtype="bf16")),
    ("mamba2-130m", dict(n_micro=2)),
], ids=["n_micro1", "n_micro2", "param-bf16", "int8", "topk", "moments-bf16", "mamba-n_micro2"])
def test_make_train_step_matches_reference(arch, kw):
    """Two steps of each package's ``make_train_step`` from one state and
    batch stream: the losses within LOSS_RTOL, and each leaf's update
    (params after the steps minus before) within UPDATE_RTOL relative L2.
    AdamW divides each element's gradient by its own magnitude (``m /
    sqrt(v)`` is +-1 at step 1), so an element whose gradient is near
    ``eps`` turns the gradients' 1e-4 into more.  int8 compression rounds
    ``g / scale`` to integers: where that lies within rounding of a
    half-integer the packages' levels differ, so there at most
    INT8_MOVED of a leaf's elements may move more than lr / 100 from the
    reference's."""
    rcfg, cfg = _cfgs(arch)
    step_cfg = dict(lr=3e-3, **kw)
    rstep_fn = RS.make_train_step(rcfg, ShardingRules(enabled=False), RS.TrainStepConfig(**step_cfg))
    rstep, ropt = jax.jit(rstep_fn), rstep_fn.optimizer
    step = S.make_train_step(cfg, None, S.TrainStepConfig(**step_cfg))
    rparams = rparams0 = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rstate = ropt.init(rparams)
    params, state = params_from_jax(_np(rparams)), params_from_jax(_np(rstate))
    stream = TokenStream(vocab=cfg.vocab, seq_len=16, global_batch=4)
    for i in range(2):
        b = stream.batch(i)
        rloss, rparams, rstate = rstep(rparams, rstate, jax.tree.map(jnp.asarray, b))
        loss, params, state = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    before, after, ours = _flat(_np(rparams0)), _flat(_np(rparams)), _flat(params)
    assert set(ours) == set(after)
    for k, p0 in before.items():
        d_ref = after[k] - p0
        d = ours[k].detach().numpy() - p0
        if kw.get("compress_grads") == "int8":
            assert np.mean(np.abs(d - d_ref) > step_cfg["lr"] / 100) <= INT8_MOVED, k
        else:
            assert np.linalg.norm(d - d_ref) <= UPDATE_RTOL * np.linalg.norm(d_ref), (k, np.linalg.norm(d - d_ref))
    assert int(state.step) == 2
    assert all(m.dtype == (torch.bfloat16 if kw.get("moment_dtype") == "bf16" else torch.float32)
               for m in tree_leaves(state.mu))
    assert all(p.grad is None for p in tree_leaves(params))  # gradients released after the step
    assert step.optimizer.weight_decay == 0.01 and step.optimizer.grad_clip_norm == 1.0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-tiny", "zamba2-1.2b"])
def test_make_train_step_gradients_equal_forward_train_backward(monkeypatch, arch):
    """The step's gradients (stacked leaves filled a layer row at a time
    from per-layer views) equal ``forward_train``'s backward on the
    stacked params (an ``unbind`` a call) bit for bit, at n_micro 1."""
    from repro_torch.models import transformer as T

    _, cfg = _cfgs(arch)
    params0 = T.init_params(cfg, seed=2, device="cpu")
    g = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab, (2, 16)).astype(np.int32)),
             "labels": torch.from_numpy(g.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(g.normal(size=(2, 8, cfg.d_model)).astype(np.float32))
    params = T.map_leaves(params0, lambda a: a.clone().requires_grad_(True))
    T.forward_train(params, cfg, batch).backward()
    want = [p.grad for p in tree_leaves(params)]
    seen = []
    inner = AdamW.update
    monkeypatch.setattr(AdamW, "update", lambda self, grads, st, p: (
        seen.extend(t.clone() for t in tree_leaves(grads)), inner(self, grads, st, p))[1])
    step = S.make_train_step(cfg, None, S.TrainStepConfig(n_micro=1))
    params = T.map_leaves(params0, lambda a: a.clone())
    step(params, step.optimizer.init(params), batch)
    assert len(seen) == len(want)
    for a, b in zip(seen, want):
        assert torch.equal(a, b)


def test_make_train_step_refuses_sharding_rules_and_prefills():
    _, cfg = _cfgs("llama3.2-3b")
    with pytest.raises(TypeError, match="ShardingRules"):  # a mesh step takes the rules themselves
        S.make_train_step(cfg, object())
    rcfg, _ = _cfgs("llama3.2-3b")
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    b = TokenStream(vocab=cfg.vocab, seq_len=16, global_batch=2).batch(0)
    rl = jax.jit(RS.make_prefill_step(rcfg, ShardingRules(enabled=False)))(rparams, jax.tree.map(jnp.asarray, b))
    loss = S.make_prefill_step(cfg)(params_from_jax(_np(rparams)), {k: torch.from_numpy(v) for k, v in b.items()})
    assert not loss.requires_grad
    assert abs(float(loss) - float(rl)) <= LOSS_RTOL * abs(float(rl))


# -- the training CLI ------------------------------------------------------------------


def _patch_clis(monkeypatch, losses: dict, float32: bool = True) -> None:
    """Both CLIs at float32 on the reference's ``PRNGKey(0)`` weights, each
    runner's step wrapped to record its losses in ``losses[side]``."""
    if float32:
        monkeypatch.setattr(ref_train, "get_config", lambda *a, **k: dataclasses.replace(
            ref_get_config(*a, **k), dtype=jnp.float32))
        monkeypatch.setattr(train, "get_config", lambda *a, **k: dataclasses.replace(
            get_config(*a, **k), dtype=torch.float32))

    def port_params(cfg, *, seed, device):
        assert seed == 0 and str(device) == "cpu"
        rcfg = ref_get_config(cfg.name.removesuffix("-smoke"), smoke=cfg.name.endswith("-smoke"))
        return params_from_jax(_np(RT.init_params(jax.random.PRNGKey(0), rcfg)))

    monkeypatch.setattr(train, "init_params", port_params)
    for side, module in (("ref", ref_train), ("port", train)):
        inner = module.FaultTolerantRunner
        record = losses.setdefault(side, [])

        class Recording(inner):
            def __init__(self, step, *a, _record=record, **k):
                def recorded(state, batch):
                    loss, state = step(state, batch)
                    _record.append(float(loss))
                    return loss, state

                super().__init__(recorded, *a, **k)

        monkeypatch.setattr(module, "FaultTolerantRunner", Recording)


@pytest.mark.parametrize("arch,extra", [("llama3.2-3b", []), ("mamba2-130m", ["--n-micro", "1"]),
                                        ("qwen3-moe-30b-a3b", ["--compress-grads", "topk"]),
                                        ("zamba2-1.2b", ["--seq", "8"])])
def test_cli_losses_match_the_reference(monkeypatch, tmp_path, capsys, arch, extra):
    losses: dict = {}
    _patch_clis(monkeypatch, losses)
    argv = ["--arch", arch, "--steps", "5", "--batch", "4", "--seq", "16", "--ckpt-every", "2", *extra]
    rout = ref_train.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    out = train.main(argv + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert out["steps"] == rout["steps"] == 5 and len(losses["port"]) == len(losses["ref"]) == 5
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=CLI_RTOL)
    assert out["loss"] == losses["port"][-1]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("arch=")]
    assert len(lines) == 2 and all(f"arch={arch}-smoke steps=5 loss=" in ln for ln in lines)
    # both wrote checkpoints 2 and 4 (keep=2), one file per leaf, the same names
    for side in ("ref", "port"):
        assert sorted(p.name for p in (tmp_path / side).glob("step_*")) == ["step_00000002", "step_00000004"]
    assert (sorted(p.name for p in (tmp_path / "port" / "step_00000004").iterdir())
            == sorted(p.name for p in (tmp_path / "ref" / "step_00000004").iterdir()))


def test_cli_resumes_a_reference_checkpoint(monkeypatch, tmp_path):
    """The reference's CLI trains 4 steps (checkpoints after steps 0 and
    2); the port's CLI resumes its directory at step 2 (feeding step 2's
    batch again to the state saved after it) to step 7, as the
    reference's own resume of a copy does."""
    losses: dict = {}
    _patch_clis(monkeypatch, losses)
    argv = ["--arch", "llama3.2-3b", "--batch", "4", "--seq", "16", "--ckpt-every", "2"]
    ref_train.main(argv + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    losses["ref"].clear()
    rout = ref_train.main(argv + ["--steps", "7", "--ckpt-dir", str(tmp_path / "b")])
    out = train.main(argv + ["--steps", "7", "--ckpt-dir", str(tmp_path / "a"), "--device", "cpu"])
    assert out["steps"] == rout["steps"] == 5  # steps 2 to 6
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=CLI_RTOL)


def test_cli_mamba_smoke_loss_decreases(tmp_path):
    """tests/test_launch.py::test_train_driver_loss_decreases on the port."""
    out = train.main(["--arch", "mamba2-130m", "--steps", "40", "--batch", "4", "--seq", "32", "--n-micro", "1",
                      "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert out["steps"] == 40
    assert out["loss"] < 6.0  # down from ~ln(512) = 6.24 on the smoke vocab


@pytest.mark.parametrize("arch,key", [("qwen2-vl-7b", "positions"), ("whisper-tiny", "enc_embeds")])
def test_both_clis_fail_where_the_stream_lacks_inputs(tmp_path, arch, key):
    """The token stream carries no M-RoPE positions and no encoder frames:
    both CLIs fail on the missing key after the runner's retries."""
    argv = ["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "8"]
    with pytest.raises(KeyError, match=key):
        ref_train.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(KeyError, match=key):
        train.main(argv + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-130m", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_checkpoint_of_the_train_state_round_trips_across_packages(tmp_path):
    """The port's train state written by its manager is read back by the
    reference's, leaf for leaf, and the reference's by the port's."""
    rcfg, cfg = _cfgs("mamba2-130m")
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rstate = (rparams, RefAdamW().init(rparams))
    state = params_from_jax(_np(rstate))
    CheckpointManager(tmp_path / "port").save(3, state)
    _, back = RefCheckpointManager(tmp_path / "port").restore(rstate)
    RefCheckpointManager(tmp_path / "ref").save(3, rstate)
    _, ours = CheckpointManager(tmp_path / "ref").restore(state)
    for a, b, c in zip(jax.tree.leaves(back), tree_leaves(ours), tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), c.numpy())
        assert torch.equal(b, c)
    assert pathlib.Path(tmp_path / "port" / "step_00000003" / "manifest.json").exists()
