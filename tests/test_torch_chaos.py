"""The fault layer of the port's engine (injected step, allocation and NaN
faults, retries, slot quarantine, ``failed``, hard-fault recovery from a
snapshot) and its checkpoint manager, against the reference, on the CPU.

Every scenario of ``tests/test_chaos.py`` runs on the reference's engine
and the port's with the same ``ChaosConfig``, the same prompts and
identical weights at float32 (the fixtures of ``tests/test_torch_model.py``
and ``tests/test_torch_mamba.py``), on the virtual clock.  The injector
draws from one seeded generator in the same order in both packages, and
every fault decision is a function of the schedule alone (token counts
and ticks, never token values), so the decisions must be equal: per run
the injected counters, steps, ticks, retries, quarantines, preemptions,
hard recoveries and statuses, per request its status, strikes,
preemptions, token count and times.  Sampled rows agree to ``ATOL`` and
tokens are equal up to a request's first divergence, which must sit on a
reference top-2 gap under ``TIE_BOUND`` (``_check_streams``); the
reference's own chaos tests compare bf16 engines with a separate greedy
decode instead, where near-ties flip.

A restore writes into the state tensors in place, so their ``data_ptr``s
never change; a planted restore that rebinds ``self.state`` leaves the
step on the old tensors, which on mamba2-130m changes the rows.
"""
from __future__ import annotations

import filecmp
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_serving import _prompts
from test_torch_chunked import _check_streams
from test_torch_mamba import mamba  # noqa: F401 (fixture)
from test_torch_model import _recording, shared  # noqa: F401 (fixture)

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.serving import ChaosConfig as RefChaosConfig
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving.chaos import ChaosInjector as RefChaosInjector
from repro.serving.chaos import InjectedFault as RefInjectedFault
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import build
from repro_torch.serving import ChaosConfig, Engine, EngineConfig, InjectedFault, build_engine
from repro_torch.serving.chaos import ChaosInjector, FlakyPageAllocator
from repro_torch.serving.paged_kv import PageAllocator

# tests/test_chaos.py _run_chaos's engine: 2 slots, pages of 4, C = 4
BASE = dict(n_slots=2, page_size=4, max_len=32, chunk_tokens=4)
RUN_KEYS = ("statuses", "n_requests", "steps", "fed_tokens", "generated_tokens", "preemptions",
            "quarantines", "step_retries", "hard_recoveries", "injected")
REQ_FIELDS = ("status", "shed_reason", "n_faults", "n_preempted", "t_admit", "t_first_token", "t_finish")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU engine on one intra-op thread (at the smoke size
    thread hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decisions(eng, reqs, m) -> dict:
    return dict(ticks=eng.ticks, finished=[r.rid for r in eng.finished], **{k: m[k] for k in RUN_KEYS},
                requests=[(r.rid, len(r.out_tokens)) + tuple(getattr(r, f) for f in REQ_FIELDS) for r in reqs])


def _state_ptrs(eng) -> dict:
    return {k: t.data_ptr() for k, t in eng.state.items()}


def _plant_ref(eng, at_step: int) -> None:
    """tests/test_chaos.py's hard fault: the reference's step raises once,
    before it runs, at engine step ``at_step``."""
    inner, tripped = eng._step, []

    def dying(*args):
        if eng.n_steps == at_step and not tripped:
            tripped.append(1)
            raise ValueError("simulated XLA executor crash")
        return inner(*args)

    eng._step = dying


def _plant(eng, at_step: int, after: bool = False, exc=None) -> None:
    """The port's twin: its step program raises once at engine step
    ``at_step``, before the step runs, or (``after``) once it has written
    the state, its logits discarded."""
    inner, tripped = eng._program.run, []

    def dying(*args):
        if eng.n_steps == at_step and not tripped:
            tripped.append(1)
            if after:
                inner(*args)
            raise exc if exc is not None else ValueError("simulated step crash")
        return inner(*args)

    eng._program.run = dying


def _pair(fx, kw: dict, chaos: dict | None = None, *, hard_fault: int | None = None, after: bool = False,
          snap_dirs=(None, None), engine_cls=Engine):
    """Serve tests/test_chaos.py's PRNGKey(7) prompts, 5 new tokens each,
    on the reference's engine (``chaos=`` keyword) and the port's
    (``EngineConfig.chaos``), each with ``kw`` over ``BASE``, and hold the
    port against the reference: decisions equal, only finite rows sampled,
    no leaks.  ``hard_fault`` plants a hard fault at that step in both.
    Returns both engines, the port's metrics and decisions, what
    ``_check_streams`` reads, and whether the state's tensors were
    rebound."""
    kw = dict(BASE, **kw)
    rsnap, psnap = (None if d is None else str(d) for d in snap_dirs)
    reng = RefEngine(fx["rcfg"], fx["rp"], RefEngineConfig(**kw, snapshot_dir=rsnap),
                     chaos=RefChaosConfig(**chaos) if chaos else None)
    peng = engine_cls(fx["cfg"], fx["tp"],
                      EngineConfig(**kw, snapshot_dir=psnap, chaos=ChaosConfig(**(chaos or {}))), device="cpu")
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    record = peng.on_sample

    def finite_only(rid, t, row):
        assert np.isfinite(row).all(), f"a non-finite row was sampled for request {rid}"
        record(rid, t, row)

    peng.on_sample = finite_only
    if hard_fault is not None:
        _plant_ref(reng, hard_fault)
        _plant(peng, hard_fault, after=after)
    ptrs = _state_ptrs(peng)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], fx["cfg"].vocab)
    out = []
    for eng in (reng, peng):
        reqs = [eng.submit(p, 5) for p in prompts]
        out.append(_decisions(eng, reqs, eng.run(realtime=False)))
    assert out[1] == out[0]
    peng.assert_no_leaks()
    return dict(reng=reng, peng=peng, preqs=reqs, m=peng.metrics(), decisions=out[1],
                streams=(reng, peng, rrec, prec), rebound=_state_ptrs(peng) != ptrs)


def _matches(r) -> None:
    assert not r["rebound"], "the state's tensors were rebound"
    _check_streams(*r["streams"])


# -- config, wiring, injector ---------------------------------------------------------


def test_chaos_config_validation_and_wiring(shared):
    """tests/test_chaos.py test_chaos_config_validation_and_wiring on the
    port's classes, the engine's wiring (``ecfg.chaos`` armed wraps the
    allocator the scheduler sees; disarmed wraps nothing), the reference's
    defaults, and a drained run's leak check."""
    with pytest.raises(ValueError, match="step_fault_rate"):
        ChaosConfig(step_fault_rate=1.5)
    assert not ChaosConfig().enabled
    assert ChaosConfig(nan_rate=0.1).enabled
    inner = PageAllocator(5)
    flaky = ChaosInjector(ChaosConfig(seed=0, alloc_fault_rate=1.0)).wrap_allocator(inner)
    assert isinstance(flaky, FlakyPageAllocator)
    assert flaky.alloc(2) is None
    assert flaky.n_free == inner.n_free == 4
    flaky.assert_no_leaks()

    cfg, tp = shared["cfg"], shared["tp"]
    eng = Engine(cfg, tp, EngineConfig(**BASE, chaos=ChaosConfig(alloc_fault_rate=0.5)), device="cpu")
    assert isinstance(eng.allocator, FlakyPageAllocator) and eng.scheduler.allocator is eng.allocator
    eng = build_engine(cfg, EngineConfig(**BASE, chaos=ChaosConfig(step_fault_rate=0.5)), params=tp,
                       device="cpu")
    assert eng._chaos is not None and eng._chaos.cfg.step_fault_rate == 0.5
    eng = Engine(cfg, tp, EngineConfig(**BASE), device="cpu")
    assert type(eng.allocator) is PageAllocator and eng._chaos is None
    for field in ("max_step_retries", "max_request_retries"):
        with pytest.raises(ValueError, match="retry budgets"):
            Engine(cfg, tp, EngineConfig(**BASE, **{field: -1}), device="cpu")
    ref, ours = RefEngineConfig(), EngineConfig()
    for f in ("watchdog_ticks", "quarantine_ticks", "max_step_retries", "max_request_retries",
              "snapshot_every", "snapshot_dir"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert _chaos_fields(ours.chaos) == _chaos_fields(ref.chaos)
    m = Engine(cfg, tp, EngineConfig(**BASE), device="cpu").metrics()
    assert m["injected"] == {"step": 0, "alloc": 0, "nan": 0}
    assert m["quarantines"] == m["step_retries"] == m["hard_recoveries"] == 0
    eng = Engine(cfg, tp, EngineConfig(**BASE), device="cpu")
    eng.allocator.alloc(1)  # a page that never comes back: the drained run asserts no leaks
    with pytest.raises(AssertionError):
        eng.run(realtime=False)


def _chaos_fields(obj) -> dict:
    return {f: getattr(obj, f) for f in ("seed", "step_fault_rate", "alloc_fault_rate", "nan_rate")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_injector_draws_in_the_reference_order(seed):
    """The same call sequence on the reference's injector and the port's
    (step attempts, allocations of n >= 0 pages, poisoning of a batch's
    sampling slots): the same faults, counters, victims and rows."""
    kw = dict(seed=seed, step_fault_rate=0.3, alloc_fault_rate=0.4, nan_rate=0.25)
    ref, ours = RefChaosInjector(RefChaosConfig(**kw)), ChaosInjector(ChaosConfig(**kw))
    calls = np.random.default_rng(100 + seed)
    for _ in range(200):
        kind = calls.integers(3)
        if kind == 0:
            got = []
            for inj, fault in ((ref, RefInjectedFault), (ours, InjectedFault)):
                try:
                    inj.before_step()
                    got.append(None)
                except fault as e:
                    got.append(str(e))
            assert got[0] == got[1]
        elif kind == 1:
            n = int(calls.integers(0, 3))
            pools = [PageAllocator(64), PageAllocator(64)]
            assert (ref.wrap_allocator(pools[0]).alloc(n) is None) == (ours.wrap_allocator(pools[1]).alloc(n) is None)
        else:
            slots = sorted(calls.choice(6, int(calls.integers(0, 5)), replace=False).tolist())
            rows = [np.zeros((6, 4), np.float32) for _ in range(2)]
            assert ref.poison_logits(rows[0], slots) == ours.poison_logits(rows[1], slots)
            np.testing.assert_array_equal(rows[0], rows[1])
    assert ours.counters() == ref.counters() and min(ours.counters().values()) > 0
    assert ours.trace is None


# -- tests/test_chaos.py's scenarios, on both engines ----------------------------------

# name -> (fixture, ChaosConfig keywords, engine keywords over BASE, checks on the port's metrics)
SCENARIOS = {
    "step-faults": ("shared", dict(seed=0, step_fault_rate=0.3), {},
                    lambda m: m["injected"]["step"] > 0 and m["step_retries"] > 0),
    "alloc-faults": ("shared", dict(seed=1, alloc_fault_rate=0.4), dict(n_slots=3, n_pages=9, admit="on-demand"),
                     lambda m: m["injected"]["alloc"] > 0),
    "nan": ("shared", dict(seed=2, nan_rate=0.5), dict(max_request_retries=64),
            lambda m: m["injected"]["nan"] > 0 and m["quarantines"] > 0),
    "combined-llama3.2-3b": ("shared", dict(seed=3, step_fault_rate=0.2, alloc_fault_rate=0.2, nan_rate=0.2),
                             dict(n_slots=3, n_pages=7, admit="on-demand", max_request_retries=64),
                             lambda m: min(m["injected"].values()) > 0 and m["statuses"] == {"ok": 3}),
    "combined-mamba2-130m": ("mamba", dict(seed=3, step_fault_rate=0.2, alloc_fault_rate=0.2, nan_rate=0.2),
                             dict(n_slots=3, n_pages=7, admit="on-demand", max_request_retries=64),
                             lambda m: min(m["injected"].values()) > 0 and m["statuses"] == {"ok": 3}),
    "persistent": ("shared", dict(seed=4, step_fault_rate=1.0),
                   dict(max_step_retries=1, max_request_retries=1, quarantine_ticks=2, watchdog_ticks=50),
                   lambda m: m["steps"] == 0 and m["statuses"] == {"failed": 3}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_chaos_scenario_matches_reference(request, name):
    fixture, chaos, kw, check = SCENARIOS[name]
    r = _pair(request.getfixturevalue(fixture), kw, chaos)
    assert check(r["m"]), r["m"]
    _matches(r)
    if name == "persistent":
        for req in r["peng"].finished:
            assert req.status == "failed" and req.out_tokens == [] and req.n_faults > 1
    else:
        assert all(req.status == "ok" for req in r["peng"].finished)


def test_chaos_determinism_same_seed_same_run(shared):
    """tests/test_chaos.py test_chaos_determinism_same_seed_same_trace:
    the port's engine twice with seed 5, against each other bit for bit
    and against the reference's."""
    chaos, kw = dict(seed=5, step_fault_rate=0.2, nan_rate=0.2), dict(max_request_retries=64)
    r = _pair(shared, kw, chaos)
    _matches(r)
    again = Engine(shared["cfg"], shared["tp"], EngineConfig(**BASE, **kw, chaos=ChaosConfig(**chaos)),
                   device="cpu")
    rows = _recording(again, ref=False)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], shared["cfg"].vocab)
    reqs = [again.submit(p, 5) for p in prompts]
    assert _decisions(again, reqs, again.run(realtime=False)) == r["decisions"]
    prec = r["streams"][3]
    assert rows.keys() == prec.keys() and all(rows[k].tobytes() == prec[k].tobytes() for k in rows)


# -- hard faults ----------------------------------------------------------------------


@pytest.mark.parametrize("snapshot_every,after", [(0, False), (2, False), (2, True)],
                         ids=["fresh", "snapshot", "snapshot-after-write"])
def test_hard_fault_matches_reference(shared, tmp_path, snapshot_every, after):
    """tests/test_chaos.py test_hard_fault_rebuilds_state_and_replays: a
    hard fault at step 3 strikes every resident request and restores the
    state (zeroed, or the latest snapshot), in place; the replays give the
    reference's decisions and rows.  ``after``: the port's step raises only
    once it has written the pools (a fault the reference cannot plant);
    the decisions are the reference's pre-step fault's all the same."""
    restores = []
    kw = dict(snapshot_every=snapshot_every)
    dirs = (tmp_path / "ref", tmp_path / "port") if snapshot_every else (None, None)

    class Spied(Engine):
        def _restore_state(self):
            if self._ckpt is not None:
                self._ckpt.wait()
            step = self._ckpt is not None and self._ckpt.latest_step()
            restores.append(step)
            super()._restore_state()
            want = self._ckpt.restore(self.state)[1] if step else {k: torch.zeros_like(t) for k, t in
                                                                   self.state.items()}
            assert all(torch.equal(t, want[k]) for k, t in self.state.items())

    r = _pair(shared, kw, hard_fault=3, after=after, snap_dirs=dirs, engine_cls=Spied)
    _matches(r)
    peng = r["peng"]
    assert r["m"]["hard_recoveries"] == 1 and r["m"]["statuses"] == {"ok": 3}
    assert len(peng.fault_log) == 1 and "ValueError" in peng.fault_log[0]
    assert restores == [2 if snapshot_every else False]  # restored from step 2's snapshot
    if snapshot_every:
        assert peng._ckpt.latest_step() is not None and not list(dirs[1].glob("*.tmp"))


class RebindingEngine(Engine):
    """A planted fault: the reference's restore, ``self.state = restored``.
    The step keeps the tensors it was built on, and the slot resets of the
    replays go to the new ones."""

    def _restore_state(self):
        if self._ckpt is not None:
            self._ckpt.wait()
            if self._ckpt.latest_step() is not None:
                _, self.state = self._ckpt.restore(self.state)
                return
        self.state = {k: torch.zeros_like(t) for k, t in self.state.items()}


def test_mamba_hard_fault_restores_in_place_and_a_rebinding_restore_fails(mamba, tmp_path):
    """mamba2-130m's recurrent state after a hard fault at step 3, from a
    snapshot of step 2: the port restores it in place and its replays,
    each re-admission zeroing its slot, match the reference; the planted
    rebinding restore leaves the step on the old state, whose slots keep
    the faulted run's state, and the rows check rejects it."""
    kw = dict(snapshot_every=2)
    r = _pair(mamba, kw, hard_fault=3, snap_dirs=(tmp_path / "ref", tmp_path / "port"))
    _matches(r)
    assert r["m"]["hard_recoveries"] == 1
    bad = _pair(mamba, kw, hard_fault=3, snap_dirs=(tmp_path / "ref2", tmp_path / "port2"),
                engine_cls=RebindingEngine)
    assert bad["rebound"] and bad["m"]["hard_recoveries"] == 1
    with pytest.raises(AssertionError):
        _check_streams(*bad["streams"])


@pytest.mark.parametrize("chaos", [None, dict(seed=0, step_fault_rate=0.3)], ids=["plain", "chaos"])
def test_a_kernel_error_propagates_unrecovered(shared, chaos):
    """A kernel's own error (build.KernelError, which every kernel
    wrapper raises on a CUDA error) out of the step leaves run() at once:
    no strike, no restore, no retry."""
    eng = Engine(shared["cfg"], shared["tp"], EngineConfig(**BASE, chaos=ChaosConfig(**(chaos or {}))),
                 device="cpu")
    _plant(eng, 2, exc=build.KernelError("paged_gather: CUDA error 700: an illegal memory access"))
    reqs = [eng.submit(p, 5) for p in _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], shared["cfg"].vocab)]
    with pytest.raises(build.KernelError, match="CUDA error 700"):
        eng.run(realtime=False)
    assert eng.hard_recoveries == 0 and eng.fault_log == [] and eng.n_steps == 2
    assert all(r.n_faults == 0 and r.status is None for r in reqs)


@pytest.mark.parametrize("fault", ["load", "entry-point"])
def test_a_library_load_failure_propagates_unrecovered(shared, monkeypatch, tmp_path, fault):
    """A kernel library that does not load (not a shared object) or lacks
    an entry point (a shared object of another library), met at the
    first kernel call inside a step of an eager engine, raises
    build.KernelError out of run(): no strike, no restore."""
    if fault == "load":
        bad = tmp_path / "paged_gather.so"
        bad.write_bytes(b"not a shared object")
    else:
        bad = Path(torch.__file__).parent / "lib" / "libc10.so"
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "library_path", lambda name: bad)
    eng = Engine(shared["cfg"], shared["tp"], EngineConfig(**BASE), device="cpu", capture=False)
    run = eng._program.run

    def first_kernel_call(*args):
        if eng.n_steps == 2:
            build.library("paged_gather")
        return run(*args)

    eng._program.run = first_kernel_call
    reqs = [eng.submit(p, 5) for p in _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], shared["cfg"].vocab)]
    with pytest.raises(build.KernelError, match="paged_gather") as info:
        eng.run(realtime=False)
    assert isinstance(info.value.__cause__, OSError if fault == "load" else AttributeError)
    assert eng.hard_recoveries == 0 and eng.fault_log == [] and eng.n_steps == 2
    assert all(r.n_faults == 0 and r.status is None for r in reqs)


# -- snapshots ------------------------------------------------------------------------


def _trees(kind: str):
    """A state of each layout the engine snapshots, as torch tensors."""
    g = torch.Generator().manual_seed(len(kind))
    if kind == "bf16-pools":
        return {"k": torch.randn(2, 5, 4, 8, generator=g).to(torch.bfloat16),
                "v": torch.randn(2, 5, 4, 8, generator=g).to(torch.bfloat16)}
    if kind == "int8-pools":
        return {"k": torch.randint(-127, 128, (2, 5, 4, 8), generator=g, dtype=torch.int8),
                "v": torch.randint(-127, 128, (2, 5, 4, 8), generator=g, dtype=torch.int8),
                "k_scale": torch.rand(2, 5, 4, 1, generator=g), "v_scale": torch.rand(2, 5, 4, 1, generator=g)}
    return {"ssm": torch.randn(2, 3, 4, 16, 8, generator=g),  # float32 [L, S, H, N, P]
            "conv": torch.randn(2, 3, 3, 40, generator=g).to(torch.bfloat16)}


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("kind", ["bf16-pools", "int8-pools", "ssm-state"])
def test_snapshot_round_trip_is_bit_exact(tmp_path, kind):
    tree = _trees(kind)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(1, tree)
    leaves = {k: t.clone() for k, t in tree.items()}
    mgr.save_async(2, leaves)
    for t in leaves.values():
        t.add_(1)  # the device may overwrite the leaves once save_async returns
    mgr.wait()
    for step in (1, 2):
        got_step, got = mgr.restore({k: torch.empty(0) for k in tree}, step=step)
        assert got_step == step and got.keys() == tree.keys()
        for k, t in tree.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert _bits(got[k]) == _bits(t), k
    manifest = (tmp_path / "step_00000001" / "manifest.json").read_text()
    if kind != "int8-pools":
        assert '"dtype": "bfloat16"' in manifest
        arr = np.load(tmp_path / "step_00000001" / f"{next(k for k, t in tree.items() if t.dtype == torch.bfloat16)}.npy")
        assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def test_snapshot_atomic_commit_and_keep(tmp_path):
    """A half-written ``.tmp`` step is never restored; ``keep`` steps stay;
    a restore with no checkpoint raises."""
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _trees("ssm-state")
    with pytest.raises(FileNotFoundError):
        mgr.restore(tree)
    for step in (3, 5, 7):
        mgr.save(step, {k: t + step for k, t in tree.items()})
    stray = tmp_path / "step_00000009.tmp"
    stray.mkdir()
    (stray / "manifest.json").write_text("{}")
    assert mgr.all_steps() == [5, 7] and mgr.latest_step() == 7
    step, got = mgr.restore(tree)
    assert step == 7 and _bits(got["ssm"]) == _bits(tree["ssm"] + 7)
    assert got["conv"].device == tree["conv"].device
    assert mgr.restore(tree, device="cpu")[1]["ssm"].device.type == "cpu"


@pytest.mark.parametrize("kind", ["bf16-pools", "int8-pools", "ssm-state"])
def test_snapshots_cross_between_the_packages(tmp_path, kind):
    """The same state saved by both packages gives the same files, byte
    for byte; each package restores the other's checkpoint bit-exactly
    (bfloat16 through ml_dtypes in the reference, an int16 view in the
    port)."""
    tree = _trees(kind)

    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())

    jtree = {k: to_jax(t) for k, t in tree.items()}
    RefCheckpointManager(tmp_path / "ref").save(4, jtree)
    CheckpointManager(tmp_path / "port").save(4, tree)
    a, b = tmp_path / "ref" / "step_00000004", tmp_path / "port" / "step_00000004"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert filecmp.cmpfiles(a, b, names, shallow=False)[0] == names
    _, ours = CheckpointManager(tmp_path / "ref").restore(tree)
    _, theirs = RefCheckpointManager(tmp_path / "port").restore(jtree)
    for k, t in tree.items():
        assert _bits(ours[k]) == _bits(t), k
        assert np.asarray(theirs[k]).tobytes() == np.asarray(jtree[k]).tobytes(), k
