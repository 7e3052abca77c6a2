"""The request lifecycle in the port's engine (deadlines and SLO classes,
cancellation, bounded-queue shedding, the stall watchdog, static gang
admission) against the reference engine, on the CPU, at the llama3.2-3b
smoke size, on the virtual clock (``run(realtime=False)``).

Both engines run the same schedule on identical weights (the fixture of
``tests/test_torch_model.py``).  Every lifecycle decision is a function of
the schedule alone (token counts and ticks, never token values), so per
request the status, shed reason, admission, first-token and finish times,
token count and preemptions, and per run the steps, ticks, tokens fed and
every metric except the host step time, must be equal.  Sampled logits
rows agree to ``ATOL`` up to a request's first token divergence, which
must sit on a reference top-2 gap under ``TIE_BOUND``.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from test_serving import _prompts
from test_torch_chunked import _check_streams, _engines
from test_torch_model import _recording, shared  # noqa: F401 (shared: fixture)

from repro.serving import SLO as RefSLO
from repro_torch.serving import SLO
from repro_torch.serving.engine import WATCHDOG_TICKS

# every run metric the port shares with the reference (the port adds
# step_s_p50, a host time; the reference adds its fault and mesh counters)
METRIC_KEYS = ("engine", "admit", "chunk_tokens", "n_requests", "n_ok", "statuses",
               "generated_tokens", "generated_tokens_ok", "prompt_tokens", "fed_tokens",
               "preemptions", "steps", "wall", "tokens_per_s", "latency_p50", "latency_p99",
               "ttft_p50", "ttft_p99", "slot_occupancy")
REQ_FIELDS = ("status", "shed_reason", "slo", "deadline", "ttft_deadline", "t_admit",
              "t_first_token", "t_finish", "n_preempted")
SHED_REASONS = {"deadline", "ttft", "infeasible", "queue-overflow", "watchdog"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run the port's CPU engine on one intra-op thread: at the smoke size
    its einsums and softmaxes cost far more in thread hand-offs than in
    arithmetic (a 34-step run takes seconds on 8 threads, under 0.1 s on
    one).  The previous count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(shared, kw: dict, reqs: list[dict], *, packed=False, alloc_fails=False,
              max_steps=None, pages: dict | None = None):
    """Serve ``reqs`` on the reference engine and the port's, and hold the
    port's lifecycle against the reference's.

    Each request is a dict of ``submit``'s arguments (``prompt``,
    ``max_new``, ``arrival``, ``deadline``, ``ttft_deadline``, ``slo``: a
    ``(name, ttft, total)`` triple) and optionally ``cancel``:
    ``"submit"`` (cancelled while pending), ``("step", n)`` (before the
    engine's step n, wherever the request then is) or ``("tokens", k)``
    (before the first step at which it holds k tokens).  ``max_steps``
    runs the engines in slices of that many steps, resuming each time.
    ``pages`` collects, per rid, every page the request held at a step of
    the port's engine.  Returns the port's engine, its requests and metrics."""
    reng, peng = _engines(shared, kw, packed=packed, packed_head=False)
    recs = _recording(reng, ref=True), _recording(peng, ref=False)
    out = []
    for eng, slo_cls in ((reng, RefSLO), (peng, SLO)):
        handles = []
        for spec in reqs:
            slo = spec.get("slo")
            handles.append(eng.submit(spec["prompt"], spec["max_new"], spec.get("arrival", 0.0),
                                      deadline=spec.get("deadline"),
                                      ttft_deadline=spec.get("ttft_deadline"),
                                      slo=slo_cls(*slo) if slo else None))
        for spec, req in zip(reqs, handles):
            if spec.get("cancel") == "submit":
                assert eng.cancel(req) is True
        cancels = [(spec["cancel"], req) for spec, req in zip(reqs, handles)
                   if isinstance(spec.get("cancel"), tuple)]
        inner = eng._step_once

        def step_once(now_fn, eng=eng, inner=inner, cancels=cancels):
            for (kind, n), req in cancels:
                if req.status is None and not req.cancel_requested and (
                        eng.n_steps == n if kind == "step" else len(req.out_tokens) == n):
                    eng.cancel(req)
            out = inner(now_fn)
            if pages is not None and eng is peng:
                for req in eng.scheduler.active.values():
                    pages.setdefault(req.rid, set()).update(req.pages)
            return out

        eng._step_once = step_once
        if alloc_fails:
            eng.allocator.alloc = lambda n: None  # the pool permanently "exhausted"
        if max_steps is None:
            m = eng.run(realtime=False)
        else:
            while True:
                m = eng.run(realtime=False, max_steps=eng.n_steps + max_steps)
                if not eng._pending and eng.scheduler.all_done():
                    break
        out.append((eng, handles, m))
    (_, rreqs, rm), (_, preqs, m) = out
    for key in METRIC_KEYS:
        assert m[key] == rm[key], (key, m[key], rm[key])
    assert peng.ticks == reng.ticks
    assert [r.rid for r in peng.finished] == [r.rid for r in reng.finished]
    for ours, theirs in zip(preqs, rreqs):
        for f in REQ_FIELDS:
            assert getattr(ours, f) == getattr(theirs, f), (ours.rid, f)
        assert len(ours.out_tokens) == len(theirs.out_tokens), ours.rid
        assert ours.status in ("ok", "cancelled", "shed")
        assert ours.shed_reason is None or ours.shed_reason in SHED_REASONS
    _check_streams(reng, peng, *recs)
    peng.assert_no_leaks()
    json.dumps(m, allow_nan=False)  # no NaN or Infinity
    return peng, preqs, m


def _one_slot(**kw):
    return dict(n_slots=1, page_size=4, max_len=32, **kw)


def test_slo_resolves_absolute_deadlines(shared):
    """The reference's test_slo_resolves_absolute_deadlines: an SLO's
    relative budgets resolve against the arrival; explicit deadlines win."""
    _, reqs, _ = _run_both(shared, _one_slot(), [
        dict(prompt=[1, 2, 3], max_new=2, arrival=2.0, slo=("interactive", 3.0, 9.0)),
        dict(prompt=[1, 2], max_new=2, arrival=2.0, slo=("interactive", 3.0, 9.0), deadline=4.0),
    ])
    assert (reqs[0].ttft_deadline, reqs[0].deadline, reqs[0].slo) == (5.0, 11.0, "interactive")
    assert (reqs[1].ttft_deadline, reqs[1].deadline) == (5.0, 4.0)


def test_deadline_expiry_sheds_waiting_request(shared):
    p = _prompts(jax.random.PRNGKey(2), 2, [3, 3], shared["cfg"].vocab)
    _, (r1, r2), m = _run_both(shared, _one_slot(), [
        dict(prompt=p[0], max_new=12), dict(prompt=p[1], max_new=2, deadline=5.0)])
    assert r1.status == "ok" and len(r1.out_tokens) == 12
    assert r2.status == "shed" and r2.shed_reason in ("deadline", "infeasible")
    assert r2.out_tokens == [] and r2.t_finish is not None
    assert m["statuses"] == {"ok": 1, "shed": 1} and m["n_ok"] == 1


def test_ttft_deadline_sheds_before_first_token(shared):
    p = _prompts(jax.random.PRNGKey(3), 2, [3, 3], shared["cfg"].vocab)
    _, (r1, r2), _ = _run_both(shared, _one_slot(), [
        dict(prompt=p[0], max_new=10), dict(prompt=p[1], max_new=8, ttft_deadline=4.0)])
    assert r1.status == "ok"
    assert r2.status == "shed" and r2.shed_reason in ("ttft", "infeasible")
    assert r2.t_first_token is None


def test_cancel_waiting_and_mid_decode(shared):
    p = _prompts(jax.random.PRNGKey(5), 2, [3, 3], shared["cfg"].vocab)
    eng, (r1, r2), m = _run_both(shared, _one_slot(), [
        dict(prompt=p[0], max_new=10, cancel=("tokens", 3)),
        dict(prompt=p[1], max_new=4, cancel="submit")])
    assert r2.status == "cancelled" and r2.out_tokens == []
    assert r1.status == "cancelled" and 0 < len(r1.out_tokens) < 10
    assert m["statuses"] == {"cancelled": 2}
    assert eng.cancel(r1) is False  # already terminal


def test_bounded_queue_sheds_least_slack(shared):
    p = _prompts(jax.random.PRNGKey(6), 3, [3, 3, 3], shared["cfg"].vocab)
    _, (r1, r2, r3), m = _run_both(shared, _one_slot(max_waiting=1), [
        dict(prompt=p[0], max_new=6), dict(prompt=p[1], max_new=2),
        dict(prompt=p[2], max_new=2, deadline=100.0)])
    assert r1.status == "ok" and r2.status == "ok"
    assert r3.status == "shed" and r3.shed_reason == "queue-overflow"
    assert m["statuses"] == {"ok": 2, "shed": 1}


def test_watchdog_sheds_instead_of_raising(shared):
    """A permanently failing allocator: the watchdog sheds the unplaceable
    head after WATCHDOG_TICKS idle ticks (the reference's default
    watchdog_ticks) and run() returns."""
    kw = dict(n_slots=1, page_size=4, max_len=16)
    eng, (req,), m = _run_both(shared, kw, [dict(prompt=[1, 2, 3], max_new=2)], alloc_fails=True)
    assert req.status == "shed" and req.shed_reason == "watchdog"
    assert m["statuses"] == {"shed": 1} and m["steps"] == 0
    assert eng.ticks == WATCHDOG_TICKS + 1


def test_metrics_percentiles_none_not_nan(shared):
    kw = dict(n_slots=1, page_size=4, max_len=16)
    _, (req,), m = _run_both(shared, kw, [dict(prompt=[1, 2], max_new=2, deadline=0.0)])
    assert req.status == "shed" and req.t_first_token is None
    assert m["latency_p50"] is None and m["latency_p99"] is None
    assert m["ttft_p50"] is None and m["ttft_p99"] is None
    assert "NaN" not in json.dumps(m, allow_nan=False)


def test_continuous_needs_fewer_steps_than_static(shared):
    """The reference's fixture: one straggler in each gang of 2."""
    p = _prompts(jax.random.PRNGKey(5), 6, [2] * 6, shared["cfg"].vocab)
    gens = [24, 3, 3, 20, 4, 4]
    steps = {}
    for policy in ("continuous", "static"):
        kw = dict(n_slots=2, page_size=4, max_len=32, policy=policy)
        _, _, m = _run_both(shared, kw, [dict(prompt=q, max_new=g) for q, g in zip(p, gens)])
        assert m["n_requests"] == 6 and m["engine"] == policy
        steps[policy] = m["steps"]
    assert steps["continuous"] < steps["static"]


def test_on_demand_cancel_mid_prefill_and_shed_active(shared):
    """Chunked on demand (C = 4) in a pool of 6 usable pages: request 0 is
    cancelled mid-prefill (its 13-token prompt takes 4 chunks), request 1
    is shed on its deadline while decoding, and the pages both free go to
    the requests admitted after them.  Run in slices of 3 steps."""
    p = _prompts(jax.random.PRNGKey(9), 5, [13, 6, 9, 5, 7], shared["cfg"].vocab)
    kw = dict(n_slots=2, page_size=4, max_len=32, n_pages=7, chunk_tokens=4, admit="on-demand")
    reqs = [dict(prompt=p[0], max_new=6, cancel=("step", 2)),
            dict(prompt=p[1], max_new=12, deadline=8.0),
            dict(prompt=p[2], max_new=6, arrival=1.0),
            dict(prompt=p[3], max_new=6, arrival=2.0),
            dict(prompt=p[4], max_new=4, arrival=3.0)]
    pages = {}
    _, rs, m = _run_both(shared, kw, reqs, max_steps=3, pages=pages)
    r0, r1 = rs[:2]
    assert r0.status == "cancelled" and r0.out_tokens == [] and 0 < r0.n_fed < len(r0.prompt)
    assert r1.status == "shed" and r1.shed_reason == "deadline" and r1.out_tokens
    assert [r.status for r in rs[2:]] == ["ok"] * 3
    for gone in (r0, r1):  # a later admission took some of its pages
        assert any(pages[gone.rid] & pages[r.rid] for r in rs[2:] if r.t_admit >= gone.t_finish), gone.rid


def _random_schedule(seed: int, vocab: int) -> tuple[dict, list[dict]]:
    """A seeded schedule: 8 requests of 2-12 prompt and 2-10 new tokens
    arriving over 12 steps, interactive, batch or no SLO, some explicit
    deadlines, a cancel or two, a bounded or unbounded queue; 3 slots,
    reserve or chunked on demand.  Seed 4 serves the w4a4 packed weights
    through the kernel gather (the plain versions of K1 and K3)."""
    g = np.random.default_rng(seed)
    kw = dict(n_slots=3, page_size=4, max_len=24, max_waiting=int(g.integers(0, 4)))
    if seed % 2:
        kw.update(chunk_tokens=4, admit="on-demand", n_pages=9)
    if seed == 4:
        kw.update(gather_backend="kernel")
    slos = [None, ("interactive", 4.0, 16.0), ("batch", None, 40.0)]
    reqs = []
    for _ in range(8):
        spec = dict(prompt=g.integers(1, vocab, int(g.integers(2, 13))).tolist(),
                    max_new=int(g.integers(2, 11)), arrival=float(g.integers(0, 13)),
                    slo=slos[int(g.integers(0, 3))])
        if g.random() < 0.25:
            spec["deadline"] = spec["arrival"] + float(g.integers(4, 20))
        u = g.random()
        if u < 0.15:
            spec["cancel"] = ("step", int(g.integers(0, 20)))
        elif u < 0.25:
            spec["cancel"] = ("tokens", int(g.integers(1, spec["max_new"])))
        reqs.append(spec)
    return kw, reqs


@pytest.mark.parametrize("seed", range(5))
def test_random_schedule_matches_reference(shared, seed):
    kw, reqs = _random_schedule(seed, shared["cfg"].vocab)
    _, _, m = _run_both(shared, kw, reqs, packed=seed == 4)
    assert m["n_requests"] == len(reqs)


def test_realtime_deadlines_use_the_step_time_ewma(shared):
    """On the wall clock the service estimate is None until the first step
    (so no request is shed as infeasible before it), then the steps left
    times the EWMA (0.8 / 0.2) of every step's wall time."""
    from repro_torch.serving import EngineConfig, Request, build_engine

    eng = build_engine(shared["cfg"], EngineConfig(n_slots=2, page_size=4, max_len=32),
                       params=shared["tp"], device="cpu")
    req = eng.submit([1, 2, 3], max_new_tokens=4, deadline=0.0)
    assert eng._est_service_time(req) is None and eng._slack(req, -1.0) == 1.0
    loose = eng.submit([4, 5, 6, 7], max_new_tokens=6, deadline=3600.0)
    m = eng.run(realtime=True)
    assert req.status == "shed" and req.shed_reason == "deadline"
    assert loose.status == "ok" and m["steps"] == len(eng.step_seconds) == 4 + 6 - 1
    ewma = None
    for dt in eng.step_seconds:
        ewma = dt if ewma is None else 0.8 * ewma + 0.2 * dt
    assert eng._step_time_ewma == ewma
    probe = Request(99, [1, 2, 3], 4)  # 3 prompt steps (the last samples), then 3 decode steps
    assert eng._est_service_time(probe) == 6 * ewma
